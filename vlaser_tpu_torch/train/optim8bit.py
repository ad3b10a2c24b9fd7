"""Block-wise 8-bit AdamW (port of vlaser_tpu/train/optim8bit.py, the
bitsandbytes AdamW8bit of the VLA recipe).

The Adam moments of a leaf of at least MIN_8BIT_SIZE elements are kept as
uint8 float codes in blocks of BLOCK elements of the leaf's flattened
order, each block with an fp32 absmax scale: m as sign + 7-bit magnitude
(`SMAP`), v as an 8-bit magnitude (`UMAP`); 2 bytes + 8 / 256 a parameter
instead of fp32 Adam's 8. Smaller leaves keep fp32 m and v. A step decodes
the moments, runs Adam on them in fp32, re-encodes them against the new
block maxima, and takes the update from the unquantized new moments:
upd = (m / bc1) / (sqrt(v / bc2) + eps), p <- p + (-lr) * (upd + wd * p),
with bc1 = 1 - b1^count and bc2 = 1 - b2^count in fp32, computed once a
step.

`adam8bit_update_plain` is the step's eager twin (a leaf walked in slabs of
SLAB_BLOCKS blocks, as the JAX scan walks it, so its temporaries stay near
200 MB); on a CUDA tensor `AdamW8bit` launches the kernel of
csrc/adam8bit.cu through kernels/adam8bit.py, which agrees with the twin
bit for bit. The decode tables and their midpoints are built here once, in
numpy, exactly as the JAX module builds them, and the kernel reads the
same arrays.

Layout: each state tensor has the JAX `Adam8bitLeaf`'s shape (`m_q` /
`v_q` uint8 [nb, 256] with the tail block zero-padded, `m_scale` /
`v_scale` fp32 [nb, 1]), so utils/checkpoint.py saves it as it saves
AdamW's state and utils/convert.adam8bit_state_from_jax carries a JAX
state across. A leaf whose port layout differs from its JAX one (the
patch-embedding convs: OIHW here, HWIO in JAX) is named in `hwio`: its
gradient and parameter are blocked in HWIO order, so its blocks are the
JAX leaf's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable

import numpy as np
import torch

from ..kernels import adam8bit as _kernel

BLOCK = 256
SLAB_BLOCKS = 32_768  # 8.4 M elements a slab (~200 MB of fp32 temporaries)
MIN_8BIT_SIZE = 4096  # smaller leaves keep fp32 moments (bnb's min size)
SCALE_FLOOR = 1e-32
OIHW_TO_HWIO, HWIO_TO_OIHW = (2, 3, 1, 0), (3, 2, 0, 1)


def _float_code_map(exp_bits: int, frac_bits: int) -> np.ndarray:
    """Monotonic non-negative decode table (code 0 = exact zero): a
    float-like 2^e * (1 + f) grid normalized to max 1; the 257th value is
    dropped before normalizing, as the JAX table drops it."""
    n_exp, n_frac = 2 ** exp_bits, 2 ** frac_bits
    vals = [0.0]
    for e in range(n_exp):
        for f in range(n_frac):
            vals.append(2.0 ** (e - n_exp + 1) * (1 + f / n_frac))
    vals = np.asarray(vals[:256], np.float64)
    return (vals / vals.max()).astype(np.float32)


def _midpoints(table: np.ndarray) -> np.ndarray:
    return ((table[1:] + table[:-1]) / np.float32(2.0)).astype(np.float32)


UMAP = _float_code_map(5, 3)        # v: 5 exponent x 3 fraction bits
SMAP = _float_code_map(3, 4)[:128]  # |m|: 3 x 4, its first 128
SMID, UMID = _midpoints(SMAP), _midpoints(UMAP)
_tables: Dict[torch.device, Dict[str, torch.Tensor]] = {}


def code_tables(device) -> Dict[str, torch.Tensor]:
    """The tables on `device` (cached): "smap" [128], "umap" [256], "smid"
    [127], "umid" [255], and "all", the four concatenated in that order
    (the kernel's shared-memory image)."""
    device = torch.device(device)
    if device not in _tables:
        cat = np.concatenate([SMAP, UMAP, SMID, UMID])
        allt = torch.from_numpy(cat).to(device)
        cut = np.cumsum([0, len(SMAP), len(UMAP), len(SMID), len(UMID)])
        _tables[device] = {"all": allt, **{
            k: allt[cut[i]:cut[i + 1]]
            for i, k in enumerate(("smap", "umap", "smid", "umid"))}}
    return _tables[device]


def num_blocks(n: int) -> int:
    return -(-n // BLOCK)


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """[n] -> [nb, BLOCK], zero-padded."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, BLOCK)


def _encode(r: torch.Tensor, mids: torch.Tensor) -> torch.Tensor:
    """r in [0, 1] -> the nearest code: the number of midpoints below r (a
    value on a midpoint takes the lower code)."""
    return torch.searchsorted(mids, r.contiguous())


def quant_unsigned(x: torch.Tensor):
    """Non-negative fp32 -> (uint8 codes [nb, 256], fp32 scales [nb, 1])."""
    t = code_tables(x.device)
    xp = _blocks(x.float())
    scale = xp.amax(1, keepdim=True).clamp_min(SCALE_FLOOR)
    return _encode(xp / scale, t["umid"]).to(torch.uint8), scale


def quant_signed(x: torch.Tensor):
    """fp32 -> (uint8 sign + magnitude codes [nb, 256], scales [nb, 1])."""
    t = code_tables(x.device)
    xp = _blocks(x.float())
    scale = xp.abs().amax(1, keepdim=True).clamp_min(SCALE_FLOOR)
    mag = _encode(xp.abs() / scale, t["smid"])
    return (mag + 128 * (xp < 0)).to(torch.uint8), scale


def _decode_signed(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    qi = q.long()
    sign = torch.where(qi >= 128, -1.0, 1.0)
    return sign * code_tables(q.device)["smap"][qi % 128] * scale


def _decode_unsigned(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return code_tables(q.device)["umap"][q.long()] * scale


def dequant_signed(q, scale, shape) -> torch.Tensor:
    n = int(np.prod(shape))
    return _decode_signed(q, scale).reshape(-1)[:n].reshape(shape)


def dequant_unsigned(q, scale, shape) -> torch.Tensor:
    n = int(np.prod(shape))
    return _decode_unsigned(q, scale).reshape(-1)[:n].reshape(shape)


@dataclass(frozen=True)
class Hyper:
    """One step's constants, each an fp32 value (as JAX rounds its weak
    Python scalars): c1 = 1 - b1 and c2 = 1 - b2 rounded from float64,
    bc1 / bc2 the bias corrections, neglr = -lr."""
    b1: float
    c1: float
    b2: float
    c2: float
    eps: float
    bc1: float
    bc2: float
    wd: float
    neglr: float


def hyper(b1: float, b2: float, eps: float, wd: float, lr: float,
          count: int) -> Hyper:
    """The constants of update `count` (from 1): bc = 1 - b^count in fp32."""
    f = np.float32
    bc1 = f(1) - f(b1) ** f(count)
    bc2 = f(1) - f(b2) ** f(count)
    return Hyper(*(float(f(v)) for v in (b1, 1 - b1, b2, 1 - b2, eps, bc1,
                                         bc2, wd, -f(lr))))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded fp32 sqrt (the kernel's __fsqrt_rn) on every
    device: torch's vectorized CPU sqrt is off by one ulp in ~0.6% of
    values; the float64 root rounds back to the fp32 one exactly."""
    return torch.sqrt(x.double()).float()


def adam8bit_update_plain(g, p, m_q, m_scale, v_q, v_scale, h: Hyper):
    """The eager twin of the kernel: g, p [n] fp32 (the leaf in its block
    order); the state as AdamW8bit keeps it. Updates p and the state in
    place, one slab of SLAB_BLOCKS blocks at a time."""
    n, nb = p.numel(), m_q.shape[0]
    scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=p.device)
    bc1, bc2 = scalar(h.bc1), scalar(h.bc2)  # tensors: true division
    for s in range(0, nb, SLAB_BLOCKS):
        e = min(s + SLAB_BLOCKS, nb)
        lo, hi = s * BLOCK, min(e * BLOCK, n)
        gs = _blocks(g[lo:hi].float())
        m = h.b1 * _decode_signed(m_q[s:e], m_scale[s:e]) + h.c1 * gs
        v = (h.b2 * _decode_unsigned(v_q[s:e], v_scale[s:e])
             + (h.c2 * gs) * gs)
        m_q[s:e], m_scale[s:e] = quant_signed(m)
        v_q[s:e], v_scale[s:e] = quant_unsigned(v)
        upd = ((m / bc1) / (_sqrt(v / bc2) + h.eps)).reshape(-1)
        ps = p[lo:hi]
        u = upd[:hi - lo] + h.wd * ps
        ps.copy_(ps + h.neglr * u)


def adam_fp32_update(g, p, m, v, h: Hyper):
    """A leaf under MIN_8BIT_SIZE: the same formula over fp32 m and v (not
    a kernel's twin: plain tensor code on every device)."""
    scalar = lambda x: torch.tensor(x, dtype=torch.float32, device=p.device)
    g = g.float()
    m.copy_(h.b1 * m + h.c1 * g)
    v.copy_(h.b2 * v + (h.c2 * g) * g)
    upd = (m / scalar(h.bc1)) / (_sqrt(v / scalar(h.bc2)) + h.eps)
    p.copy_(p + h.neglr * (upd + h.wd * p))


def init_state(p: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A fresh leaf's state: zero moments (codes 0, scales 1e-32, as the
    JAX init quantizes zeros), and its update count."""
    st = {"step": torch.tensor(0.0)}
    if p.numel() < MIN_8BIT_SIZE:
        st["m"] = torch.zeros_like(p, dtype=torch.float32)
        st["v"] = torch.zeros_like(p, dtype=torch.float32)
        return st
    nb = num_blocks(p.numel())
    for k in ("m", "v"):
        st[f"{k}_q"] = torch.zeros((nb, BLOCK), dtype=torch.uint8,
                                   device=p.device)
        st[f"{k}_scale"] = torch.full((nb, 1), SCALE_FLOOR,
                                      dtype=torch.float32, device=p.device)
    return st


CODE_KEYS = ("m_q", "v_q")


class AdamW8bit(torch.optim.Optimizer):
    """bnb.optim.AdamW8bit as the JAX package computes it (optax chain
    scale_by_adam8bit -> add_decayed_weights -> scale_by_learning_rate).
    fp32 parameters; `hwio`: 4-D OIHW parameters blocked in HWIO order
    (the patch convs). A CUDA parameter of at least MIN_8BIT_SIZE elements
    takes the kernel (one launch), a CPU one the twin; no other route."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 hwio: Iterable[torch.Tensor] = ()):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        self.hwio = {id(p) for p in hwio}

    def _leaf(self, p, grad):
        """(g, p) flattened in the leaf's block order (copies for HWIO)."""
        if id(p) in self.hwio:
            return (grad.permute(*OIHW_TO_HWIO).reshape(-1),
                    p.detach().permute(*OIHW_TO_HWIO).reshape(-1))
        return grad.reshape(-1), p.detach().view(-1)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW8bit.step takes no closure")
        consts: Dict[tuple, Hyper] = {}
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                if p.dtype != torch.float32:
                    raise TypeError("AdamW8bit keeps fp32 parameters")
                st = self.state[p]
                if not st:
                    st.update(init_state(p))
                st["step"] += 1
                key = (id(group), int(st["step"].item()))
                if key not in consts:  # once a step and group
                    consts[key] = hyper(b1, b2, group["eps"],
                                        group["weight_decay"], group["lr"],
                                        key[1])
                h = consts[key]
                if "m" in st:
                    adam_fp32_update(p.grad, p, st["m"], st["v"], h)
                    continue
                g, flat = self._leaf(p, p.grad)
                _kernel.adamw8bit(g, flat, st["m_q"], st["m_scale"],
                                  st["v_q"], st["v_scale"], h)
                if id(p) in self.hwio:
                    p.copy_(flat.view(p.shape[2], p.shape[3], p.shape[1],
                                      p.shape[0]).permute(*HWIO_TO_OIHW))

    def load_state_dict(self, state_dict):
        """torch casts every loaded state tensor of a float parameter to
        the parameter's dtype: the uint8 codes are taken out first and
        placed on the parameter's device as they are."""
        params = [p for g in self.param_groups for p in g["params"]]
        state = {k: dict(v) for k, v in state_dict["state"].items()}
        codes = {i: {k: st.pop(k) for k in CODE_KEYS if k in st}
                 for i, st in state.items()}
        super().load_state_dict({**state_dict, "state": state})
        for i, c in codes.items():
            p = params[int(i)]
            for k, v in c.items():
                if v.dtype != torch.uint8:
                    raise TypeError(f"{k}: uint8 codes, got {v.dtype}")
                self.state[p][k] = v.to(p.device)
