"""The block-wise 8-bit AdamW step: the wrapper of `csrc/adam8bit.cu`, the
Hopper kernel that replaces the XLA scan of
vlaser_tpu/train/optim8bit.py (scale_by_adam8bit.update_leaf, :142, with
adamw8bit's decay and learning rate).

`adamw8bit` updates one leaf in place: g and p its fp32 gradient and
parameter flattened in block order, m_q / v_q uint8 [nb, 256], m_scale /
v_scale fp32 [nb, 1]. On CUDA tensors it launches the kernel (one launch a
leaf, counted in `launch_count`); on CPU tensors it runs the eager twin
(train/optim8bit.adam8bit_update_plain); any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launch_count = 0  # adamw8bit launches through the CUDA route

_P, _F = ctypes.c_void_p, ctypes.c_float
_SIGNATURE = (7, (ctypes.c_longlong,) + (_F,) * 9 + (_P,))
_fns = {}


def _kernel():
    if "adam8bit_step" not in _fns:
        _fns["adam8bit_step"] = _build.bind("adam8bit_step", *_SIGNATURE)
    return _fns["adam8bit_step"]


def _route(x, what, *others):
    return _build.route(x, what, *others)


def _check(g, p, m_q, m_scale, v_q, v_scale):
    n = p.numel()
    nb = -(-n // 256)
    if g.dtype != torch.float32 or p.dtype != torch.float32:
        raise TypeError("adamw8bit: g and p must be fp32")
    if g.numel() != n or m_q.shape != (nb, 256) or v_q.shape != (nb, 256):
        raise ValueError(f"adamw8bit: g [{n}], codes [{nb}, 256]")
    if m_q.dtype != torch.uint8 or v_q.dtype != torch.uint8:
        raise TypeError("adamw8bit: the codes must be uint8")
    if (m_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
            or m_scale.numel() != nb or v_scale.numel() != nb):
        raise ValueError(f"adamw8bit: fp32 scales [{nb}, 1]")
    for t in (g, p, m_q, m_scale, v_q, v_scale):
        if t.device != p.device or not t.is_contiguous():
            raise ValueError(f"adamw8bit: contiguous tensors on {p.device}")
    if m_q.data_ptr() % 8 or v_q.data_ptr() % 8:
        raise ValueError("adamw8bit: code rows must be 8-byte aligned")


def adamw8bit(g, p, m_q, m_scale, v_q, v_scale, h) -> None:
    """One leaf's step with the constants `h` (train/optim8bit.Hyper)."""
    global launch_count
    from ..train import optim8bit

    if _route(p, "adamw8bit", g, m_q, m_scale, v_q, v_scale) == "cpu":
        optim8bit.adam8bit_update_plain(g, p, m_q, m_scale, v_q, v_scale, h)
        return
    _check(g, p, m_q, m_scale, v_q, v_scale)
    fn = _kernel()  # builds the library on first use; raises if it cannot
    tables = optim8bit.code_tables(p.device)["all"]
    stream = torch.cuda.current_stream(p.device).cuda_stream
    code = fn(
        *[t.data_ptr() for t in (g, p, m_q, m_scale, v_q, v_scale, tables)],
        p.numel(), h.b1, h.c1, h.b2, h.c2, h.eps, h.bc1, h.bc2, h.wd,
        h.neglr, stream)
    _build.check(code, "adam8bit_step")
    launch_count += 1
