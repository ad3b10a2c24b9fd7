"""w8a8: per-row int8 activation quantization and the int8 GEMM, the port
of the XLA `w8a8_dot` of vlaser_tpu/models/layers.py (and of the act_quant
`dot` of vlaser_tpu/kernels/fused_vit.py, which `csrc/fused_vit.cu` runs
through the same two kernels).

  quantize_rows: x [M, K] (bf16 or fp32) -> q int8 [M, K], am fp32 [M, G]:
      per row and per group of K/G columns am = max(max|x|, 1e-9) and
      q = round_half_even(x * (127 / am))  (IEEE division, as jnp computes
      it; torch's `127.0 / t` is a reciprocal times 127, so it is not used)
  int8_gemm: (q [M, K], am [M, 1], kq int8 [K, N], ks fp32 [N]) ->
      y = (float(q @ kq) * (am * (1/127))) * ks, fp32 or bf16 (int32
      accumulation; the order of the rescale is w8a8_dot's)
  w8a8_dot = int8_gemm(*quantize_rows(x), kq, ks)

On a CUDA tensor each wrapper launches its kernel of `csrc/w8a8.cu` and
counts the launch; on a CPU tensor it runs the plain version; any other
device raises, as does a failed build or launch. The plain product runs in
float64, which is exact for int8 operands (K x 127^2 < 2^53), so the
kernel's and the plain version's products agree bit for bit given the same
int8 rows.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

INV127 = 1.0 / 127.0
quant_launch_count = 0  # quantize_rows launches through the CUDA route
gemm_launch_count = 0   # int8_gemm launches through the CUDA route


def quantize_rows_plain(x2, groups: int = 1):
    """x2 [M, K] -> (q int8 [M, K], am fp32 [M, groups])."""
    M, K = x2.shape
    xf = x2.float().reshape(M, groups, K // groups)
    am = torch.clamp_min(xf.abs().amax(-1, keepdim=True), 1e-9)
    q = torch.round(xf * (torch.full_like(am, 127.0) / am)).to(torch.int8)
    return q.reshape(M, K), am.reshape(M, groups)


def int_mm_exact(q, kq):
    """int8 [M, K] x int8 [K, N] -> the exact integer product as fp32
    (float64 sums of int8 products are exact; one rounding to fp32, as
    int32 -> fp32)."""
    return (q.double() @ kq.double()).float()


def int8_gemm_plain(q, am, kq, ks, out_dtype=torch.float32):
    y = int_mm_exact(q, kq) * (am * INV127) * ks.float().reshape(1, -1)
    return y.to(out_dtype)


def w8a8_dot_plain(x2, kq, ks, out_dtype=torch.float32):
    return int8_gemm_plain(*quantize_rows_plain(x2), kq, ks, out_dtype)


_I, _P = ctypes.c_int, ctypes.c_void_p
_SIGNATURES = {  # C name -> (pointer args, the types after them)
    "w8a8_quantize_rows": (3, (_I, _I, _I, _I, _P)),
    "w8a8_gemm_rows": (5, (_I, _I, _I, _I, _P)),
}
_fns = {}


def _kernel(name):
    if name not in _fns:
        _fns[name] = _build.bind(name, *_SIGNATURES[name])
    return _fns[name]


def _route(x, what):
    if x.device.type in ("cpu", "cuda"):
        return x.device.type
    raise RuntimeError(f"{what}: no route for device {x.device}")


def quantize_rows(x2, groups: int = 1):
    """x2 [M, K] bf16 or fp32 -> (q int8 [M, K], am fp32 [M, groups])."""
    global quant_launch_count
    if _route(x2, "quantize_rows") == "cpu":
        return quantize_rows_plain(x2, groups)
    if x2.dtype not in (torch.bfloat16, torch.float32) or x2.dim() != 2:
        raise TypeError("quantize_rows: x must be bf16 or fp32 [M, K]")
    M, K = x2.shape
    if M == 0 or K % groups:
        raise ValueError(f"quantize_rows: {M} rows, K={K} in {groups} groups")
    fn = _kernel("w8a8_quantize_rows")  # a failed build raises here
    x2 = x2.contiguous()
    q = torch.empty((M, K), dtype=torch.int8, device=x2.device)
    am = torch.empty((M, groups), dtype=torch.float32, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    code = fn(
        x2.data_ptr(), q.data_ptr(), am.data_ptr(), M, K, groups,
        int(x2.dtype == torch.bfloat16), stream)
    _build.check(code, "w8a8_quantize_rows")
    quant_launch_count += 1
    return q, am


def int8_gemm(q, am, kq, ks, out_dtype=torch.float32):
    """q int8 [M, K], am fp32 [M, 1], kq int8 [K, N], ks fp32 [N] (or
    [1, N]) -> y [M, N] in out_dtype (fp32 or bf16)."""
    global gemm_launch_count
    if _route(q, "int8_gemm") == "cpu":
        return int8_gemm_plain(q, am, kq, ks, out_dtype)
    M, K = q.shape
    N = kq.shape[-1]
    dev = q.device
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("int8_gemm: out_dtype must be fp32 or bf16")
    for t, dt, shape in ((q, torch.int8, (M, K)), (am, torch.float32, (M, 1)),
                         (kq, torch.int8, (K, N)),
                         (ks, torch.float32, (N,))):
        if (t.device != dev or t.dtype != dt or not t.is_contiguous()
                or t.numel() != math.prod(shape)
                or t.shape[-1] != shape[-1]):
            raise TypeError(f"int8_gemm: need contiguous {dt} {shape} on "
                            f"{dev}")
    if M == 0 or K % 16 or N % 16:
        raise ValueError(f"int8_gemm: K={K} and N={N} must be multiples of 16")
    fn = _kernel("w8a8_gemm_rows")  # a failed build raises here
    y = torch.empty((M, N), dtype=out_dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(
        q.data_ptr(), am.data_ptr(), kq.data_ptr(), ks.data_ptr(),
        y.data_ptr(), M, N, K, int(out_dtype == torch.bfloat16), stream)
    _build.check(code, "w8a8_gemm_rows")
    gemm_launch_count += 1
    return y


def w8a8_dot(x, kq, ks, out_dtype=torch.float32):
    """x [..., K] -> [..., N]: quantize_rows then int8_gemm."""
    x2 = x.reshape(-1, x.shape[-1])
    q, am = quantize_rows(x2)
    return int8_gemm(q, am, kq, ks, out_dtype).reshape(*x.shape[:-1], -1)
