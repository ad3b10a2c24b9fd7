"""w8a8: per-row int8 activation quantization and the int8 GEMM, the port
of the XLA `w8a8_dot` of vlaser_tpu/models/layers.py (and of the act_quant
`dot` of vlaser_tpu/kernels/fused_vit.py, which `csrc/fused_vit.cu` runs
through the same two kernels).

  quantize_rows: x [M, K] (bf16 or fp32) -> q int8 [M, K], am fp32 [M, G]:
      per row and per group of K/G columns am = max(max|x|, 1e-9) and
      q = round_half_even(x * (127 / am))  (IEEE division, as jnp computes
      it; torch's `127.0 / t` is a reciprocal times 127, so it is not used)
  int8_gemm: (q [M, K], am [M, 1], kt int8 [N, K], ks fp32 [N]) ->
      y = (float(q @ kt^T) * (am * (1/127))) * ks, fp32 or bf16 (int32
      accumulation; the order of the rescale is w8a8_dot's)
  w8a8_dot = int8_gemm(*quantize_rows(x), kt, ks)

The weight is K-major, [N, K] = the JAX kernel [K, N] transposed: the int8
tensor-core product (wgmma s8) reads both operands with K contiguous.
models/layers.py derives that copy of a w8a8 Dense's kernel on its first
w8a8 call (`Dense.kernel_kmajor`, the buffer `kernel_qt`). `int8_gemm_ex` exposes the GEMM's other options (the act_quant
ViT's epilogues, row strides, the row-scale stride) for tests and timing.

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
# the GEMM's epilogue modes (csrc/w8a8.cuh Epi)
EPI_F32, EPI_BF16, EPI_BIAS_F32, EPI_BIAS_GELU_F32, EPI_BIAS_LS_RESIDUAL = \
    range(5)
quant_launch_count = 0  # quantize_rows launches through the CUDA route
gemm_launch_count = 0   # int8 GEMM launches through the CUDA route


def quantize_rows_plain(x2, groups: int = 1):
    """x2 [M, K] -> (q int8 [M, K], am fp32 [M, groups])."""
    M, K = x2.shape
    xf = x2.float().reshape(M, groups, K // groups)
    am = torch.clamp_min(xf.abs().amax(-1, keepdim=True), 1e-9)
    q = torch.round(xf * (torch.full_like(am, 127.0) / am)).to(torch.int8)
    return q.reshape(M, K), am.reshape(M, groups)


def int_mm_exact(q, kt):
    """int8 [M, K] x (int8 [N, K])^T -> the exact integer product as fp32
    (float64 sums of int8 products are exact; one rounding to fp32, as
    int32 -> fp32)."""
    return (q.double() @ kt.double().T).float()


def int8_gemm_plain(q, am, kt, ks, out_dtype=torch.float32):
    y = int_mm_exact(q, kt) * (am * INV127) * ks.float().reshape(1, -1)
    return y.to(out_dtype)


def w8a8_dot_plain(x2, kt, ks, out_dtype=torch.float32):
    return int8_gemm_plain(*quantize_rows_plain(x2), kt, ks, out_dtype)


def int8_gemm_ex_plain(a, am, b, s_col, epi, row_first=False, bias=None,
                       addm=None, ls=None, out=None):
    """The plain version of int8_gemm_ex, in the kernel's order of
    roundings."""
    acc = int_mm_exact(a, b)
    s = s_col.float().reshape(1, -1)
    sc = am.float().reshape(-1, 1) * INV127
    v = acc * sc * s if row_first else acc * (sc * s)
    if epi == EPI_F32:
        return v
    if epi == EPI_BF16:
        return v.to(torch.bfloat16)
    if epi == EPI_BIAS_F32:
        return v + bias.float()
    if epi == EPI_BIAS_GELU_F32:
        t = v + bias.float()
        return 0.5 * t * (1 + torch.erf(t * 0.70710678118654752))
    if epi == EPI_BIAS_LS_RESIDUAL:
        t = v + (addm.float() if addm is not None else bias.float())
        return (out.float() + t.to(torch.bfloat16).float() * ls.float()).to(
            torch.bfloat16)
    raise ValueError(f"int8_gemm_ex: unknown epilogue {epi}")


_I, _P, _LL = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {  # C name -> (pointer args, the types after them)
    "w8a8_quantize_rows": (3, (_I, _I, _I, _I, _P)),
    "w8a8_gemm_rows": (6, (_I, _I, _I, _I, _LL, _P)),
    "w8a8_gemm_general": (10, (_I,) * 8 + (_LL, _P)),
    "w8a8_s8_probe": (3, (_I, _P)),
}
_fns = {}
_ws_elems = {}  # (M, N, K) -> int32 scratch elements of the GEMM


def _kernel(name):
    if name not in _fns:
        _fns[name] = _build.bind(name, *_SIGNATURES[name])
    return _fns[name]


def workspace_elems(M: int, N: int, K: int) -> int:
    """int32 scratch elements the GEMM of (M, N, K) needs (the partial sums
    where its plan splits K; 0 where it does not)."""
    key = (M, N, K)
    if key not in _ws_elems:
        fn = _build.library().w8a8_gemm_workspace
        fn.argtypes, fn.restype = [_I, _I, _I], _LL
        _ws_elems[key] = int(fn(M, N, K))
    return _ws_elems[key]


def _workspace(M, N, K, dev):
    n = workspace_elems(M, N, K)
    return torch.empty(max(n, 1), dtype=torch.int32, device=dev), n


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


def int8_gemm(q, am, kt, ks, out_dtype=torch.float32):
    """q int8 [M, K], am fp32 [M, 1], kt int8 [N, K] (K-major), ks fp32 [N]
    (or [1, N]) -> y [M, N] in out_dtype (fp32 or bf16)."""
    global gemm_launch_count
    if _route(q, "int8_gemm") == "cpu":
        return int8_gemm_plain(q, am, kt, ks, out_dtype)
    M, K = q.shape
    N = kt.shape[0]
    dev = q.device
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("int8_gemm: out_dtype must be fp32 or bf16")
    for t, dt, shape in ((q, torch.int8, (M, K)), (am, torch.float32, (M, 1)),
                         (kt, torch.int8, (N, K)),
                         (ks, torch.float32, (N,))):
        if (t.device != dev or t.dtype != dt or not t.is_contiguous()
                or t.numel() != math.prod(shape)
                or t.shape[-1] != shape[-1]):
            raise TypeError(f"int8_gemm: need contiguous {dt} {shape} on "
                            f"{dev} (the weight K-major [N, K])")
    if M == 0 or K % 16 or N % 16:
        raise ValueError(f"int8_gemm: K={K} and N={N} must be multiples of 16")
    fn = _kernel("w8a8_gemm_rows")  # a failed build raises here
    y = torch.empty((M, N), dtype=out_dtype, device=dev)
    ws, n_ws = _workspace(M, N, K, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = fn(
        q.data_ptr(), am.data_ptr(), kt.data_ptr(), ks.data_ptr(),
        y.data_ptr(), ws.data_ptr(), M, N, K,
        int(out_dtype == torch.bfloat16), n_ws, stream)
    _build.check(code, "w8a8_gemm_rows")
    gemm_launch_count += 1
    return y


def _rows(t, dt, what):
    """A 2-d view with unit column stride -> its row stride."""
    if t.dtype != dt or t.dim() != 2 or t.stride(1) != 1:
        raise TypeError(f"int8_gemm_ex: {what} must be a {dt} [rows, cols] "
                        f"view with unit column stride")
    return t.stride(0)


def int8_gemm_ex(a, am, b, s_col, epi, row_first=False, bias=None,
                 addm=None, ls=None, out=None):
    """The GEMM with every option of csrc/w8a8.cuh: a int8 [M, K] and b int8
    [N, K] (K-major) may be column slices of wider rows (their row strides
    are passed), am fp32 [M] may be strided (the act_quant ViT's [M, 2]
    row scales of fc2's halves), s_col fp32 [N]. epi: EPI_F32 or EPI_BF16
    (v), EPI_BIAS_F32 (v + bias), EPI_BIAS_GELU_F32 (gelu(v + bias)), all
    fp32 [M, N] but EPI_BF16; EPI_BIAS_LS_RESIDUAL updates `out` (bf16 [M,
    N]) in place to bf16(out + bf16(v + (addm or bias)) * ls) and returns
    it. v = (float(acc) * a) * s if row_first else float(acc) * (a * s),
    a = am / 127."""
    global gemm_launch_count
    if _route(a, "int8_gemm_ex") == "cpu":
        if epi == EPI_BIAS_LS_RESIDUAL:
            out.copy_(int8_gemm_ex_plain(a, am, b, s_col, epi, row_first,
                                         bias, addm, ls, out))
            return out
        return int8_gemm_ex_plain(a, am, b, s_col, epi, row_first, bias,
                                  addm, ls, out)
    M, K = a.shape
    N = b.shape[0]
    dev = a.device
    lda, ldb = _rows(a, torch.int8, "a"), _rows(b, torch.int8, "b")
    if b.shape[1] != K or am.dim() != 1 or am.shape[0] != M or \
            am.dtype != torch.float32:
        raise TypeError("int8_gemm_ex: a [M, K], b [N, K], am fp32 [M]")
    s_col, bias, addm, ls = (t if t is None else t.contiguous()
                             for t in (s_col, bias, addm, ls))
    if epi == EPI_BIAS_LS_RESIDUAL:
        if out is None or out.dtype != torch.bfloat16 or \
                not out.is_contiguous() or out.shape != (M, N):
            raise TypeError("int8_gemm_ex: the residual mode updates a "
                            "contiguous bf16 [M, N] `out`")
        y = out
    else:
        y = torch.empty((M, N), device=dev, dtype=torch.bfloat16
                        if epi == EPI_BF16 else torch.float32)
    fn = _kernel("w8a8_gemm_general")  # a failed build raises here
    ws, n_ws = _workspace(M, N, K, dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    fo, bo = (y, None) if y.dtype == torch.float32 else (None, y)
    code = fn(ptr(a), ptr(am), ptr(b), ptr(s_col), ptr(bias), ptr(addm),
              ptr(ls), ptr(fo), ptr(bo), ws.data_ptr(), int(epi),
              int(row_first), lda, am.stride(0), ldb, M, N, K, n_ws,
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "w8a8_gemm_general")
    gemm_launch_count += 1
    return y


def s8_probe(a, b):
    """The GEMM's product alone on one tile (probe_kernel of csrc/w8a8.cu):
    a int8 [64, 128], b int8 [N, 128] (K-major, N 128 or 256) on the card,
    each loaded by one TMA copy -> a @ b^T, int32 [64, N]."""
    n = b.shape[0]
    if a.shape != (64, 128) or b.shape != (n, 128) or n not in (128, 256) \
            or a.dtype != torch.int8 or b.dtype != torch.int8:
        raise ValueError("s8_probe: a int8 [64, 128], b int8 [128 or 256, "
                         "128]")
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((64, n), dtype=torch.int32, device=a.device)
    code = _kernel("w8a8_s8_probe")(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), n,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(code, "w8a8_s8_probe")
    return c


def w8a8_dot(x, kt, ks, out_dtype=torch.float32):
    """x [..., K] -> [..., N]: quantize_rows then int8_gemm (kt [N, K])."""
    x2 = x.reshape(-1, x.shape[-1])
    q, am = quantize_rows(x2)
    return int8_gemm(q, am, kt, ks, out_dtype).reshape(*x.shape[:-1], -1)
