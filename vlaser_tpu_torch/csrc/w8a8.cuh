// The w8a8 building blocks shared by w8a8.cu (the Dense w8a8_dot route) and
// fused_vit.cu (the act_quant encoder stack): a per-row int8 quantizer (with
// LayerNorm and silu-mul prologues) and an int8 tensor-core GEMM (wgmma s8,
// TMA) with a rescale epilogue.
// Host-side launchers; the kernels and their design notes live in w8a8.cu.
//
// The GEMM's weight operand is K-major, [N, K]: int8 wgmma reads both of its
// operands with the contraction dimension contiguous. The JAX layout of a
// Dense kernel is [in, out] = [K, N]; models/layers.py keeps a transposed
// copy (`kernel_qt`) beside it for the GEMM, and the act_quant ViT is
// packed [L, N, K] (kernels/fused_vit.py pack_vit_stack).
#pragma once
#include "common.cuh"

namespace w8a8 {

// What the GEMM epilogue writes after v = float(acc) * scale:
enum Epi {
  EPI_F32 = 0,              // out_f = v
  EPI_BF16 = 1,             // out_b = bf16(v)
  EPI_BIAS_F32 = 2,         // out_f = v + bias[col]
  EPI_BIAS_GELU_F32 = 3,    // out_f = gelu_erf(v + bias[col])
  EPI_BIAS_LS_RESIDUAL = 4  // t = v + (addm ? addm[row, col] : bias[col]);
                            // out_b = bf16(out_b + bf16(t) * ls[col])
};

// x [M, K] (bf16 if x_bf16, else fp32; row stride K) -> q int8 [M, K] and
// am fp32 [M, G]: per row and per group of K/G columns, am = max(max|v|,
// 1e-9) and q = round_half_even(v * (127 / am)). With lnw != nullptr, v is
// the fp32 LayerNorm of the row (G must be 1), not rounded to bf16. K % 16
// == 0, (K / G) % 8 == 0, x 16-byte and q 8-byte aligned (else
// cudaErrorInvalidValue). amax (G 1, no LayerNorm): an optional per-row
// absmax input, am = max(max|v|, amax[row], 1e-9) (a row-parallel layer's
// whole-row absmax, all-reduced over the ranks that hold its columns).
int quantize(const void* x, int x_bf16, int M, int K, int G, const float* lnw,
             const float* lnb, float eps, int8_t* q, float* am,
             cudaStream_t st, const float* amax = nullptr);

// The same for the rows of h = bf16(bf16(silu(g)) * u), g and u bf16 [M, K]
// (PyTorch's rounding of F.silu(g) * u), G 1; h is never stored.
int quantize_silu_mul(const bf16* g, const bf16* u, int M, int K, int8_t* q,
                      float* am, cudaStream_t st,
                      const float* amax = nullptr);

// int32 elements of scratch `gemm` needs for (M, N, K): the K splits' partial
// sums where the plan splits K (a grid short of one wave), else 0.
size_t gemm_ws_elems(int M, int N, int K);

// C = A int8 [M, K] (row stride lda) x B^T, B int8 [N, K] (K-major, row
// stride ldb), int32 accumulation, then v = float(acc) * scale with
// a = am[row * am_stride] * (1/127) and s = s_col[col]:
//   row_first: (float(acc) * a) * s   (models/layers.py w8a8_dot)
//   otherwise: float(acc) * (a * s)   (the fused ViT stack's dot)
// then the epilogue `epi` into out [M, N] (row stride N). K, N, lda and ldb
// multiples of 16 and A, B 16-byte aligned (TMA); ws: gemm_ws_elems(M, N,
// K) int32 elements or more.
int gemm(int epi, int row_first, const int8_t* A, int lda, const float* am,
         int am_stride, const int8_t* B, int ldb, const float* s_col, int M,
         int N, int K, const float* bias, const float* addm, const float* ls,
         float* out_f, bf16* out_b, int32_t* ws, size_t ws_elems,
         cudaStream_t st);

}  // namespace w8a8
