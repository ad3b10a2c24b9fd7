// w8a8 on Hopper: a per-row int8 activation quantizer and an int8
// tensor-core GEMM with a rescale epilogue.
//
// Replaces: vlaser_tpu/models/layers.py :: w8a8_dot (XLA: per-token int8
// quant, int8 x int8 -> int32 dot, fp32 rescale) and the act_quant `dot` of
// vlaser_tpu/kernels/fused_vit.py :: fused_vit_stack (fused_vit.py:150-168).
// Both compute the same thing, so both call the two kernels here
// (fused_vit.cu through the launchers of w8a8.cuh).
//
// What bounds it on the H100: the int8 tensor cores (1,979 TOP/s dense).
// At the VLA prefix shapes (384 or 3,072 rows x 1536 into 1536 / 256 /
// 8960, and 8960 into 1536) a GEMM does 2 x rows ops per weight byte: ~770
// at 384 rows, above the ~590 op/byte int8 ridge, so operations bound it;
// the quantizer is a bandwidth pass (read x once, write 1 byte an element).
//
// What the design does about it, simply first: the quantizer is one block
// per (row, column group), two passes over the row (amax, then quantize;
// LayerNorm recomputed in fp32 in each, not rounded to bf16). The GEMM is
// WMMA m16n16k16 s8 with int32 accumulators in 128x128x64 tiles (64x64 when
// 128x128 would leave SMs idle), 2 x 2 warps, two cp.async stages. int8
// fragments must start 32-byte aligned, so each stage keeps A and B as
// slabs of 16 bytes of K (A) or N (B) per row, 32 bytes of padding between
// slabs against bank conflicts. The epilogue applies the row scale
// (amax / 127) and the column (weight) scale in the order the JAX function
// uses, with __fmul_rn / __fadd_rn so that no FMA contraction changes a
// rounding: given the same int8 rows, the products equal the plain
// version's (float64, exact) bit for bit. No TMA / wgmma yet.
#include <mma.h>

#include "w8a8.cuh"

using namespace nvcuda;

namespace w8a8 {

constexpr int BK = 64;   // bytes of K per stage
constexpr int SL = 16;   // bytes per slab row
constexpr int THREADS = 128;
constexpr int FULL_WAVE = 132;  // SMs
constexpr int QTHREADS = 256;

template <int BM, int BN>
struct Tile {
  static constexpr int SA = BM * SL + 32;  // A slab: BM rows x 16 bytes of K
  static constexpr int SB = BK * SL + 32;  // B slab: BK rows x 16 bytes of N
  static constexpr int A_BYTES = (BK / SL) * SA;
  static constexpr int B_BYTES = (BN / SL) * SB;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int LDC = BN + 4;  // int32 words, epilogue half tile
  static constexpr int SMEM_C = (BM / 2) * LDC * 4;
  static constexpr int SMEM = 2 * STAGE > SMEM_C ? 2 * STAGE : SMEM_C;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float ld(const bf16* p, int i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float ld(const float* p, int i) { return p[i]; }

// One block per (row, group). LN: v = (x - mean) * rsqrt(var + eps) * w + b
// in fp32 (var = E[x^2] - mean^2, as the TPU kernel's _layer_norm).
template <typename T, bool LN>
__global__ void __launch_bounds__(QTHREADS)
quantize_kernel(const T* __restrict__ x, int K, int G,
                const float* __restrict__ lnw, const float* __restrict__ lnb,
                float eps, int8_t* __restrict__ q, float* __restrict__ am) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const int g = blockIdx.y, Kg = K / G, c0 = g * Kg;
  const T* xr = x + row * K;
  float mean = 0.f, r = 1.f;
  if (LN) {
    float s = 0.f, ss = 0.f;
    for (int i = threadIdx.x; i < K; i += blockDim.x) {
      const float v = ld(xr, i);
      s += v;
      ss += v * v;
    }
    s = block_sum(s, red);
    ss = block_sum(ss, red);
    mean = s / K;
    r = rsqrtf(ss / K - mean * mean + eps);
  }
  auto val = [&](int i) {
    float v = ld(xr, i);
    if (LN)
      v = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), r), lnw[i]),
                    lnb[i]);
    return v;
  };
  float m = 0.f;
  for (int i = c0 + threadIdx.x; i < c0 + Kg; i += blockDim.x)
    m = fmaxf(m, fabsf(val(i)));
  const float a = fmaxf(block_max(m, red), 1e-9f);
  const float inv = 127.f / a;  // IEEE division (no fast math)
  int8_t* qr = q + row * K;
  for (int i = c0 + threadIdx.x; i < c0 + Kg; i += blockDim.x)
    qr[i] = (int8_t)__float2int_rn(__fmul_rn(val(i), inv));  // half to even
  if (threadIdx.x == 0) am[row * G + g] = a;
}

template <int EPI, int BM, int BN>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const int8_t* __restrict__ A, int lda,
            const float* __restrict__ am, int am_stride,
            const int8_t* __restrict__ B, const float* __restrict__ s_col,
            int M, int N, int K,
            int row_first, const float* __restrict__ bias,
            const float* __restrict__ addm, const float* __restrict__ ls,
            float* __restrict__ out_f, bf16* __restrict__ out_b) {
  using T = Tile<BM, BN>;
  constexpr int WM = BM / 2, WN = BN / 2, FM = WM / 16, FN = WN / 16;
  __shared__ __align__(128) unsigned char smem[T::SMEM];
  int* Cs = reinterpret_cast<int*>(smem);  // [BM/2][LDC] after the K loop

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_stage = [&](int stage, int k0) {
    unsigned char* as = smem + stage * T::STAGE;
    unsigned char* bs = as + T::A_BYTES;
    for (int c = tid; c < BM * (BK / SL); c += THREADS) {
      const int r = c / (BK / SL), kc = c % (BK / SL);
      const bool ok = m0 + r < M && k0 + kc * SL < K;
      cp_async16(as + kc * T::SA + r * SL,
                 ok ? A + (size_t)(m0 + r) * lda + k0 + kc * SL : A,
                 ok ? 16 : 0);
    }
    for (int c = tid; c < BK * (BN / SL); c += THREADS) {
      const int r = c / (BN / SL), nc = c % (BN / SL);
      const bool ok = k0 + r < K && n0 + nc * SL < N;
      cp_async16(bs + nc * T::SB + r * SL,
                 ok ? B + (size_t)(k0 + r) * N + n0 + nc * SL : B,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int nk = (K + BK - 1) / BK;
  load_stage(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) & 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* as = smem + (kt & 1) * T::STAGE;
    const unsigned char* bs = as + T::A_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>
          af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major>
          bfr[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(
            af[i],
            reinterpret_cast<const signed char*>(as + kk * T::SA +
                                                 (wm * WM + i * 16) * SL),
            SL);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(
            bfr[j],
            reinterpret_cast<const signed char*>(
                bs + (wn * (WN / 16) + j) * T::SB + kk * 16 * SL),
            SL);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float inv127 = (float)(1.0 / 127.0);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (wm == half) {
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::store_matrix_sync(Cs + (i * 16) * T::LDC + wn * WN + j * 16,
                                  acc[i][j], T::LDC, wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = tid; idx < WM * BN; idx += THREADS) {
      const int r = idx / BN, c = idx % BN;
      const int gr = m0 + half * WM + r, gc = n0 + c;
      if (gr >= M || gc >= N) continue;
      const float a = __fmul_rn(am[(size_t)gr * am_stride], inv127);
      const float accf = __int2float_rn(Cs[r * T::LDC + c]);
      const float v = row_first ? __fmul_rn(__fmul_rn(accf, a), s_col[gc])
                                : __fmul_rn(accf, __fmul_rn(a, s_col[gc]));
      const size_t o = (size_t)gr * N + gc;
      if (EPI == EPI_F32) {
        out_f[o] = v;
      } else if (EPI == EPI_BF16) {
        out_b[o] = __float2bfloat16(v);
      } else if (EPI == EPI_BIAS_F32) {
        out_f[o] = __fadd_rn(v, bias[gc]);
      } else if (EPI == EPI_BIAS_GELU_F32) {
        const float t = __fadd_rn(v, bias[gc]);
        out_f[o] = 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
      } else {  // x = bf16(x + bf16(v + bias or addm) * ls), in place
        const float t = __fadd_rn(v, addm ? addm[o] : bias[gc]);
        const float xv = __bfloat162float(out_b[o]);
        out_b[o] = __float2bfloat16(__fadd_rn(xv, __fmul_rn(bf(t), ls[gc])));
      }
    }
    __syncthreads();
  }
}

template <int EPI>
static int gemm_t(int row_first, const int8_t* A, int lda, const float* am,
                  int am_stride, const int8_t* B, const float* s_col, int M,
                  int N, int K, const float* bias, const float* addm,
                  const float* ls, float* out_f, bf16* out_b,
                  cudaStream_t st) {
  const int mt = (M + 127) / 128;
  if (mt * ((N + 127) / 128) >= FULL_WAVE) {
    gemm_kernel<EPI, 128, 128><<<dim3((N + 127) / 128, mt), THREADS, 0, st>>>(
        A, lda, am, am_stride, B, s_col, M, N, K, row_first, bias, addm, ls,
        out_f, out_b);
  } else {
    gemm_kernel<EPI, 64, 64>
        <<<dim3((N + 63) / 64, (M + 63) / 64), THREADS, 0, st>>>(
            A, lda, am, am_stride, B, s_col, M, N, K, row_first, bias, addm,
            ls, out_f, out_b);
  }
  RETURN_IF_ERR();
  return 0;
}

int gemm(int epi, int row_first, const int8_t* A, int lda, const float* am,
         int am_stride, const int8_t* B, const float* s_col, int M, int N,
         int K, const float* bias, const float* addm, const float* ls,
         float* out_f, bf16* out_b, cudaStream_t st) {
  if (M <= 0 || K % 16 || N % 16 || lda % 16)
    return (int)cudaErrorInvalidValue;
#define W8A8_GEMM(E)                                                         \
  case E:                                                                    \
    return gemm_t<E>(row_first, A, lda, am, am_stride, B, s_col, M, N, K,    \
                     bias, addm, ls, out_f, out_b, st)
  switch (epi) {
    W8A8_GEMM(EPI_F32);
    W8A8_GEMM(EPI_BF16);
    W8A8_GEMM(EPI_BIAS_F32);
    W8A8_GEMM(EPI_BIAS_GELU_F32);
    W8A8_GEMM(EPI_BIAS_LS_RESIDUAL);
  }
#undef W8A8_GEMM
  return (int)cudaErrorInvalidValue;
}

int quantize(const void* x, int x_bf16, int M, int K, int G, const float* lnw,
             const float* lnb, float eps, int8_t* q, float* am,
             cudaStream_t st) {
  if (M <= 0 || G < 1 || K % G || (lnw && G != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(M, G);
  if (x_bf16) {
    if (lnw)
      quantize_kernel<bf16, true><<<grid, QTHREADS, 0, st>>>(
          (const bf16*)x, K, G, lnw, lnb, eps, q, am);
    else
      quantize_kernel<bf16, false><<<grid, QTHREADS, 0, st>>>(
          (const bf16*)x, K, G, lnw, lnb, eps, q, am);
  } else {
    if (lnw)
      quantize_kernel<float, true><<<grid, QTHREADS, 0, st>>>(
          (const float*)x, K, G, lnw, lnb, eps, q, am);
    else
      quantize_kernel<float, false><<<grid, QTHREADS, 0, st>>>(
          (const float*)x, K, G, lnw, lnb, eps, q, am);
  }
  RETURN_IF_ERR();
  return 0;
}

}  // namespace w8a8

// x [M, K] bf16 or fp32 -> q int8 [M, K], am fp32 [M, G] (G column groups).
extern "C" int w8a8_quantize_rows(const void* x, void* q, void* am, int M,
                                  int K, int G, int x_bf16, void* stream) {
  return w8a8::quantize(x, x_bf16, M, K, G, nullptr, nullptr, 0.f,
                        (int8_t*)q, (float*)am, (cudaStream_t)stream);
}

// y [M, N] (fp32, or bf16 if out_bf16) = (float(qa @ kq) * (am / 127)) * ks:
// the rescale order of models/layers.py w8a8_dot.
extern "C" int w8a8_gemm_rows(const void* qa, const void* am, const void* kq,
                              const void* ks, void* out, int M, int N, int K,
                              int out_bf16, void* stream) {
  return w8a8::gemm(out_bf16 ? w8a8::EPI_BF16 : w8a8::EPI_F32, 1,
                    (const int8_t*)qa, K, (const float*)am, 1,
                    (const int8_t*)kq, (const float*)ks, M, N, K, nullptr,
                    nullptr, nullptr, (float*)out, (bf16*)out,
                    (cudaStream_t)stream);
}
