// InternViT encoder stack for Hopper (bf16 weights).
//
// Replaces: vlaser_tpu/kernels/fused_vit.py :: fused_vit_stack (the Pallas
// kernel built by _make_kernel; pallas_call at fused_vit.py:498), bf16 mode.
//
// What bounds it on the H100: at the serving shape (B=1, S=1025 tokens,
// hidden 1024, 16 heads x 64, inter 4096, 24 layers) the layer is ~26 GFLOP
// of matmul against ~25 MB of bf16 weights: ~1000 FLOP per weight byte, far
// above the ~295 FLOP/byte ridge, so the tensor cores bound it. Attention is
// ~4 GFLOP per layer at head_dim 64 (short contraction, low tensor-core
// utilisation), the norms and the activation epilogues are bandwidth-bound
// passes over [S, hidden] bf16 activations.
//
// What the design does about it: every matmul runs on the bf16 tensor cores
// (WMMA 16x16x16, fp32 accumulation) in a 128x128x32 tiled GEMM with 64x64
// warp tiles and two cp.async stages (64x64 tiles when N is small, so N=1024
// still covers the 132 SMs twice), whose
// epilogue fuses what the TPU kernel fused in-register: the bias, the exact
// erf GELU (with the bf16 store that feeds fc2), and the layer-scale +
// residual update with the bf16 rounding of fused_vit.py:390-394,426-430.
// Attention is one kernel per (64-query block, head, sample) over the S keys,
// masking the ragged key edge (S=1025 is not a multiple of 64); it runs two
// passes over the keys (row max, then exp2 + P.V) so that, like the TPU
// kernel, every row uses ONE fixed softmax shift and the P.V operand is the
// bf16-rounded exponent; the row max replaces the TPU's Cauchy-Schwarz
// bound and erff replaces its polynomial erf. The host loops over layers in
// C (one ctypes call per stack). Simple first: no TMA / wgmma / warp
// specialisation yet, and attention loads its K/V tiles synchronously.
//
// act_quant (w8a8) mode, vit_stack_forward_w8a8: the same layer loop with
// int8 weights. Each of qkv / proj / fc1 / fc2 quantizes its activation
// rows to int8 (w8a8.cu's quantizer; LayerNorm fused in fp32 for qkv and
// fc1, the fp32 GELU output for fc2, the bf16 attention output for proj)
// and runs w8a8.cu's int8 tensor-core GEMM, whose epilogue rescales by
// (row amax / 127) * column scale and then adds the bias, applies GELU or
// the layer-scale residual as above. Attention stays bf16. At B > 1 the TPU
// kernel runs the MLP in two halves of `inter` and quantizes fc2's input
// per half; here fc2 is two GEMMs, the first writing fc2b + half 0 in fp32,
// the second adding half 1 before the residual: the same groups and order.
#include <mma.h>

#include "common.cuh"
#include "w8a8.cuh"

using namespace nvcuda;

namespace vit {

constexpr int BK = 32, LDA = BK + 8;
constexpr int GEMM_THREADS = 128;  // 2 x 2 warps, each BM/2 x BN/2
constexpr int FULL_WAVE = 132;     // SMs

template <int BM, int BN>
struct Tile {
  static constexpr int LDB = BN + 8, LDC = BN + 4;
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = BK * LDB;
  static constexpr int SMEM_AB = 2 * (A_ELEMS + B_ELEMS) * 2;  // 2 stages
  static constexpr int SMEM_C = (BM / 2) * LDC * 4;  // epilogue, half tile
  static constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  // src_bytes = 0 zero-fills the 16 bytes (ragged edges)
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

enum { EPI_BIAS_F32 = 0, EPI_BIAS_GELU_BF16 = 1, EPI_BIAS_LS_RESIDUAL = 2 };

// LayerNorm with fp32 statistics (mean, E[x^2] - mean^2 as the TPU kernel's
// _layer_norm), bf16 out. One block per row.
__global__ void layer_norm_kernel(const bf16* __restrict__ x,
                                  const float* __restrict__ w,
                                  const float* __restrict__ b,
                                  bf16* __restrict__ y, int C, float eps) {
  __shared__ float red[32];
  const bf16* xr = x + (size_t)blockIdx.x * C;
  bf16* yr = y + (size_t)blockIdx.x * C;
  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    float v = __bfloat162float(xr[i]);
    s += v;
    ss += v * v;
  }
  s = block_sum(s, red);
  ss = block_sum(ss, red);
  const float mean = s / C;
  const float var = ss / C - mean * mean;
  const float r = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    float v = __bfloat162float(xr[i]);
    yr[i] = __float2bfloat16((v - mean) * r * w[i] + b[i]);
  }
}

// qkv f32 [M, 3C] -> q (x scale*log2e), k, v bf16 [M, C]; optional
// full-hidden QK-RMSNorm (fp32) before the rounding. One block per row.
__global__ void qkv_prep_kernel(const float* __restrict__ qkv,
                                const float* __restrict__ qnw,
                                const float* __restrict__ knw,
                                bf16* __restrict__ q, bf16* __restrict__ k,
                                bf16* __restrict__ v, int C, float eps,
                                int qk_norm, float qscale) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const float* r = qkv + row * 3 * C;
  float rq = 1.f, rk = 1.f;
  if (qk_norm) {
    float sq = 0.f, sk = 0.f;
    for (int i = threadIdx.x; i < C; i += blockDim.x) {
      sq += r[i] * r[i];
      sk += r[C + i] * r[C + i];
    }
    sq = block_sum(sq, red);
    sk = block_sum(sk, red);
    rq = rsqrtf(sq / C + eps);
    rk = rsqrtf(sk / C + eps);
  }
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    float qv = r[i], kv = r[C + i];
    if (qk_norm) {
      qv = qv * rq * qnw[i];
      kv = kv * rk * knw[i];
    }
    q[row * C + i] = __float2bfloat16(qv * qscale);
    k[row * C + i] = __float2bfloat16(kv);
    v[row * C + i] = __float2bfloat16(r[2 * C + i]);
  }
}

// C[M, N] = A[M, K] (bf16, row-major) @ B[K, N] (bf16, row-major), fp32
// accumulate, fused epilogue. K % 8 == 0 and N % 8 == 0; M is ragged.
// BM x BN x 32 tiles, 2 x 2 warps of BM/2 x BN/2 WMMA fragments, two
// cp.async stages (the next K tile loads while the tensor cores work on this
// one); the epilogue runs one half of the tile's rows at a time.
template <int EPI, int BM, int BN>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, int M,
            int N, int K, const float* __restrict__ bias,
            const float* __restrict__ ls, float* __restrict__ out_f,
            bf16* __restrict__ out_b) {
  using T = Tile<BM, BN>;
  constexpr int WM = BM / 2, WN = BN / 2, FM = WM / 16, FN = WN / 16;
  __shared__ __align__(128) unsigned char smem[T::SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);                 // [2][A_ELEMS]
  bf16* Bs = As + 2 * T::A_ELEMS;                           // [2][B_ELEMS]
  float* Cs = reinterpret_cast<float*>(smem);               // [BM/2][LDC]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  auto load_stage = [&](int stage, int k0) {
    bf16* as = As + stage * T::A_ELEMS;
    bf16* bs = Bs + stage * T::B_ELEMS;
    for (int c = tid; c < BM * BK / 8; c += GEMM_THREADS) {
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + col < K;
      cp_async16(as + r * LDA + col,
                 ok ? A + (size_t)(m0 + r) * K + k0 + col : A, ok ? 16 : 0);
    }
    for (int c = tid; c < BK * BN / 8; c += GEMM_THREADS) {
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      const bool ok = k0 + r < K && n0 + col < N;
      cp_async16(bs + r * T::LDB + col,
                 ok ? B + (size_t)(k0 + r) * N + n0 + col : B, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

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
    const bf16* as = As + (kt & 1) * T::A_ELEMS;
    const bf16* bs = Bs + (kt & 1) * T::B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], as + (wm * WM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bfr[j], bs + kk * T::LDB + wn * WN + j * 16, T::LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: rows [half*64, half*64+64) of the tile, from the warps that own them
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
    for (int idx = tid; idx < WM * BN; idx += GEMM_THREADS) {
      const int r = idx / BN, c = idx % BN;
      const int gr = m0 + half * WM + r, gc = n0 + c;
      if (gr >= M || gc >= N) continue;
      const size_t o = (size_t)gr * N + gc;
      const float v = Cs[r * T::LDC + c] + bias[gc];
      if (EPI == EPI_BIAS_F32) {
        out_f[o] = v;
      } else if (EPI == EPI_BIAS_GELU_BF16) {
        out_b[o] = __float2bfloat16(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
      } else {  // x = bf16(x + bf16(acc + bias) * ls), in place
        const float xv = __bfloat162float(out_b[o]);
        out_b[o] = __float2bfloat16(xv + bf(v) * ls[gc]);
      }
    }
    __syncthreads();
  }
}

// Non-causal attention, head_dim 64. q/k/v/out bf16 [B*S, C] (C = heads*64,
// head h in columns h*64..h*64+63); q is pre-scaled by head_dim^-0.5*log2(e)
// so the softmax runs in exp2. Grid (ceil(S/64), heads, B), 4 warps, each
// owning 16 query rows. Pass 1: row max over all keys. Pass 2: p = exp2(s -
// max) rounded to bf16, denominator = sum of the rounded p, O += P.V.
constexpr int AT_D = 64, AT_T = 64, AT_LD = 72, AT_LDS = 68;

__global__ void __launch_bounds__(128)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int S,
                 int C) {
  __shared__ __align__(128) bf16 Qs[AT_T * AT_LD];  // Q tile, then P per warp
  __shared__ __align__(128) bf16 Ks[AT_T * AT_LD];
  __shared__ __align__(128) bf16 Vs[AT_T * AT_LD];
  __shared__ __align__(128) float Ss[4 * 16 * AT_LDS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * AT_T, h = blockIdx.y;
  const size_t base = (size_t)blockIdx.z * S;
  const int col0 = h * AT_D;
  float* Sw = Ss + warp * 16 * AT_LDS;
  bf16* Pw = Qs + warp * 16 * AT_LD;

  auto load_tile = [&](bf16* dst, const bf16* src, int r0) {
    for (int c = tid; c < AT_T * AT_D / 8; c += 128) {
      const int r = c / (AT_D / 8), col = (c % (AT_D / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r0 + r < S)
        val = *reinterpret_cast<const uint4*>(src + (base + r0 + r) * C + col0 + col);
      *reinterpret_cast<uint4*>(dst + r * AT_LD + col) = val;
    }
  };

  load_tile(Qs, q, q0);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[AT_D / 16];
#pragma unroll
  for (int kk = 0; kk < AT_D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * AT_LD + kk * 16, AT_LD);

  // scores of this warp's 16 rows against key tile -> Sw [16, 64] f32
  auto scores = [&]() {
#pragma unroll
    for (int j = 0; j < AT_T / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
      wmma::fill_fragment(sacc, 0.f);
#pragma unroll
      for (int kk = 0; kk < AT_D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, Ks + j * 16 * AT_LD + kk * 16, AT_LD);
        wmma::mma_sync(sacc, qf[kk], kb, sacc);
      }
      wmma::store_matrix_sync(Sw + j * 16, sacc, AT_LDS, wmma::mem_row_major);
    }
    __syncwarp();
  };

  const int n_kt = (S + AT_T - 1) / AT_T;
  const int r = lane >> 1, c0 = (lane & 1) * 32;  // lane: half of one row

  float m = -3.0e38f;  // every row sees at least one valid key
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile(Ks, k, kt * AT_T);
    __syncthreads();
    scores();
    for (int c = 0; c < 32; ++c)
      if (kt * AT_T + c0 + c < S) m = fmaxf(m, Sw[r * AT_LDS + c0 + c]);
    __syncwarp();
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[AT_D / 16];
#pragma unroll
  for (int j = 0; j < AT_D / 16; ++j) wmma::fill_fragment(o[j], 0.f);
  float d = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile(Ks, k, kt * AT_T);
    load_tile(Vs, v, kt * AT_T);
    __syncthreads();
    scores();
    for (int c = 0; c < 32; ++c) {
      float p = 0.f;
      if (kt * AT_T + c0 + c < S) p = exp2f(Sw[r * AT_LDS + c0 + c] - m);
      const bf16 pb = __float2bfloat16(p);
      d += __bfloat162float(pb);
      Pw[r * AT_LD + c0 + c] = pb;
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < AT_T / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, Pw + kk * 16, AT_LD);
#pragma unroll
      for (int j = 0; j < AT_D / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, Vs + kk * 16 * AT_LD + j * 16, AT_LD);
        wmma::mma_sync(o[j], pa, vb, o[j]);
      }
    }
    __syncwarp();
  }
  d += __shfl_xor_sync(0xffffffffu, d, 1);

#pragma unroll
  for (int j = 0; j < AT_D / 16; ++j)
    wmma::store_matrix_sync(Sw + j * 16, o[j], AT_LDS, wmma::mem_row_major);
  __syncwarp();
  const int row = q0 + warp * 16 + r;
  if (row < S) {
    const float inv = 1.f / d;
    bf16* dst = out + (base + row) * C + col0;
    for (int c = 0; c < 32; ++c)
      dst[c0 + c] = __float2bfloat16(Sw[r * AT_LDS + c0 + c] * inv);
  }
}

// 128 x 128 tiles (64 x 64 warp tiles), or 64 x 64 tiles when 128 x 128
// would leave SMs without a block (N = 1024: 272 blocks instead of 72).
template <int EPI>
static int gemm(const bf16* A, const bf16* B, int M, int N, int K,
                const float* bias, const float* ls, float* out_f, bf16* out_b,
                cudaStream_t st) {
  const int mt = (M + 127) / 128;
  if (mt * ((N + 127) / 128) >= FULL_WAVE) {
    gemm_kernel<EPI, 128, 128><<<dim3((N + 127) / 128, mt), GEMM_THREADS, 0, st>>>(
        A, B, M, N, K, bias, ls, out_f, out_b);
  } else {
    gemm_kernel<EPI, 64, 64><<<dim3((N + 63) / 64, (M + 63) / 64), GEMM_THREADS, 0,
                               st>>>(A, B, M, N, K, bias, ls, out_f, out_b);
  }
  RETURN_IF_ERR();
  return 0;
}

}  // namespace vit

// The whole stack: x bf16 [B*S, C] is updated in place, layer by layer.
// Per-layer f32 vectors are stacked [L, n]; weights bf16 [L, K, N].
// Scratch: h bf16 [M, C], qkv f32 [M, 3C], qb/kb/vb/attn bf16 [M, C],
// mid bf16 [M, inter] (M = B*S).
extern "C" int vit_stack_forward(
    void* x_, const void* ln1w_, const void* ln1b_, const void* ln2w_,
    const void* ln2b_, const void* ls1_, const void* ls2_, const void* qnw_,
    const void* knw_, const void* qkvb_, const void* projb_, const void* fc1b_,
    const void* fc2b_, const void* qkvw_, const void* projw_, const void* fc1w_,
    const void* fc2w_, void* h_, void* qkv_, void* qb_, void* kb_, void* vb_,
    void* attn_, void* mid_, int B, int S, int C, int inter, int heads, int L,
    float eps, int qk_norm, float qscale, void* stream) {
  using namespace vit;
  if (C != heads * AT_D || C % 8 || inter % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  bf16* x = (bf16*)x_;
  bf16 *h = (bf16*)h_, *qb = (bf16*)qb_, *kb = (bf16*)kb_, *vb = (bf16*)vb_;
  bf16 *attn = (bf16*)attn_, *mid = (bf16*)mid_;
  float* qkv = (float*)qkv_;
  const float *ln1w = (const float*)ln1w_, *ln1b = (const float*)ln1b_;
  const float *ln2w = (const float*)ln2w_, *ln2b = (const float*)ln2b_;
  const float *ls1 = (const float*)ls1_, *ls2 = (const float*)ls2_;
  const float *qnw = (const float*)qnw_, *knw = (const float*)knw_;
  const float *qkvb = (const float*)qkvb_, *projb = (const float*)projb_;
  const float *fc1b = (const float*)fc1b_, *fc2b = (const float*)fc2b_;
  const bf16 *qkvw = (const bf16*)qkvw_, *projw = (const bf16*)projw_;
  const bf16 *fc1w = (const bf16*)fc1w_, *fc2w = (const bf16*)fc2w_;
  const int M = B * S;
  const dim3 agrid((S + AT_T - 1) / AT_T, heads, B);
  int err;
  for (int l = 0; l < L; ++l) {
    const size_t lc = (size_t)l * C;
    layer_norm_kernel<<<M, 256, 0, st>>>(x, ln1w + lc, ln1b + lc, h, C, eps);
    RETURN_IF_ERR();
    if ((err = gemm<EPI_BIAS_F32>(h, qkvw + (size_t)l * C * 3 * C, M, 3 * C, C,
                                  qkvb + 3 * lc, nullptr, qkv, nullptr, st)))
      return err;
    qkv_prep_kernel<<<M, 256, 0, st>>>(qkv, qnw + lc, knw + lc, qb, kb, vb, C,
                                       eps, qk_norm, qscale);
    RETURN_IF_ERR();
    attention_kernel<<<agrid, 128, 0, st>>>(qb, kb, vb, attn, S, C);
    RETURN_IF_ERR();
    if ((err = gemm<EPI_BIAS_LS_RESIDUAL>(attn, projw + (size_t)l * C * C, M, C, C,
                                          projb + lc, ls1 + lc, nullptr, x, st)))
      return err;
    layer_norm_kernel<<<M, 256, 0, st>>>(x, ln2w + lc, ln2b + lc, h, C, eps);
    RETURN_IF_ERR();
    if ((err = gemm<EPI_BIAS_GELU_BF16>(h, fc1w + (size_t)l * C * inter, M, inter,
                                        C, fc1b + (size_t)l * inter, nullptr,
                                        nullptr, mid, st)))
      return err;
    if ((err = gemm<EPI_BIAS_LS_RESIDUAL>(mid, fc2w + (size_t)l * inter * C, M, C,
                                          inter, fc2b + lc, ls2 + lc, nullptr, x,
                                          st)))
      return err;
  }
  return 0;
}

// The act_quant stack: x bf16 [B*S, C] updated in place. Weights int8
// [L, K, N] with fp32 per-output-channel scales [L, N]. Scratch: aq int8
// [M, max(C, inter)] and am fp32 [M, 2] (the quantized activation of each
// GEMM in turn), qkv f32 [M, 3C], qb/kb/vb/attn bf16 [M, C], mid f32
// [M, inter], part f32 [M, C] (B > 1 only).
extern "C" int vit_stack_forward_w8a8(
    void* x_, const void* ln1w_, const void* ln1b_, const void* ln2w_,
    const void* ln2b_, const void* ls1_, const void* ls2_, const void* qnw_,
    const void* knw_, const void* qkvb_, const void* projb_, const void* fc1b_,
    const void* fc2b_, const void* qkvs_, const void* projs_, const void* fc1s_,
    const void* fc2s_, const void* qkvw_, const void* projw_, const void* fc1w_,
    const void* fc2w_, void* aq_, void* am_, void* qkv_, void* qb_, void* kb_,
    void* vb_, void* attn_, void* mid_, void* part_, int B, int S, int C,
    int inter, int heads, int L, float eps, int qk_norm, float qscale,
    void* stream) {
  using namespace vit;
  const int G = B == 1 ? 1 : 2;  // fc2's quantization groups (TPU n_chunks)
  if (C != heads * AT_D || C % 16 || inter % (16 * G))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  bf16* x = (bf16*)x_;
  int8_t* aq = (int8_t*)aq_;
  float *am = (float*)am_, *qkv = (float*)qkv_, *mid = (float*)mid_;
  float* part = (float*)part_;
  bf16 *qb = (bf16*)qb_, *kb = (bf16*)kb_, *vb = (bf16*)vb_;
  bf16* attn = (bf16*)attn_;
  const float *ln1w = (const float*)ln1w_, *ln1b = (const float*)ln1b_;
  const float *ln2w = (const float*)ln2w_, *ln2b = (const float*)ln2b_;
  const float *ls1 = (const float*)ls1_, *ls2 = (const float*)ls2_;
  const float *qnw = (const float*)qnw_, *knw = (const float*)knw_;
  const float *qkvb = (const float*)qkvb_, *projb = (const float*)projb_;
  const float *fc1b = (const float*)fc1b_, *fc2b = (const float*)fc2b_;
  const float *qkvs = (const float*)qkvs_, *projs = (const float*)projs_;
  const float *fc1s = (const float*)fc1s_, *fc2s = (const float*)fc2s_;
  const int8_t *qkvw = (const int8_t*)qkvw_, *projw = (const int8_t*)projw_;
  const int8_t *fc1w = (const int8_t*)fc1w_, *fc2w = (const int8_t*)fc2w_;
  const int M = B * S, half = inter / G;
  const dim3 agrid((S + AT_T - 1) / AT_T, heads, B);
  int err;
  for (int l = 0; l < L; ++l) {
    const size_t lc = (size_t)l * C, li = (size_t)l * inter;
    const int8_t* w2 = fc2w + (size_t)l * inter * C;
    if ((err = w8a8::quantize(x, 1, M, C, 1, ln1w + lc, ln1b + lc, eps, aq, am, st)) ||
        (err = w8a8::gemm(w8a8::EPI_BIAS_F32, 0, aq, C, am, 1,
                    qkvw + (size_t)l * C * 3 * C, qkvs + 3 * lc, M, 3 * C, C,
                    qkvb + 3 * lc, nullptr, nullptr, qkv, nullptr, st)))
      return err;
    qkv_prep_kernel<<<M, 256, 0, st>>>(qkv, qnw + lc, knw + lc, qb, kb, vb, C,
                                       eps, qk_norm, qscale);
    RETURN_IF_ERR();
    attention_kernel<<<agrid, 128, 0, st>>>(qb, kb, vb, attn, S, C);
    RETURN_IF_ERR();
    if ((err = w8a8::quantize(attn, 1, M, C, 1, nullptr, nullptr, 0.f, aq, am, st)) ||
        (err = w8a8::gemm(w8a8::EPI_BIAS_LS_RESIDUAL, 0, aq, C, am, 1,
                    projw + (size_t)l * C * C, projs + lc, M, C, C, projb + lc,
                    nullptr, ls1 + lc, nullptr, x, st)) ||
        (err = w8a8::quantize(x, 1, M, C, 1, ln2w + lc, ln2b + lc, eps, aq, am, st)) ||
        (err = w8a8::gemm(w8a8::EPI_BIAS_GELU_F32, 0, aq, C, am, 1,
                    fc1w + (size_t)l * C * inter, fc1s + li, M, inter, C,
                    fc1b + li, nullptr, nullptr, mid, nullptr, st)) ||
        (err = w8a8::quantize(mid, 0, M, inter, G, nullptr, nullptr, 0.f, aq, am, st)))
      return err;
    if (G == 1) {
      err = w8a8::gemm(w8a8::EPI_BIAS_LS_RESIDUAL, 0, aq, inter, am, 1, w2,
                 fc2s + lc, M, C, inter, fc2b + lc, nullptr, ls2 + lc, nullptr,
                 x, st);
    } else {  // part = fc2b + half 0; x += bf16(part + half 1) * ls2
      err = w8a8::gemm(w8a8::EPI_BIAS_F32, 0, aq, inter, am, 2, w2, fc2s + lc, M,
                 C, half, fc2b + lc, nullptr, nullptr, part, nullptr, st);
      if (!err)
        err = w8a8::gemm(w8a8::EPI_BIAS_LS_RESIDUAL, 0, aq + half, inter, am + 1, 2,
                   w2 + (size_t)half * C, fc2s + lc, M, C, half, nullptr, part,
                   ls2 + lc, nullptr, x, st);
    }
    if (err) return err;
  }
  return 0;
}
