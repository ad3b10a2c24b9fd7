// w8a8 on Hopper: a per-row int8 activation quantizer and an int8
// tensor-core GEMM with a rescale epilogue.
//
// Replaces: vlaser_tpu/models/layers.py :: w8a8_dot (XLA: per-token int8
// quant, int8 x int8 -> int32 dot, fp32 rescale; under jit XLA merges the
// identical quantizations of q/k/v's and gate/up's input and fuses silu(g)
// * u of vlaser_tpu/models/qwen2.py:162 into the down projection's) and the
// act_quant `dot` of vlaser_tpu/kernels/fused_vit.py :: fused_vit_stack
// (fused_vit.py:150-168). Both compute the same thing, so both call the
// kernels here (fused_vit.cu through the launchers of w8a8.cuh).
//
// What bounds it on the H100: the GEMM, by the int8 tensor cores (1,979
// TOP/s dense) at 3,072+ rows (the VLA's batch-8 prefix, the chat prefill,
// the 13-tile ViT: thousands of ops per weight byte), and by reading the
// weights at 384 rows (~770 ops per weight byte against the ~590 op/byte
// ridge, but a layer's 7 GEMMs are then ~21 us of work that a launch per
// GEMM and a small grid leave far from either roof). The quantizer is a
// bandwidth pass (read x once, write 1 byte an element), and at 384 rows a
// launch-latency one.
//
// The quantizer: one DRAM pass. A row (or one of its G column groups,
// which are contiguous: [M, K] in G groups is [M * G, K / G]) belongs to
// `tpr` threads, a warp or more; each thread loads its chunks of 8 values
// (one 16-byte load of bf16, two of fp32) once, all before any is used,
// and keeps them in registers through the amax and the quantize steps.
// The amax (and the LayerNorm's sums) reduce by warp shuffles, then, where
// a row spans several warps, one step through shared memory; the int8
// results go out as 8-byte stores. Two kernels:
// - quantize_packed_kernel, bf16 rows (the w8a8 Dense's inputs, the ViT's
//   attention output): the words stay packed bf16 (4 registers a chunk) and
//   the amax is a bf16 max, exact. Optional silu-mul prologue: h =
//   bf16(bf16(silu(g)) * u) from two bf16 inputs (the down projection of a
//   SiLU MLP; silu = g / (1 + expf(-g)) in fp32 with IEEE division, as
//   PyTorch's CUDA silu), h never written to memory. A max is the same in
//   any order, so the layout follows M too: where rows are few, a row
//   spreads over more warps (up to 512 threads) so that each thread's
//   chain of loads, silu and stores is short.
// - quantize_kernel, fp32 rows (the ViT's fc2 input) and the LayerNorm
//   prologue (the act_quant ViT's LN1 / LN2; fp32, var = E[x^2] - mean^2,
//   the normed value not rounded to bf16): tpr is a function of the row
//   length alone, so a row's sums are taken in the same order at any M.
// The conversions per value (float -> bf16, the rounding to int8) run as
// fp32 and integer ops, not cvt instructions, which issue at a quarter of
// the fp32 rate: the silu-mul pass does ~30 operations a value, and with
// two of them on the quarter-rate pipe already (ex2, rcp) it is close to
// bound by arithmetic, not bytes.
//
// The GEMM: int8 wgmma (m64nNk32 .s32.s8.s8, int32 accumulators in
// registers) fed by TMA. int8 wgmma reads both operands K-major only (its
// transpose bit exists for 16-bit types alone), so B is the weight stored
// [N, K] (`kernel_qt` of models/layers.py, the act_quant ViT's packed
// weights), row stride ldb; A is the activation [M, K], row stride lda.
// A block owns a 128 x BN output tile (BN 256, or 128 where that fills the
// 132 SMs in fewer waves): one producer thread issues TMA loads of 128-byte
// k-blocks of A and B (128-byte swizzle, TMA zero-fills past K and past the
// last row, so ragged M and N need no copies) into a ring of 4 (BN 256) or
// 6 (BN 128) stages handed over by full / empty mbarriers; two consumer
// warpgroups each own 64 rows and keep one product group in flight while
// the next stage lands. A grid under half a wave (384 rows into N = 256
// or 1536) splits K across blocks; the splits write int32 partials, which a
// second kernel sums (integers: exact in any order, so no bit moves) before
// the one epilogue of each output: no two blocks ever run the epilogue of
// one output, which matters for the in-place residual update. The plan
// (tile width, splits) is a function of (M, N, K) alone.
//
// The epilogue runs from registers: the row scale (amax / 127) and the
// column (weight) scale in the order the JAX function uses, then one of the
// five modes of w8a8.cuh, with __fmul_rn / __fadd_rn so that no FMA
// contraction changes a rounding: given the same int8 rows, the products
// equal the plain version's (float64, exact) bit for bit.
#include "sm90.cuh"
#include "w8a8.cuh"

namespace w8a8 {

using namespace sm90;

constexpr int SMS = 132;
constexpr int BM = 128, BK = 128;  // tile rows, bytes (values) of K a stage
constexpr int WG = 128;            // threads of a warpgroup
constexpr int GEMM_THREADS = 3 * WG;  // two consumer warpgroups + producer
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int STAGE_BUDGET = 192 * 1024;  // shared memory of the ring
constexpr int MAX_SPLIT = 16;

// -- the activation quantizer --------------------------------------------------
constexpr int QBLOCK = 256;  // threads of a block of quantize_kernel, at most
constexpr int QNV = 6;       // its chunks a thread the layout aims at
constexpr int QMAX_NV = 8;   // ... at most (rows up to 16,384 values)
constexpr int PBLOCK = 512;  // threads of a block of quantize_packed_kernel
constexpr int PMAX_NV = 4;   // its chunks a thread, at most (16,384 values)
constexpr int FILL = 1024 * SMS;  // threads that keep the card's loads in flight

__device__ __forceinline__ void qload8(const bf16* p, float v[8]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void qload8(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// round_half_even(v * inv), |v * inv| <= 127.5, as the low byte of a word:
// RN(t + 1.5 * 2^23) is 1.5 * 2^23 + round_half_even(t) (the ulp there is 1
// and 1.5 * 2^23 is even), and its bits are 0x4b400000 + that integer.
__device__ __forceinline__ uint32_t q1(float v, float inv) {
  return __float_as_uint(__fadd_rn(__fmul_rn(v, inv), 12582912.f));
}

// 8 values -> round_half_even(v * inv) as int8, stored as one 8-byte word.
__device__ __forceinline__ void qstore8(int8_t* p, const float v[8],
                                        float inv) {
  uint32_t w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* f = v + 4 * h;
    w[h] = __byte_perm(__byte_perm(q1(f[0], inv), q1(f[1], inv), 0x0040),
                       __byte_perm(q1(f[2], inv), q1(f[3], inv), 0x0040),
                       0x5410);
  }
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// x rounded to bf16 (half to even) in the high half of the word, the low
// half zero: a float whose value is that bf16 (finite x or a quiet NaN).
__device__ __forceinline__ uint32_t bf16_hi(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
}

// PyTorch's CUDA silu on a bf16 tensor: x / (1 + exp(-x)) in fp32 (expf,
// IEEE division), rounded to bf16.
__device__ __forceinline__ float silu_bf16(float x) {
  return __uint_as_float(bf16_hi(__fdiv_rn(x, __fadd_rn(1.f, expf(-x)))));
}

// Sum (or max) over the tpr threads of one row, tpr a multiple of 32 and the
// same for the whole block: shuffles, then one step through red[] when the
// row spans several warps. Every thread gets the result.
template <bool MAX>
__device__ __forceinline__ float row_reduce(float v, float* red, int tpr) {
  v = MAX ? warp_max(v) : warp_sum(v);
  if (tpr == 32) return v;
  const int warp = threadIdx.x >> 5, wpr = tpr >> 5, first = warp - warp % wpr;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float r = red[first];
  for (int i = 1; i < wpr; ++i)
    r = MAX ? fmaxf(r, red[first + i]) : r + red[first + i];
  return r;
}

// bf16 rows (SILU: the rows of h = bf16(bf16(silu(g)) * u), g = x), kept in
// registers as loaded: NV 16-byte words of 8 bf16 a thread. Block of tpr *
// (rows a block) threads; row = blockIdx.x * rows + threadIdx.x / tpr, K %
// 8 == 0; thread t of a row holds chunks t, t + tpr, ... (those past K / 8
// are empty). The amax is exact in any order, so the layout may follow M.
// am = max(max|h|, 1e-9), q = round_half_even(h * (127 / am)).
template <bool SILU, int NV>
__global__ void __launch_bounds__(PBLOCK)
quantize_packed_kernel(const bf16* __restrict__ x, const bf16* __restrict__ u,
                       int M, int K, int tpr, int8_t* __restrict__ q,
                       float* __restrict__ am) {
  __shared__ float red[PBLOCK / 32];
  const int sub = threadIdx.x / tpr, t = threadIdx.x - sub * tpr;
  const size_t row = (size_t)blockIdx.x * (blockDim.x / tpr) + sub;
  const bool live = row < (size_t)M;
  const int nch = K >> 3;
  uint4 h[NV], w[SILU ? NV : 1];
#pragma unroll
  for (int c = 0; c < NV; ++c) {  // every load issued before any use
    const int ch = t + c * tpr;
    h[c] = w[SILU ? c : 0] = make_uint4(0u, 0u, 0u, 0u);
    if (live && ch < nch) {
      h[c] = __ldg(reinterpret_cast<const uint4*>(x + row * K) + ch);
      if (SILU) w[c] = __ldg(reinterpret_cast<const uint4*>(u + row * K) + ch);
    }
  }
  __nv_bfloat162 m2 = __float2bfloat162_rn(0.f);
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    uint32_t* hw = reinterpret_cast<uint32_t*>(&h[c]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (SILU) {  // zeros stay zero: silu(0) * 0
        const uint32_t g = hw[i], uw = reinterpret_cast<const uint32_t*>(
                                          &w[c])[i];
        const uint32_t lo = bf16_hi(__fmul_rn(
            silu_bf16(__uint_as_float(g << 16)), __uint_as_float(uw << 16)));
        const uint32_t hi = bf16_hi(
            __fmul_rn(silu_bf16(__uint_as_float(g & 0xffff0000u)),
                      __uint_as_float(uw & 0xffff0000u)));
        hw[i] = __byte_perm(lo, hi, 0x7632);
      }
      m2 = __hmax2(m2, __habs2(reinterpret_cast<__nv_bfloat162*>(hw)[i]));
    }
  }
  const float2 mf = __bfloat1622float2(m2);
  const float a =
      fmaxf(row_reduce<true>(fmaxf(mf.x, mf.y), red, tpr), 1e-9f);
  const float inv = __fdiv_rn(127.f, a);
  if (!live) return;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int ch = t + c * tpr;
    if (ch >= nch) continue;
    float v[8];
    const uint32_t* hw = reinterpret_cast<const uint32_t*>(&h[c]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(hw[i] << 16);
      v[2 * i + 1] = __uint_as_float(hw[i] & 0xffff0000u);
    }
    qstore8(q + row * K + ch * 8, v, inv);
  }
  if (t == 0) am[row] = a;
}

// fp32 rows, or (LN) the fp32 LayerNorm of bf16 or fp32 rows, held in
// registers as fp32: NV chunks of 8 a thread, laid out as in
// quantize_packed_kernel. tpr follows K alone, so a row's LayerNorm sums
// run in one order at any M. LN: v = (x - mean) * rsqrt(var + eps) * w + b
// in fp32 (var = E[x^2] - mean^2, as the TPU kernel's _layer_norm).
template <typename T, bool LN, int NV>
__global__ void __launch_bounds__(QBLOCK)
quantize_kernel(const T* __restrict__ x, int M, int K, int tpr,
                const float* __restrict__ lnw, const float* __restrict__ lnb,
                float eps, int8_t* __restrict__ q, float* __restrict__ am) {
  __shared__ float red[3][32];
  const int sub = threadIdx.x / tpr, t = threadIdx.x - sub * tpr;
  const size_t row = (size_t)blockIdx.x * (blockDim.x / tpr) + sub;
  const bool live = row < (size_t)M;
  const int nch = K >> 3;
  float v[NV][8];
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int ch = t + c * tpr;
    if (live && ch < nch) {
      qload8(x + row * K + ch * 8, v[c]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[c][e] = 0.f;
    }
  }
  if (LN) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += v[c][e];
        ss += v[c][e] * v[c][e];
      }
    s = row_reduce<false>(s, red[0], tpr);
    ss = row_reduce<false>(ss, red[1], tpr);
    const float mean = s / K, r = rsqrtf(ss / K - mean * mean + eps);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int ch = t + c * tpr;
      if (!live || ch >= nch) continue;
      float w[8], b[8];
      qload8(lnw + ch * 8, w);
      qload8(lnb + ch * 8, b);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[c][e] = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(v[c][e], mean), r), w[e]), b[e]);
    }
  }
  float m = 0.f;
#pragma unroll
  for (int c = 0; c < NV; ++c)
    if (t + c * tpr < nch)
#pragma unroll
      for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[c][e]));
  const float a = fmaxf(row_reduce<true>(m, red[2], tpr), 1e-9f);
  const float inv = __fdiv_rn(127.f, a);
  if (!live) return;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int ch = t + c * tpr;
    if (ch < nch) qstore8(q + row * K + ch * 8, v[c], inv);
  }
  if (t == 0) am[row] = a;
}

// -- the int8 GEMM --------------------------------------------------------------
// What the epilogue reads and writes (see w8a8.cuh).
struct EpiArgs {
  const float* am;
  int am_stride, row_first;
  const float* s_col;
  const float* bias;
  const float* addm;
  const float* ls;
  float* out_f;
  bf16* out_b;
  int M, N;
};

// Two neighbouring outputs (row, col) and (row, col + 1) from their int32
// sums; a = am[row] / 127. The arithmetic is the plain version's, with
// __fmul_rn / __fadd_rn so that no FMA contraction moves a rounding.
template <int EPI>
__device__ __forceinline__ void store2(const EpiArgs& p, int row, float a,
                                       int col, int acc0, int acc1) {
  const int32_t acc[2] = {acc0, acc1};
  float v[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float accf = __int2float_rn(acc[e]);
    const float s = p.s_col[col + e];
    v[e] = p.row_first ? __fmul_rn(__fmul_rn(accf, a), s)
                       : __fmul_rn(accf, __fmul_rn(a, s));
  }
  const size_t o = (size_t)row * p.N + col;
  if (EPI == EPI_F32) {
    *reinterpret_cast<float2*>(p.out_f + o) = make_float2(v[0], v[1]);
  } else if (EPI == EPI_BF16) {
    *reinterpret_cast<__nv_bfloat162*>(p.out_b + o) =
        __floats2bfloat162_rn(v[0], v[1]);
  } else if (EPI == EPI_BIAS_F32) {
    *reinterpret_cast<float2*>(p.out_f + o) = make_float2(
        __fadd_rn(v[0], p.bias[col]), __fadd_rn(v[1], p.bias[col + 1]));
  } else if (EPI == EPI_BIAS_GELU_F32) {
    float y[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float t = __fadd_rn(v[e], p.bias[col + e]);
      y[e] = 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
    }
    *reinterpret_cast<float2*>(p.out_f + o) = make_float2(y[0], y[1]);
  } else {  // x = bf16(x + bf16(v + bias or addm) * ls), in place
    const float2 xv =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.out_b + o));
    const float xs[2] = {xv.x, xv.y};
    float y[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float t = __fadd_rn(v[e], p.addm ? p.addm[o + e] : p.bias[col + e]);
      y[e] = __fadd_rn(xs[e], __fmul_rn(bf(t), p.ls[col + e]));
    }
    *reinterpret_cast<__nv_bfloat162*>(p.out_b + o) =
        __floats2bfloat162_rn(y[0], y[1]);
  }
}

template <int BN>
struct GemmL {
  static constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int NST = STAGE_BUDGET / STAGE;  // 4 at BN 256, 6 at 128
  static constexpr int BAR_OFF = NST * STAGE;
  static constexpr int BYTES = BAR_OFF + 2 * NST * 8 + 1024;  // + alignment
};

// Descriptor of k-step kk (32 bytes of K) of a K-major int8 tile whose rows
// are 128-byte swizzle rows (8 rows: 1024 bytes).
__device__ __forceinline__ uint64_t kdesc(const unsigned char* tile, int kk) {
  return desc(tile + 32 * kk, 16, 1024, 1);
}

// grid (N tiles, M tiles, K splits). Warpgroups 0 and 1 consume (64 rows
// each of the 128-row tile, BN columns, int32 accumulators in registers);
// warpgroup 2's first thread produces: TMA loads of the A and B tiles of
// each 128-byte k-block of this split into a ring of NST stages, handed over
// by full / empty mbarriers. One product group stays in flight while the
// next stage is awaited. Then either the epilogue from registers (one split)
// or the int32 partial sums into ws[split] (summed by epilogue_kernel).
template <int EPI, int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb, const EpiArgs p,
                int kblocks, int kb_per_split, int32_t* __restrict__ ws) {
  using L = GemmL<BN>;
  constexpr int NST = L::NST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  uint64_t* empty = full + NST;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kb0 = blockIdx.z * kb_per_split;
  const int nk = min(kblocks, kb0 + kb_per_split) - kb0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);  // the producer's expect_tx
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * WG) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 2 * WG) {
      for (int n = 0; n < nk; ++n) {
        const int s = n % NST, k0 = (kb0 + n) * BK;
        unsigned char* st = sm + s * L::STAGE;
        mbar_wait(&empty[s], ((n / NST) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::STAGE);
        tma_load_2d(st, &ta, &full[s], k0, m0);
        tma_load_2d(st + L::A_BYTES, &tb, &full[s], k0, n0);
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    int32_t acc[BN / 2];
    for (int n = 0; n < nk; ++n) {
      const int s = n % NST;
      const unsigned char* as = sm + s * L::STAGE + wg * 64 * BK;
      const unsigned char* bs = sm + s * L::STAGE + L::A_BYTES;
      mbar_wait(&full[s], (n / NST) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        MmaS8<BN>::ss(acc, kdesc(as, kk), kdesc(bs, kk), n > 0 || kk > 0);
      wg_commit();
      wg_wait<1>();  // stage n - 1's products are done: hand it back
      if (n > 0 && lane == 0) mbar_arrive(&empty[(n - 1) % NST]);
    }
    wg_wait_all();
    fence_regs(acc);

    const float inv127 = (float)(1.0 / 127.0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wg * 64 + warp * 16 + g + 8 * h;
      if (row >= p.M) continue;
      if (gridDim.z > 1) {
        int32_t* pr = ws + ((size_t)blockIdx.z * p.M + row) * p.N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          if (col < p.N)
            *reinterpret_cast<int2*>(pr + col) =
                make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      } else {
        const float a = __fmul_rn(p.am[(size_t)row * p.am_stride], inv127);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          if (col < p.N)
            store2<EPI>(p, row, a, col, acc[4 * j + 2 * h],
                        acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// The epilogue of a split GEMM: each thread sums the splits' int32 partials
// of two neighbouring outputs (exact in any order) and stores them.
template <int EPI>
__global__ void __launch_bounds__(256)
    epilogue_kernel(const int32_t* __restrict__ ws, int splits,
                    const EpiArgs p) {
  const size_t i = 2 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  const size_t mn = (size_t)p.M * p.N;
  if (i >= mn) return;
  const int row = (int)(i / p.N), col = (int)(i % p.N);
  int2 acc = make_int2(0, 0);
  for (int s = 0; s < splits; ++s) {
    const int2 v = *reinterpret_cast<const int2*>(ws + s * mn + i);
    acc.x += v.x;
    acc.y += v.y;
  }
  const float a = __fmul_rn(p.am[(size_t)row * p.am_stride],
                            (float)(1.0 / 127.0));
  store2<EPI>(p, row, a, col, acc.x, acc.y);
}

// -- host: the plan, tensor maps, launches ------------------------------------
static int cdiv(int a, int b) { return (a + b - 1) / b; }

// Tile width and K splits of a GEMM, from its shape alone: the width whose
// waves of tiles cost least (a 128-wide tile is taken as 9/8 of half a
// 256-wide one's time). A grid of less than half a wave takes 128-wide
// tiles, and if that is still under half a wave it splits K (int32
// partials, summed exactly) until the grid is about half a wave: on an
// H100 more splits cost more in partial sums than they win in parallel
// weight reads (384 rows into N = 256 / 1536 / 8960, 3,072-3,584 rows into
// N = 256 and 1,025 rows into N = 1024, timed at 1-16 splits).
struct Plan {
  int bn, splits, kb_per;
};
static Plan plan_of(int M, int N, int K) {
  const int mt = cdiv(M, BM), kb = cdiv(K, BK), half = SMS / 2;
  const long c256 = (long)cdiv(mt * cdiv(N, 256), SMS) * 256 * 8;
  const long c128 = (long)cdiv(mt * cdiv(N, 128), SMS) * 128 * 9;
  int bn = c256 <= c128 ? 256 : 128;
  int splits = 1;
  if (mt * cdiv(N, bn) < half) {
    bn = 128;
    const int tiles = mt * cdiv(N, 128);
    if (tiles < half) splits = min(min(cdiv(half, tiles), kb), MAX_SPLIT);
  }
  const int per = cdiv(kb, splits);
  return {bn, cdiv(kb, per), per};
}

size_t gemm_ws_elems(int M, int N, int K) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  const Plan pl = plan_of(M, N, K);
  return pl.splits > 1 ? (size_t)pl.splits * M * N : 0;
}

// A K-major int8 matrix [rows, K] with row stride ld (bytes), boxes of
// 128 bytes of K x box rows, 128-byte swizzle (TMA zero-fills past K and
// past the last row); sm90.cuh encodes and caches it.
static int kmajor_map(CUtensorMap* map, const void* ptr, int K, int rows,
                      int ld, int box) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || ld % 16 || ld < K)
    return (int)cudaErrorInvalidValue;
  TmapArgs a{};
  a.ptr = ptr;
  a.dtype = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  a.rank = 2;
  a.swizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  a.l2 = CU_TENSOR_MAP_L2_PROMOTION_L2_256B;
  a.dims[0] = K;
  a.dims[1] = rows;
  a.strides[0] = ld;
  a.box[0] = BK;
  a.box[1] = box;
  return tmap_encode(map, a);
}

template <int EPI, int BN>
static int launch(const CUtensorMap& ta, const CUtensorMap& tb,
                  const EpiArgs& p, const Plan& pl, int kb, int32_t* ws,
                  cudaStream_t st) {
  using L = GemmL<BN>;
  static const int attr = set_smem(gemm_kernel<EPI, BN>, L::BYTES);
  if (attr) return attr;
  const dim3 grid(cdiv(p.N, BN), cdiv(p.M, BM), pl.splits);
  gemm_kernel<EPI, BN><<<grid, GEMM_THREADS, L::BYTES, st>>>(ta, tb, p, kb,
                                                             pl.kb_per, ws);
  RETURN_IF_ERR();
  return 0;
}

template <int EPI>
static int gemm_t(const int8_t* A, int lda, const int8_t* B, int ldb, int K,
                  const EpiArgs& p, int32_t* ws, size_t ws_elems,
                  cudaStream_t st) {
  const Plan pl = plan_of(p.M, p.N, K);
  if (pl.splits > 1 && (!ws || ws_elems < (size_t)pl.splits * p.M * p.N))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (int e = kmajor_map(&ta, A, K, p.M, lda, BM)) return e;
  if (int e = kmajor_map(&tb, B, K, p.N, ldb, pl.bn)) return e;
  const int kb = cdiv(K, BK);
  if (int e = pl.bn == 256 ? launch<EPI, 256>(ta, tb, p, pl, kb, ws, st)
                           : launch<EPI, 128>(ta, tb, p, pl, kb, ws, st))
    return e;
  if (pl.splits > 1) {
    const size_t pairs = (size_t)p.M * p.N / 2;
    epilogue_kernel<EPI><<<(unsigned)((pairs + 255) / 256), 256, 0, st>>>(
        ws, pl.splits, p);
    RETURN_IF_ERR();
  }
  return 0;
}

int gemm(int epi, int row_first, const int8_t* A, int lda, const float* am,
         int am_stride, const int8_t* B, int ldb, const float* s_col, int M,
         int N, int K, const float* bias, const float* addm, const float* ls,
         float* out_f, bf16* out_b, int32_t* ws, size_t ws_elems,
         cudaStream_t st) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 16 || lda % 16 ||
      ldb % 16)
    return (int)cudaErrorInvalidValue;
  const EpiArgs p{am, am_stride, row_first, s_col, bias, addm,
                  ls, out_f, out_b, M, N};
#define W8A8_GEMM(E) \
  case E:            \
    return gemm_t<E>(A, lda, B, ldb, K, p, ws, ws_elems, st)
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

// -- the probe: one 64-row tile, one TMA load of A [64, 128] and B [N, 128]
// (K-major), four s8 k-steps -> c [64, N] int32 --------------------------------
template <int N>
__global__ void __launch_bounds__(WG, 1)
    probe_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb, int32_t* c) {
  constexpr int A_BYTES = 64 * BK, BYTES = A_BYTES + N * BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1k(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + BYTES);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, BYTES);
    tma_load_2d(sm, &ta, bar, 0, 0);
    tma_load_2d(sm + A_BYTES, &tb, bar, 0, 0);
  }
  mbar_wait(bar, 0);
  int32_t acc[N / 2];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 32; ++kk)
    MmaS8<N>::ss(acc, kdesc(sm, kk), kdesc(sm + A_BYTES, kk), kk > 0);
  wg_commit();
  wg_wait_all();
  fence_regs(acc);
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
#pragma unroll
  for (int e = 0; e < N / 2; ++e)
    c[(warp * 16 + g + 8 * ((e >> 1) & 1)) * N + (e >> 2) * 8 + 2 * t +
      (e & 1)] = acc[e];
}

template <int N>
static int probe(const void* a, const void* b, void* c, cudaStream_t st) {
  constexpr int BYTES = 64 * BK + N * BK + 8 + 1024;
  static const int attr = set_smem(probe_kernel<N>, BYTES);
  if (attr) return attr;
  CUtensorMap ta, tb;
  if (int e = kmajor_map(&ta, a, BK, 64, BK, 64)) return e;
  if (int e = kmajor_map(&tb, b, BK, N, BK, N)) return e;
  probe_kernel<N><<<1, WG, BYTES, st>>>(ta, tb, (int32_t*)c);
  RETURN_IF_ERR();
  return 0;
}

// Rows a block: the most up to `most` threads that still leave two blocks an
// SM.
static int q_rows_a_block(int M, int tpr, int most) {
  int rpb = tpr >= most ? 1 : most / tpr;
  while (rpb > 1 && (M + rpb - 1) / rpb < 2 * SMS) rpb /= 2;
  return rpb;
}

#define Q_CASES(LAUNCH) \
  LAUNCH(1) LAUNCH(2) LAUNCH(3) LAUNCH(4) LAUNCH(5) LAUNCH(6) LAUNCH(7) LAUNCH(8)

// bf16 rows, plain or silu-mul: a row spreads over as many warps as leave
// a thread nv = clamp(M * (K / 8) / FILL, 1, most) chunks (few rows:
// short chains of work a thread), at most PBLOCK threads; most is PMAX_NV,
// or 3 for the silu-mul, whose arithmetic gains from more threads (3,584 x
// 8,960: 3 chunks a thread 3% faster than 4, 2 slower).
static int q_packed(const bf16* x, const bf16* u, int M, int K, int8_t* q,
                    float* am, cudaStream_t st) {
  const int nch = K / 8;
  const long long fill = (long long)M * nch / FILL;
  const int most = u ? 3 : PMAX_NV;
  const int want = fill < 1 ? 1 : fill > most ? most : (int)fill;
  int tpr = 32 * ((nch + 32 * want - 1) / (32 * want));
  if (tpr > PBLOCK) tpr = PBLOCK;
  const int rpb = q_rows_a_block(M, tpr, QBLOCK);
  const int nv = (nch + tpr - 1) / tpr;
  if (nv > PMAX_NV) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + rpb - 1) / rpb), block(tpr * rpb);
#define Q_LAUNCH(N)                                                       \
  case N:                                                                 \
    if (u)                                                                \
      quantize_packed_kernel<true, N><<<grid, block, 0, st>>>(x, u, M, K, \
                                                              tpr, q, am); \
    else                                                                  \
      quantize_packed_kernel<false, N><<<grid, block, 0, st>>>(x, u, M, K, \
                                                               tpr, q, am); \
    break;
  switch (nv) {
    Q_LAUNCH(1) Q_LAUNCH(2) Q_LAUNCH(3) Q_LAUNCH(4)
  }
#undef Q_LAUNCH
  RETURN_IF_ERR();
  return 0;
}

// fp32 rows or the LayerNorm: threads a row, the smallest power of two from
// 32 to QBLOCK that leaves a thread at most QNV chunks of 8 (K alone
// decides; rows up to QBLOCK x QMAX_NV chunks).
template <typename T>
static int q_fp32(const T* x, int M, int K, const float* lnw,
                  const float* lnb, float eps, int8_t* q, float* am,
                  cudaStream_t st) {
  const int nch = K / 8;
  int tpr = 32;
  while (tpr < QBLOCK && nch > tpr * QNV) tpr *= 2;
  const int rpb = q_rows_a_block(M, tpr, QBLOCK);
  const int nv = (nch + tpr - 1) / tpr;
  if (nv > QMAX_NV) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + rpb - 1) / rpb), block(tpr * rpb);
#define Q_LAUNCH(N)                                                        \
  case N:                                                                  \
    if (lnw)                                                               \
      quantize_kernel<T, true, N><<<grid, block, 0, st>>>(x, M, K, tpr, lnw, \
                                                          lnb, eps, q, am); \
    else                                                                   \
      quantize_kernel<T, false, N><<<grid, block, 0, st>>>(x, M, K, tpr,    \
                                                           lnw, lnb, eps, q, \
                                                           am);            \
    break;
  switch (nv) { Q_CASES(Q_LAUNCH) }
#undef Q_LAUNCH
  RETURN_IF_ERR();
  return 0;
}
#undef Q_CASES

// Both prologues (u: silu-mul, lnw / lnb: LayerNorm) or neither.
static int quantize_any(const void* x, const bf16* u, int x_bf16, int M,
                        int K, int G, const float* lnw, const float* lnb,
                        float eps, int8_t* q, float* am, cudaStream_t st) {
  const bool aligned = (uintptr_t)x % 16 == 0 && (uintptr_t)u % 16 == 0 &&
                       (uintptr_t)q % 8 == 0;
  if (M <= 0 || G < 1 || K % 16 || K % G || (K / G) % 8 || !aligned ||
      ((lnw || u) && G != 1) || (lnw && u) || (u && !x_bf16) ||
      (lnw && ((uintptr_t)lnw % 16 || (uintptr_t)lnb % 16)) ||
      (long long)M * G > (1ll << 31) - 1)
    return (int)cudaErrorInvalidValue;
  const int R = M * G, Kg = K / G;
  if (x_bf16 && !lnw) return q_packed((const bf16*)x, u, R, Kg, q, am, st);
  if (x_bf16)
    return q_fp32((const bf16*)x, R, Kg, lnw, lnb, eps, q, am, st);
  return q_fp32((const float*)x, R, Kg, lnw, lnb, eps, q, am, st);
}

int quantize(const void* x, int x_bf16, int M, int K, int G, const float* lnw,
             const float* lnb, float eps, int8_t* q, float* am,
             cudaStream_t st) {
  return quantize_any(x, nullptr, x_bf16, M, K, G, lnw, lnb, eps, q, am, st);
}

int quantize_silu_mul(const bf16* g, const bf16* u, int M, int K, int8_t* q,
                      float* am, cudaStream_t st) {
  return quantize_any(g, u, 1, M, K, 1, nullptr, nullptr, 0.f, q, am, st);
}

}  // namespace w8a8

// x [M, K] bf16 or fp32 -> q int8 [M, K], am fp32 [M, G] (G column groups).
extern "C" int w8a8_quantize_rows(const void* x, void* q, void* am, int M,
                                  int K, int G, int x_bf16, void* stream) {
  return w8a8::quantize(x, x_bf16, M, K, G, nullptr, nullptr, 0.f,
                        (int8_t*)q, (float*)am, (cudaStream_t)stream);
}

// g, u bf16 [M, K] -> the rows of h = bf16(bf16(silu(g)) * u): q int8 [M,
// K], am fp32 [M]; h is never stored.
extern "C" int w8a8_quantize_silu_mul(const void* g, const void* u, void* q,
                                      void* am, int M, int K, void* stream) {
  return w8a8::quantize_silu_mul((const bf16*)g, (const bf16*)u, M, K,
                                 (int8_t*)q, (float*)am,
                                 (cudaStream_t)stream);
}

// The LayerNorm prologue alone (the act_quant ViT's LN1 / LN2, which
// fused_vit.cu runs in its layer loop), for tests: x [M, K] bf16 or fp32,
// lnw / lnb fp32 [K] -> q int8 [M, K], am fp32 [M].
extern "C" int w8a8_quantize_ln_rows(const void* x, const void* lnw,
                                     const void* lnb, void* q, void* am, int M,
                                     int K, int x_bf16, float eps,
                                     void* stream) {
  return w8a8::quantize(x, x_bf16, M, K, 1, (const float*)lnw,
                        (const float*)lnb, eps, (int8_t*)q, (float*)am,
                        (cudaStream_t)stream);
}

// y [M, N] (fp32, or bf16 if out_bf16) = (float(qa @ kt^T) * (am / 127)) *
// ks: the rescale order of models/layers.py w8a8_dot. kt is the weight
// K-major [N, K]; ws: int32 scratch of w8a8_gemm_workspace(M, N, K)
// elements (none needed when that is 0).
extern "C" int w8a8_gemm_rows(const void* qa, const void* am, const void* kt,
                              const void* ks, void* out, void* ws, int M,
                              int N, int K, int out_bf16, long long ws_elems,
                              void* stream) {
  return w8a8::gemm(out_bf16 ? w8a8::EPI_BF16 : w8a8::EPI_F32, 1,
                    (const int8_t*)qa, K, (const float*)am, 1,
                    (const int8_t*)kt, K, (const float*)ks, M, N, K, nullptr,
                    nullptr, nullptr, (float*)out, (bf16*)out, (int32_t*)ws,
                    (size_t)ws_elems, (cudaStream_t)stream);
}

// int32 elements of scratch the GEMM of (M, N, K) needs (0: none).
extern "C" long long w8a8_gemm_workspace(int M, int N, int K) {
  return (long long)w8a8::gemm_ws_elems(M, N, K);
}

// w8a8::gemm with every option (w8a8.cuh): the epilogue modes, strides and
// the row-scale stride of the act_quant ViT's products.
extern "C" int w8a8_gemm_general(
    const void* A, const void* am, const void* B, const void* s_col,
    const void* bias, const void* addm, const void* ls, void* out_f,
    void* out_b, void* ws, int epi, int row_first, int lda, int am_stride,
    int ldb, int M, int N, int K, long long ws_elems, void* stream) {
  return w8a8::gemm(epi, row_first, (const int8_t*)A, lda, (const float*)am,
                    am_stride, (const int8_t*)B, ldb, (const float*)s_col, M,
                    N, K, (const float*)bias, (const float*)addm,
                    (const float*)ls, (float*)out_f, (bf16*)out_b,
                    (int32_t*)ws, (size_t)ws_elems, (cudaStream_t)stream);
}

// Dynamic shared memory of the GEMM kernel at tile width bn (-1: none).
extern "C" int w8a8_gemm_smem(int bn) {
  return bn == 256 ? w8a8::GemmL<256>::BYTES
                   : bn == 128 ? w8a8::GemmL<128>::BYTES : -1;
}

// The probe tile: a [64, 128] x b [n, 128] (int8, K-major) -> c [64, n]
// int32 through one TMA load each and four s8 wgmma k-steps; n 128 or 256.
extern "C" int w8a8_s8_probe(const void* a, const void* b, void* c, int n,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return n == 256 ? w8a8::probe<256>(a, b, c, st)
                  : n == 128 ? w8a8::probe<128>(a, b, c, st)
                             : (int)cudaErrorInvalidValue;
}

// The tensor-map cache of sm90.cuh, which every TMA kernel of the library
// shares: enable 1 turns it on, 0 off (and empties it), -1 leaves it.
// stats <- hits, misses (encodes), maps held, on; counted since load.
extern "C" int sm90_tmap_cache(int enable, long long* stats) {
  sm90::TmapCache& c = sm90::tmap_cache();
  std::lock_guard<std::mutex> lock(c.mu);
  if (enable >= 0) c.on = enable != 0;
  if (!c.on) c.maps.clear();
  stats[0] = c.hits;
  stats[1] = c.misses;
  stats[2] = (long long)c.maps.size();
  stats[3] = c.on;
  return 0;
}
