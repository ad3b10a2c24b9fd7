// w8a8 on Hopper: a per-row int8 activation quantizer and an int8
// tensor-core GEMM with a rescale epilogue.
//
// Replaces: vlaser_tpu/models/layers.py :: w8a8_dot (XLA: per-token int8
// quant, int8 x int8 -> int32 dot, fp32 rescale) and the act_quant `dot` of
// vlaser_tpu/kernels/fused_vit.py :: fused_vit_stack (fused_vit.py:150-168).
// Both compute the same thing, so both call the two kernels here
// (fused_vit.cu through the launchers of w8a8.cuh).
//
// What bounds it on the H100: the GEMM, by the int8 tensor cores (1,979
// TOP/s dense) at 3,072+ rows (the VLA's batch-8 prefix, the chat prefill,
// the 13-tile ViT: thousands of ops per weight byte), and by reading the
// weights at 384 rows (~770 ops per weight byte against the ~590 op/byte
// ridge, but a layer's 7 GEMMs are then ~21 us of work that a launch per
// GEMM and a small grid leave far from either roof). The quantizer is a
// bandwidth pass (read x once, write 1 byte an element).
//
// The quantizer: one block per (row, column group), two passes over the
// row (amax, then quantize; LayerNorm recomputed in fp32 in each, not
// rounded to bf16).
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

constexpr int QTHREADS = 256;
constexpr int SMS = 132;
constexpr int BM = 128, BK = 128;  // tile rows, bytes (values) of K a stage
constexpr int WG = 128;            // threads of a warpgroup
constexpr int GEMM_THREADS = 3 * WG;  // two consumer warpgroups + producer
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int STAGE_BUDGET = 192 * 1024;  // shared memory of the ring
constexpr int MAX_SPLIT = 16;

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
