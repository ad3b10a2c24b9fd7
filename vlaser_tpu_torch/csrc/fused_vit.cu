// InternViT encoder stack for Hopper (bf16 weights, or int8 act_quant).
//
// Replaces: vlaser_tpu/kernels/fused_vit.py :: fused_vit_stack (the Pallas
// kernel built by _make_kernel; pallas_call at fused_vit.py:498), both modes.
//
// What bounds it on the H100: at the serving shape (B=1, S=1025 tokens,
// hidden 1024, 16 heads x 64, inter 4096, 24 layers) the layer is ~26 GFLOP
// of matmul against ~25 MB of bf16 weights: ~1000 FLOP per weight byte, far
// above the ~295 FLOP/byte ridge, so the tensor cores bound it. Attention is
// ~4.3 GFLOP per layer and sample at head_dim 64 (a short contraction: the
// softmax, not the tensor cores, is its limit); the norms and the
// activation epilogues are bandwidth-bound passes over [S, hidden] bf16.
//
// What the design does about it (sm_90a):
// - bf16 mode's products are a warpgroup GEMM: one producer thread keeps a
//   ring of TMA loads (A [M, K] K-major, the JAX [K, N] weight read in place
//   as wgmma's transposed, MN-major B; 128-byte swizzle, TMA zero-fills the
//   ragged M, N and K edges) in flight, two consumer warpgroups each own 64
//   rows of a 128 x BN tile (BN 128 or 256, whichever costs fewer waves of
//   132 SMs; no split-K: a 1,025-row product into N = 1,024 runs 72 blocks)
//   and keep one k-block of wgmma in flight. The epilogue runs from
//   registers and fuses what the TPU kernel fused: the bias, the exact erf
//   GELU with the bf16 store that feeds fc2, and the layer-scale + residual
//   update with the bf16 rounding of fused_vit.py:390-394,426-430
//   (__fadd_rn / __fmul_rn: no FMA contraction moves a rounding).
// - Attention is one pass over the keys under the TPU kernel's shift
//   (fused_vit.py:229-245, 270-280, 374-381): no row max, no rescale. The
//   qkv prep writes q (x head_dim^-0.5 * log2 e) and k rounded to bf16, and
//   beside them ||q_h||^2 per row and head and max_r ||k_h||^2 per sample and
//   head (an atomicMax on the float's bits: non-negative floats order as
//   their bits do), both in fp32 from the bf16 values. The attention kernel
//   shifts every score of a row by m = sqrt(||q||^2 max ||k||^2 + 1e-12),
//   which no score exceeds (Cauchy-Schwarz), takes e = bf16(exp2(s - m)),
//   sums d over the rounded e in fp32 and multiplies the [S, 64] output by
//   1 / d before its bf16 store. Keys past S are masked in registers (e =
//   0), the TPU's closed-form `d - npad * 2^-m` in another form. Where the
//   bound lies far above a row's largest score, the TPU kernel's exponents
//   underflow (d = 0, a NaN row): a block with a row whose d ends below
//   MIN_D (2^-100) walks the keys twice more, once for each row's largest
//   score and once as before with those rows shifted by it (the producer
//   loads the keys again after the consumers' decision). The kernel is
//   the flash forward's design at D 64 (csrc/flash_attention.cu, FwdL<64>):
//   grid (query tiles of 192, 16 heads, B), a producer warp keeps a TMA +
//   mbarrier ring of 64-key K/V tiles in flight, three consumer warpgroups
//   run S = Q.K^T from shared memory and O += P.V with P (e packed to bf16
//   pairs, d summed from the packed halves) from registers and V read
//   MN-major. q/k/v stay [B*S, hidden] row-major, read through 4-d
//   tensor maps [B, S, heads, 64] that zero-fill each sample's ragged edge.
// - LayerNorm (fp32 statistics, bf16 out) is a row kernel; the host loops
//   over layers in C (one ctypes call per stack).
//
// act_quant (w8a8) mode, vit_stack_forward_w8a8: the same layer loop with
// int8 weights, packed K-major [L, N, K] (the int8 wgmma reads both operands
// K-major). Each of qkv / proj / fc1 / fc2 quantizes its activation rows to
// int8 (w8a8.cu's quantizer; LayerNorm fused in fp32 for qkv and fc1, the
// fp32 GELU output for fc2, the bf16 attention output for proj) and runs
// w8a8.cu's int8 GEMM (wgmma s8 fed by TMA), whose epilogue rescales by
// (row amax / 127) * column scale and then adds the bias, applies GELU or
// the layer-scale residual as above. Attention is the bf16 kernel above. At
// B > 1 the TPU kernel runs the MLP in two halves of `inter` and quantizes
// fc2's input per half; here fc2 is two GEMMs over the two halves of K
// (column slices of fc2's [C, inter] rows, row stride inter), the first
// writing fc2b + half 0 in fp32, the second adding half 1 before the
// residual: the same groups and order.
#include <algorithm>

#include "common.cuh"
#include "sm90.cuh"
#include "w8a8.cuh"

namespace vit {

using namespace sm90;

constexpr int WG = 128;     // threads of a warpgroup
constexpr int HD = 64;      // head_dim
constexpr int ROWB = 128;   // bytes of a swizzle row (64 bf16)
constexpr int SMS = 132;

enum { EPI_BIAS_F32 = 0, EPI_BIAS_GELU_BF16 = 1, EPI_BIAS_LS_RESIDUAL = 2 };

// mbar_wait that traps after ~10^10 cycles: a lost TMA transaction then
// fails the launch instead of hanging the device.
__device__ __forceinline__ void wait_or_trap(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (!done && clock64() - t0 > 10000000000LL) __trap();
  } while (!done);
}

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
// full-hidden QK-RMSNorm (fp32) before the rounding. Beside them, from the
// bf16 values in fp32: qn [M, heads] = ||q_h||^2 and kmax [B, heads] =
// max over the sample's rows of ||k_h||^2 (atomicMax on the bits; zeroed
// before the layer). One block of PREP_THREADS per row; warp w takes heads
// w, w + 8, ..., a lane two neighbouring columns of each, so the norms are
// warp sums in a fixed order.
constexpr int PREP_THREADS = 256;

__global__ void __launch_bounds__(PREP_THREADS)
qkv_prep_kernel(const float* __restrict__ qkv, const float* __restrict__ qnw,
                const float* __restrict__ knw, bf16* __restrict__ q,
                bf16* __restrict__ k, bf16* __restrict__ v,
                float* __restrict__ qn, unsigned* __restrict__ kmax, int S,
                int C, float eps, int qk_norm, float qscale) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const int heads = C / HD, b = (int)(row / S);
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int h = warp; h < heads; h += PREP_THREADS / 32) {
    const int c = h * HD + 2 * lane;
    float qv[2] = {r[c], r[c + 1]}, kv[2] = {r[C + c], r[C + c + 1]};
    if (qk_norm) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        qv[e] = qv[e] * rq * qnw[c + e];
        kv[e] = kv[e] * rk * knw[c + e];
      }
    }
    const __nv_bfloat162 qb = __floats2bfloat162_rn(qv[0] * qscale,
                                                    qv[1] * qscale);
    const __nv_bfloat162 kb = __floats2bfloat162_rn(kv[0], kv[1]);
    *reinterpret_cast<__nv_bfloat162*>(q + row * C + c) = qb;
    *reinterpret_cast<__nv_bfloat162*>(k + row * C + c) = kb;
    *reinterpret_cast<__nv_bfloat162*>(v + row * C + c) =
        __floats2bfloat162_rn(r[2 * C + c], r[2 * C + c + 1]);
    const float2 qf = __bfloat1622float2(qb), kf = __bfloat1622float2(kb);
    const float sq = warp_sum(__fadd_rn(__fmul_rn(qf.x, qf.x),
                                        __fmul_rn(qf.y, qf.y)));
    const float sk = warp_sum(__fadd_rn(__fmul_rn(kf.x, kf.x),
                                        __fmul_rn(kf.y, kf.y)));
    if (lane == 0) {
      qn[row * heads + h] = sq;
      atomicMax(kmax + (size_t)b * heads + h, __float_as_uint(sk));
    }
  }
}

// -- attention: one pass under the norm-bound shift --------------------------
// Three consumer warpgroups of 64 query rows and a producer warpgroup,
// registers 160 / 32, and K/V tiles of 64 keys in a ring of 3: S, P and O
// of 128-key tiles do not fit 160 registers (ptxas serializes the wgmma),
// and two consumers at 240 registers with 128-key tiles measured 13% slower
// at B 1, the same at B 13.
struct AttL {
  static constexpr int NCW = 3, THREADS = (NCW + 1) * WG;
  static constexpr int CREGS = 160, PREGS = 32;
  static constexpr int BQ = 64 * NCW, BKV = 64, NST = 3;
  static constexpr int Q_BYTES = BQ * ROWB, KV_BYTES = BKV * ROWB;
  static constexpr int K_OFF = Q_BYTES;  // stage s: K, then V
  static constexpr int BAR_OFF = K_OFF + NST * 2 * KV_BYTES;
  // barriers: full, empty (NST each), Q, the consumers' decision
  static constexpr int FLAG_OFF = BAR_OFF + (2 * NST + 2) * 8;
  static constexpr int BYTES = FLAG_OFF + 16 + 1024;
};

// The least denominator under the norm bound: a row whose d falls below
// 2^-100 has lost (or is close to losing) its exponents to underflow (fp32
// and bf16 reach 2^-126, bf16's subnormals 2^-133), and is shifted by its
// largest score instead.
constexpr float MIN_D = 7.888609052210118e-31f;  // 2^-100

// Descriptor of k-step kk of a K-major 64-column tile (rows r0 ...).
__device__ __forceinline__ uint64_t kmaj(const void* tile, int r0, int kk) {
  return desc(static_cast<const char*>(tile) + r0 * ROWB + kk * 32, 16,
              8 * ROWB, 1);
}
// Descriptor of contraction rows 16 kk ... of an MN-major tile stored as
// chunks of 64 columns x R rows (the chunks R * ROWB bytes apart).
__device__ __forceinline__ uint64_t mnmaj(const void* tile, int R, int kk) {
  return desc(static_cast<const char*>(tile) + kk * 16 * ROWB, R * ROWB,
              8 * ROWB, 1);
}

// grid (ceil(S / BQ), heads, B). out [B*S, C] bf16; qn [B*S, heads], kmax
// [B, heads] (float bits) from qkv_prep_kernel.
__global__ void __launch_bounds__(AttL::THREADS, 1)
    attention_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const float* __restrict__ qn,
                     const unsigned* __restrict__ kmax,
                     bf16* __restrict__ out, int S, int heads) {
  using L = AttL;
  constexpr int NST = L::NST, BKV = L::BKV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  uint64_t* empty = full + NST;
  uint64_t* qbar = empty + NST;
  uint64_t* decide = qbar + 1;
  int* redo = reinterpret_cast<int*>(sm + L::FLAG_OFF);
  auto k_tile = [&](int s) { return sm + L::K_OFF + s * 2 * L::KV_BYTES; };
  const int i0 = blockIdx.x * L::BQ, h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (S + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);             // the producer's expect_tx
      mbar_init(&empty[s], 4 * L::NCW);   // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_init(decide, 1);
    *redo = 0;
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= L::NCW * WG) {
    reg_dealloc<L::PREGS>();
    if (threadIdx.x == L::NCW * WG) {
      mbar_expect_tx(qbar, L::Q_BYTES);
      tma_load_4d(sm, &tq, qbar, 0, h, i0, b);
      // the keys once; three times if a row needs the row max
      for (int n = 0; n < 3 * ntiles; ++n) {
        if (n == ntiles) {
          wait_or_trap(decide, 0);
          if (!*redo) break;
        }
        const int s = n % NST, k0 = (n % ntiles) * BKV;
        wait_or_trap(&empty[s], ((n / NST) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::KV_BYTES);
        tma_load_4d(k_tile(s), &tk, &full[s], 0, h, k0, b);
        tma_load_4d(k_tile(s) + L::KV_BYTES, &tv, &full[s], 0, h, k0, b);
      }
    }
  } else {
    reg_alloc<L::CREGS>();
    const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const float kn = __uint_as_float(kmax[(size_t)b * heads + h]);
    int qi[2];
    float mb[2], dl[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qi[r] = i0 + wg * 64 + warp * 16 + g + 8 * r;
      const float qq = qi[r] < S ? qn[((size_t)b * S + qi[r]) * heads + h]
                                 : 0.f;
      mb[r] = sqrtf(__fadd_rn(__fmul_rn(qq, kn), 1e-12f));
    }
    float acc[HD / 2], mx[2] = {-3.0e38f, -3.0e38f}, d[2];
    uint32_t pa[BKV / 4];
    wait_or_trap(qbar, 0);

    // pass 0 under the norm bound. Only if a row of the block ends with d <
    // MIN_D: pass 1 takes each row's largest score, and pass 2 runs pass 0
    // again with those rows shifted by it.
    for (int n = 0; n < 3 * ntiles; ++n) {
      const int pass = n / ntiles;
      if (n % ntiles == 0) {
        if (pass == 1) {  // the decision, among the consumer warpgroups
          bool low = false;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            d[r] = quad_sum(dl[r]);
            low = low || (qi[r] < S && d[r] < MIN_D);
          }
          if (low) atomicOr(redo, 1);
          bar_sync(1, L::NCW * WG);
          if (threadIdx.x == 0) mbar_arrive(decide);
          if (!*redo) break;
        } else if (pass == 2) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float row_max = quad_max(mx[r]);
            if (qi[r] < S && d[r] < MIN_D) mb[r] = row_max;
          }
        }
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
        dl[0] = dl[1] = 0.f;
      }
      const int st = n % NST, k0 = (n % ntiles) * BKV;
      const unsigned char* Ks = k_tile(st);
      const unsigned char* Vs = Ks + L::KV_BYTES;
      wait_or_trap(&full[st], (n / NST) & 1);

      float s[BKV / 2];  // the first k-step overwrites (scale_d = 0)
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Mma<BKV>::ss(s, kmaj(sm, wg * 64, kk), kmaj(Ks, 0, kk), kk);
      wg_commit();
      wg_wait_all();
      fence_regs(s);

      const bool ragged = k0 + BKV > S;
      if (pass == 1) {  // the row max, over the keys before S
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e)
          if (!ragged || k0 + col(e, t) < S)
            mx[rsel(e)] = fmaxf(mx[rsel(e)], s[e]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
        continue;
      }
      // e = bf16(exp2(s - m)), packed two a register as P's A operand; d
      // sums the rounded e (read back from the packed halves); keys past
      // S: e = 0
#pragma unroll
      for (int i = 0; i < BKV / 4; ++i) {
        const int r = rsel(2 * i);
        float p0 = exp2f(s[2 * i] - mb[r]), p1 = exp2f(s[2 * i + 1] - mb[r]);
        if (ragged) {
          if (k0 + col(2 * i, t) >= S) p0 = 0.f;
          if (k0 + col(2 * i + 1, t) >= S) p1 = 0.f;
        }
        pa[i] = pack_f(p0, p1);
        dl[r] += __uint_as_float(pa[i] << 16) +
                 __uint_as_float(pa[i] & 0xffff0000u);
      }

      fence_regs(acc);
      fence_regs(pa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        Mma<HD>::rs(acc, frag(pa, kk), mnmaj(Vs, BKV, kk), 1);
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    if (*redo) {
#pragma unroll
      for (int r = 0; r < 2; ++r) d[r] = quad_sum(dl[r]);
    }
    const int C = heads * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qi[r] >= S) continue;
      const float inv = 1.f / d[r];
      bf16* op = out + ((size_t)b * S + qi[r]) * C + h * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(op + 8 * j + 2 * t) = pack_f(
            acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

// -- bf16 GEMM: wgmma over a TMA ring ----------------------------------------
constexpr int GBM = 128, GBK = 64;  // tile rows; K values (128 bytes) a stage
constexpr int GEMM_THREADS = 3 * WG;  // two consumer warpgroups + producer
constexpr int G_PREGS = 40, G_CREGS = 232;
constexpr int STAGE_BUDGET = 192 * 1024;

template <int BN>
struct GemmL {
  static constexpr int A_BYTES = GBM * ROWB, B_BYTES = GBK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int NST = STAGE_BUDGET / STAGE;  // 6 at BN 128, 4 at 256
  static constexpr int BAR_OFF = NST * STAGE;
  static constexpr int BYTES = BAR_OFF + 2 * NST * 8 + 1024;
};

struct EpiArgs {
  const float* bias;
  const float* ls;
  float* out_f;
  bf16* out_b;
  int M, N;
};

// Two neighbouring outputs (row, col) and (row, col + 1) of the product.
template <int EPI>
__device__ __forceinline__ void store2(const EpiArgs& p, int row, int col,
                                       float a0, float a1) {
  const size_t o = (size_t)row * p.N + col;
  const float v[2] = {__fadd_rn(a0, p.bias[col]),
                      __fadd_rn(a1, p.bias[col + 1])};
  if (EPI == EPI_BIAS_F32) {
    *reinterpret_cast<float2*>(p.out_f + o) = make_float2(v[0], v[1]);
  } else if (EPI == EPI_BIAS_GELU_BF16) {
    float y[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      y[e] = 0.5f * v[e] * (1.f + erff(v[e] * 0.70710678118654752f));
    *reinterpret_cast<__nv_bfloat162*>(p.out_b + o) =
        __floats2bfloat162_rn(y[0], y[1]);
  } else {  // x = bf16(x + bf16(acc + bias) * ls), in place
    const float2 xv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p.out_b + o));
    *reinterpret_cast<__nv_bfloat162*>(p.out_b + o) = __floats2bfloat162_rn(
        __fadd_rn(xv.x, __fmul_rn(bf(v[0]), p.ls[col])),
        __fadd_rn(xv.y, __fmul_rn(bf(v[1]), p.ls[col + 1])));
  }
}

// C[M, N] = A[M, K] (bf16, row-major) @ B[K, N] (bf16, row-major), fp32
// accumulate, fused epilogue. grid (N tiles, M tiles). Warpgroup 2's first
// thread produces: per k-block of 64, the A tile [128 rows x 64] and the B
// tile [64 rows x BN] as BN / 64 chunks of 64 columns, into a ring of NST
// stages handed over by full / empty mbarriers; warpgroups 0 and 1 each
// multiply their 64 rows by B read MN-major, one k-block in flight.
template <int EPI, int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb, const EpiArgs p,
                int kblocks) {
  using L = GemmL<BN>;
  constexpr int NST = L::NST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  uint64_t* empty = full + NST;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * GBM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * WG) {
    reg_dealloc<G_PREGS>();
    if (threadIdx.x == 2 * WG) {
      for (int n = 0; n < kblocks; ++n) {
        const int s = n % NST, k0 = n * GBK;
        unsigned char* st = sm + s * L::STAGE;
        wait_or_trap(&empty[s], ((n / NST) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::STAGE);
        tma_load_2d(st, &ta, &full[s], k0, m0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(st + L::A_BYTES + c * GBK * ROWB, &tb, &full[s],
                      n0 + 64 * c, k0);
      }
    }
  } else {
    reg_alloc<G_CREGS>();
    const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    float acc[BN / 2];
    for (int n = 0; n < kblocks; ++n) {
      const int s = n % NST;
      const unsigned char* as = sm + s * L::STAGE + wg * 64 * ROWB;
      const unsigned char* bs = sm + s * L::STAGE + L::A_BYTES;
      wait_or_trap(&full[s], (n / NST) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < GBK / 16; ++kk)
        Mma<BN>::template ss<1>(acc, kmaj(as, 0, kk), mnmaj(bs, GBK, kk),
                                n > 0 || kk > 0);
      wg_commit();
      wg_wait<1>();  // stage n - 1's products are done: hand it back
      if (n > 0 && lane == 0) mbar_arrive(&empty[(n - 1) % NST]);
    }
    wg_wait_all();
    fence_regs(acc);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wg * 64 + warp * 16 + g + 8 * hh;
      if (row >= p.M) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        if (c < p.N)
          store2<EPI>(p, row, c, acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      }
    }
  }
}

// -- host ---------------------------------------------------------------------
static int cdiv(int a, int b) { return (a + b - 1) / b; }

// A row-major bf16 matrix [rows, cols] with boxes of 64 columns x box rows,
// 128-byte swizzle (TMA zero-fills past either edge).
static int rows_map(CUtensorMap* map, const void* ptr, int cols, int rows,
                    int box) {
  TmapArgs a{};
  a.ptr = ptr;
  a.dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  a.rank = 2;
  a.swizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  a.l2 = CU_TENSOR_MAP_L2_PROMOTION_L2_256B;
  a.dims[0] = cols;
  a.dims[1] = rows;
  a.strides[0] = (cuuint64_t)cols * 2;
  a.box[0] = 64;
  a.box[1] = box;
  return tmap_encode(map, a);
}

// q/k/v [B*S, heads * 64] as [B, S, heads, 64], box (64, 1, rows, 1): one
// head's rows of one sample (TMA zero-fills past S).
static int head_map(CUtensorMap* map, const void* ptr, int B, int S,
                    int heads, int rows) {
  TmapArgs a{};
  a.ptr = ptr;
  a.dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  a.rank = 4;
  a.swizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  a.l2 = CU_TENSOR_MAP_L2_PROMOTION_L2_128B;
  a.dims[0] = HD;
  a.dims[1] = heads;
  a.dims[2] = S;
  a.dims[3] = B;
  a.strides[0] = (cuuint64_t)HD * 2;
  a.strides[1] = (cuuint64_t)heads * HD * 2;
  a.strides[2] = (cuuint64_t)S * heads * HD * 2;
  a.box[0] = HD;
  a.box[1] = 1;
  a.box[2] = rows;
  a.box[3] = 1;
  return tmap_encode(map, a);
}

// The tile width of a product: the one whose waves of tiles cost least (a
// 128-wide tile taken as 9/8 of half a 256-wide one's time, as the int8
// GEMM's plan does).
static int tile_n(int M, int N) {
  const int mt = cdiv(M, GBM);
  const long c256 = (long)cdiv(mt * cdiv(N, 256), SMS) * 256 * 8;
  const long c128 = (long)cdiv(mt * cdiv(N, 128), SMS) * 128 * 9;
  return c256 <= c128 ? 256 : 128;
}

template <int EPI, int BN>
static int gemm_bn(const CUtensorMap& ta, const bf16* B, int M, int N, int K,
                   const EpiArgs& p, cudaStream_t st) {
  using L = GemmL<BN>;
  static const int attr = set_smem(gemm_kernel<EPI, BN>, L::BYTES);
  if (attr) return attr;
  CUtensorMap tb;
  if (int e = rows_map(&tb, B, N, K, GBK)) return e;
  gemm_kernel<EPI, BN><<<dim3(cdiv(N, BN), cdiv(M, GBM)), GEMM_THREADS,
                         L::BYTES, st>>>(ta, tb, p, cdiv(K, GBK));
  RETURN_IF_ERR();
  return 0;
}

template <int EPI>
static int gemm(const bf16* A, const bf16* B, int M, int N, int K,
                const float* bias, const float* ls, float* out_f, bf16* out_b,
                cudaStream_t st) {
  CUtensorMap ta;
  if (int e = rows_map(&ta, A, K, M, GBM)) return e;
  const EpiArgs p{bias, ls, out_f, out_b, M, N};
  return tile_n(M, N) == 256 ? gemm_bn<EPI, 256>(ta, B, M, N, K, p, st)
                             : gemm_bn<EPI, 128>(ta, B, M, N, K, p, st);
}

// The attention kernel over prepared q/k/v, qn and kmax.
static int attend(const bf16* qb, const bf16* kb, const bf16* vb,
                  const float* qn, const unsigned* kmax, bf16* attn, int B,
                  int S, int heads, cudaStream_t st) {
  using L = AttL;
  static const int attr = set_smem(attention_kernel, L::BYTES);
  if (attr) return attr;
  CUtensorMap tq, tk, tv;
  if (int e = head_map(&tq, qb, B, S, heads, L::BQ)) return e;
  if (int e = head_map(&tk, kb, B, S, heads, L::BKV)) return e;
  if (int e = head_map(&tv, vb, B, S, heads, L::BKV)) return e;
  attention_kernel<<<dim3(cdiv(S, L::BQ), heads, B), L::THREADS, L::BYTES,
                     st>>>(tq, tk, tv, qn, kmax, attn, S, heads);
  RETURN_IF_ERR();
  return 0;
}

// qkv prep + attention of one layer: q/k/v, qn, kmax (zeroed here), attn.
static int attention(const float* qkv, const float* qnw, const float* knw,
                     bf16* qb, bf16* kb, bf16* vb, float* qn, unsigned* kmax,
                     bf16* attn, int B, int S, int C, float eps, int qk_norm,
                     float qscale, cudaStream_t st) {
  const int heads = C / HD;
  if (cudaError_t e =
          cudaMemsetAsync(kmax, 0, (size_t)B * heads * sizeof(unsigned), st))
    return (int)e;
  qkv_prep_kernel<<<B * S, PREP_THREADS, 0, st>>>(qkv, qnw, knw, qb, kb, vb,
                                                  qn, kmax, S, C, eps,
                                                  qk_norm, qscale);
  RETURN_IF_ERR();
  return attend(qb, kb, vb, qn, kmax, attn, B, S, heads, st);
}

// The probe: one 128 x BN tile of A [128, 64] . B [64, BN] (B row-major,
// read MN-major), one TMA load each -> c [128, BN] fp32. The smallest check
// of the transposed-B descriptors the GEMM uses.
template <int BN>
__global__ void __launch_bounds__(2 * WG, 1)
    probe_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb, float* c) {
  using L = GemmL<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1k(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::STAGE);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, L::STAGE);
    tma_load_2d(sm, &ta, bar, 0, 0);
    for (int ch = 0; ch < BN / 64; ++ch)
      tma_load_2d(sm + L::A_BYTES + ch * GBK * ROWB, &tb, bar, 64 * ch, 0);
  }
  wait_or_trap(bar, 0);
  const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  float acc[BN / 2];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < GBK / 16; ++kk)
    Mma<BN>::template ss<1>(acc, kmaj(sm + wg * 64 * ROWB, 0, kk),
                            mnmaj(sm + L::A_BYTES, GBK, kk), kk > 0);
  wg_commit();
  wg_wait_all();
  fence_regs(acc);
#pragma unroll
  for (int e = 0; e < BN / 2; ++e)
    c[(wg * 64 + warp * 16 + g + 8 * rsel(e)) * BN + col(e, t)] = acc[e];
}

template <int BN>
static int probe(const void* a, const void* b, void* c, cudaStream_t st) {
  constexpr int BYTES = GemmL<BN>::STAGE + 8 + 1024;
  static const int attr = set_smem(probe_kernel<BN>, BYTES);
  if (attr) return attr;
  CUtensorMap ta, tb;
  if (int e = rows_map(&ta, a, GBK, GBM, GBM)) return e;
  if (int e = rows_map(&tb, b, BN, GBK, GBK)) return e;
  probe_kernel<BN><<<1, 2 * WG, BYTES, st>>>(ta, tb, (float*)c);
  RETURN_IF_ERR();
  return 0;
}

}  // namespace vit

// The whole stack: x bf16 [B*S, C] is updated in place, layer by layer.
// Per-layer f32 vectors are stacked [L, n]; weights bf16 [L, K, N].
// Scratch: h bf16 [M, C], qkv f32 [M, 3C], qb/kb/vb/attn bf16 [M, C],
// mid bf16 [M, inter] (M = B*S), qn f32 [M, heads], kmax u32 [B, heads].
extern "C" int vit_stack_forward(
    void* x_, const void* ln1w_, const void* ln1b_, const void* ln2w_,
    const void* ln2b_, const void* ls1_, const void* ls2_, const void* qnw_,
    const void* knw_, const void* qkvb_, const void* projb_, const void* fc1b_,
    const void* fc2b_, const void* qkvw_, const void* projw_, const void* fc1w_,
    const void* fc2w_, void* h_, void* qkv_, void* qb_, void* kb_, void* vb_,
    void* attn_, void* mid_, void* qn_, void* kmax_, int B, int S, int C,
    int inter, int heads, int L, float eps, int qk_norm, float qscale,
    void* stream) {
  using namespace vit;
  if (C != heads * HD || C % 8 || inter % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  bf16* x = (bf16*)x_;
  bf16 *h = (bf16*)h_, *qb = (bf16*)qb_, *kb = (bf16*)kb_, *vb = (bf16*)vb_;
  bf16 *attn = (bf16*)attn_, *mid = (bf16*)mid_;
  float *qkv = (float*)qkv_, *qn = (float*)qn_;
  unsigned* kmax = (unsigned*)kmax_;
  const float *ln1w = (const float*)ln1w_, *ln1b = (const float*)ln1b_;
  const float *ln2w = (const float*)ln2w_, *ln2b = (const float*)ln2b_;
  const float *ls1 = (const float*)ls1_, *ls2 = (const float*)ls2_;
  const float *qnw = (const float*)qnw_, *knw = (const float*)knw_;
  const float *qkvb = (const float*)qkvb_, *projb = (const float*)projb_;
  const float *fc1b = (const float*)fc1b_, *fc2b = (const float*)fc2b_;
  const bf16 *qkvw = (const bf16*)qkvw_, *projw = (const bf16*)projw_;
  const bf16 *fc1w = (const bf16*)fc1w_, *fc2w = (const bf16*)fc2w_;
  const int M = B * S;
  int err;
  for (int l = 0; l < L; ++l) {
    const size_t lc = (size_t)l * C;
    layer_norm_kernel<<<M, 256, 0, st>>>(x, ln1w + lc, ln1b + lc, h, C, eps);
    RETURN_IF_ERR();
    if ((err = gemm<EPI_BIAS_F32>(h, qkvw + (size_t)l * C * 3 * C, M, 3 * C, C,
                                  qkvb + 3 * lc, nullptr, qkv, nullptr, st)) ||
        (err = attention(qkv, qnw + lc, knw + lc, qb, kb, vb, qn, kmax, attn,
                         B, S, C, eps, qk_norm, qscale, st)) ||
        (err = gemm<EPI_BIAS_LS_RESIDUAL>(attn, projw + (size_t)l * C * C, M,
                                          C, C, projb + lc, ls1 + lc, nullptr,
                                          x, st)))
      return err;
    layer_norm_kernel<<<M, 256, 0, st>>>(x, ln2w + lc, ln2b + lc, h, C, eps);
    RETURN_IF_ERR();
    if ((err = gemm<EPI_BIAS_GELU_BF16>(h, fc1w + (size_t)l * C * inter, M,
                                        inter, C, fc1b + (size_t)l * inter,
                                        nullptr, nullptr, mid, st)) ||
        (err = gemm<EPI_BIAS_LS_RESIDUAL>(mid, fc2w + (size_t)l * inter * C, M,
                                          C, inter, fc2b + lc, ls2 + lc,
                                          nullptr, x, st)))
      return err;
  }
  return 0;
}

// int32 elements of GEMM scratch the act_quant stack needs (the largest of
// its products' K splits; 0: none). G: fc2's quantization groups.
static size_t vit_w8a8_ws(int M, int C, int inter, int G) {
  const size_t a = w8a8::gemm_ws_elems(M, 3 * C, C);
  const size_t b = w8a8::gemm_ws_elems(M, C, C);
  const size_t c = w8a8::gemm_ws_elems(M, inter, C);
  const size_t d = w8a8::gemm_ws_elems(M, C, inter / G);
  return std::max(std::max(a, b), std::max(c, d));
}

extern "C" long long vit_w8a8_workspace(int B, int S, int C, int inter) {
  return (long long)vit_w8a8_ws(B * S, C, inter, B == 1 ? 1 : 2);
}

// The act_quant stack: x bf16 [B*S, C] updated in place. Weights int8,
// K-major [L, N, K] (qkv [L, 3C, C], proj [L, C, C], fc1 [L, inter, C], fc2
// [L, C, inter]) with fp32 per-output-channel scales [L, N]. Scratch: aq
// int8 [M, max(C, inter)] and am fp32 [M, 2] (the quantized activation of
// each GEMM in turn), qkv f32 [M, 3C], qb/kb/vb/attn bf16 [M, C], mid f32
// [M, inter], part f32 [M, C] (B > 1 only), ws int32 of
// vit_w8a8_workspace(B, S, C, inter) elements, qn f32 [M, heads], kmax u32
// [B, heads].
extern "C" int vit_stack_forward_w8a8(
    void* x_, const void* ln1w_, const void* ln1b_, const void* ln2w_,
    const void* ln2b_, const void* ls1_, const void* ls2_, const void* qnw_,
    const void* knw_, const void* qkvb_, const void* projb_, const void* fc1b_,
    const void* fc2b_, const void* qkvs_, const void* projs_, const void* fc1s_,
    const void* fc2s_, const void* qkvw_, const void* projw_, const void* fc1w_,
    const void* fc2w_, void* aq_, void* am_, void* qkv_, void* qb_, void* kb_,
    void* vb_, void* attn_, void* mid_, void* part_, void* ws_, void* qn_,
    void* kmax_, int B, int S, int C, int inter, int heads, int L, float eps,
    int qk_norm, float qscale, long long ws_elems, void* stream) {
  using namespace vit;
  const int G = B == 1 ? 1 : 2;  // fc2's quantization groups (TPU n_chunks)
  if (C != heads * HD || C % 16 || inter % (16 * G))
    return (int)cudaErrorInvalidValue;
  const int M = B * S, half = inter / G;
  if ((size_t)ws_elems < vit_w8a8_ws(M, C, inter, G))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  bf16* x = (bf16*)x_;
  int8_t* aq = (int8_t*)aq_;
  float *am = (float*)am_, *qkv = (float*)qkv_, *mid = (float*)mid_;
  float *part = (float*)part_, *qn = (float*)qn_;
  unsigned* kmax = (unsigned*)kmax_;
  int32_t* ws = (int32_t*)ws_;
  const size_t wn = (size_t)ws_elems;
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
  int err;
  for (int l = 0; l < L; ++l) {
    const size_t lc = (size_t)l * C, li = (size_t)l * inter;
    const int8_t* w2 = fc2w + (size_t)l * C * inter;  // [C, inter]
    if ((err = w8a8::quantize(x, 1, M, C, 1, ln1w + lc, ln1b + lc, eps, aq, am, st)) ||
        (err = w8a8::gemm(w8a8::EPI_BIAS_F32, 0, aq, C, am, 1,
                    qkvw + (size_t)l * 3 * C * C, C, qkvs + 3 * lc, M, 3 * C, C,
                    qkvb + 3 * lc, nullptr, nullptr, qkv, nullptr, ws, wn, st)) ||
        (err = attention(qkv, qnw + lc, knw + lc, qb, kb, vb, qn, kmax, attn,
                         B, S, C, eps, qk_norm, qscale, st)) ||
        (err = w8a8::quantize(attn, 1, M, C, 1, nullptr, nullptr, 0.f, aq, am, st)) ||
        (err = w8a8::gemm(w8a8::EPI_BIAS_LS_RESIDUAL, 0, aq, C, am, 1,
                    projw + (size_t)l * C * C, C, projs + lc, M, C, C,
                    projb + lc, nullptr, ls1 + lc, nullptr, x, ws, wn, st)) ||
        (err = w8a8::quantize(x, 1, M, C, 1, ln2w + lc, ln2b + lc, eps, aq, am, st)) ||
        (err = w8a8::gemm(w8a8::EPI_BIAS_GELU_F32, 0, aq, C, am, 1,
                    fc1w + (size_t)l * inter * C, C, fc1s + li, M, inter, C,
                    fc1b + li, nullptr, nullptr, mid, nullptr, ws, wn, st)) ||
        (err = w8a8::quantize(mid, 0, M, inter, G, nullptr, nullptr, 0.f, aq, am, st)))
      return err;
    if (G == 1) {
      err = w8a8::gemm(w8a8::EPI_BIAS_LS_RESIDUAL, 0, aq, inter, am, 1, w2,
                 inter, fc2s + lc, M, C, inter, fc2b + lc, nullptr, ls2 + lc,
                 nullptr, x, ws, wn, st);
    } else {  // part = fc2b + half 0; x += bf16(part + half 1) * ls2
      err = w8a8::gemm(w8a8::EPI_BIAS_F32, 0, aq, inter, am, 2, w2, inter,
                 fc2s + lc, M, C, half, fc2b + lc, nullptr, nullptr, part,
                 nullptr, ws, wn, st);
      if (!err)
        err = w8a8::gemm(w8a8::EPI_BIAS_LS_RESIDUAL, 0, aq + half, inter,
                   am + 1, 2, w2 + half, inter, fc2s + lc, M, C, half, nullptr,
                   part, ls2 + lc, nullptr, x, ws, wn, st);
    }
    if (err) return err;
  }
  return 0;
}

// The attention kernel alone (timing and tests; the stack runs it through
// its qkv prep): q/k/v bf16 [B*S, heads * 64] (q in the log2 domain), qn
// fp32 [B*S, heads] = ||q_h||^2, kmax [B, heads] = the bits of max_r
// ||k_h||^2 -> out bf16 [B*S, heads * 64].
extern "C" int vit_attention_forward(const void* q, const void* k,
                                     const void* v, const void* qn,
                                     const void* kmax, void* out, int B,
                                     int S, int heads, void* stream) {
  if (B < 1 || S < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  return vit::attend((const bf16*)q, (const bf16*)k, (const bf16*)v,
                     (const float*)qn, (const unsigned*)kmax, (bf16*)out, B,
                     S, heads, (cudaStream_t)stream);
}

// The transposed-B probe: a [128, 64] . b [64, n] (bf16, both row-major)
// -> c [128, n] fp32 through one TMA load each and four bf16 wgmma k-steps
// with B read MN-major; n 128 or 256.
extern "C" int vit_wgmma_tb_probe(const void* a, const void* b, void* c,
                                  int n, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return n == 256 ? vit::probe<256>(a, b, c, st)
                  : n == 128 ? vit::probe<128>(a, b, c, st)
                             : (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the attention kernel (which 0) or of the GEMM at
// tile width which (128, 256), in bytes; -1 for anything else.
extern "C" int vit_smem(int which) {
  return which == 0     ? vit::AttL::BYTES
         : which == 128 ? vit::GemmL<128>::BYTES
         : which == 256 ? vit::GemmL<256>::BYTES
                        : -1;
}
