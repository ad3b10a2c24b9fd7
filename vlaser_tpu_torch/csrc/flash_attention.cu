// Flash attention, forward and backward, for Hopper (bf16 in, fp32 softmax).
//
// Replaces: vlaser_tpu/kernels/flash_attention.py :: flash_attention_fwd
// (_flash_fwd_kernel, pallas_call at :206) and flash_attention_bwd
// (_flash_bwd_dq_kernel at :449 and _flash_bwd_dkv_kernel at :488).
//
// What it computes: q [B, Sq, H, D], k/v [B, Skv, KVH, D] (GQA: head h reads
// kv head h / (H / KVH)), D one of 64, 72, 128, 256; a key is allowed iff
// q_seg == k_seg, k_seg != 0 and k_lev <= q_lev (per-token metadata packed as
// seg << 2 | lev), when causal q_pos >= k_pos, and with a window q_pos - k_pos
// <= window (flash-attn's left window; q_pos = q_offset + q_idx). The logit
// is z = scale * q.k, or cap * tanh(z / cap) with a softcap (Gemma), taken
// before the mask as in the JAX kernel; lse is over the capped logits.
// Softmax statistics are fp32. A row with no allowed key gives out = 0 and
// lse = -1e30 + log(1). The backward recomputes P from lse, multiplies dS by
// the cap's derivative 1 - tanh^2 and takes delta = rowsum(dO * O) in a
// small pre-pass kernel (a warp a row) that the dq and dk/dv kernels read.
// tanh is the accurate tanhf: tanh.approx's ~2^-11 relative error times a
// cap of 50 would move a logit by ~0.025.
//
// What bounds it on the H100: at the training shapes (InternViT: B=32,
// S=1025, 16 heads x 64; SigLIP: B=32, S=256, 16 x 72; the joint stacks: B=32,
// S=389, 12 q / 2 kv heads x 128 and S=281, 8 q / 1 kv heads x 256) the work
// is 4*B*H*Sq*Skv*D flop forward (10x backward) against q/k/v/o bytes,
// hundreds of flop per byte: the tensor cores bound it (989 TFLOP/s bf16
// dense). The serving suffix (4 query rows over 281 keys) is bound by
// reading K/V, and in practice by the latency of one short block.
//
// What the design does about it (sm_90a):
// - Every product is a warpgroup wgmma with fp32 accumulators in registers.
//   A block has two consumer warpgroups (three in the forward at D 64) and
//   one producer warpgroup; setmaxnreg gives the producer 24 registers and
//   the consumers 240 (32 and 160 with three).
// - The producer's first warp keeps a ring of 2-3 shared-memory stages
//   full: one lane issues TMA loads of the K/V tiles (forward, dq) or the
//   Q/dO tiles (dk/dv) into swizzled layouts (128-byte swizzle, D = 72: the
//   32-byte swizzle of 16-column chunks, the map's extent 72 and a box that
//   reaches 80, so TMA's zero fill pads the last chunk), and its 32 lanes
//   load the tile's metadata (key metadata; or q metadata, lse and delta)
//   with plain loads, noting whether the whole tile shares one value. Full
//   and empty mbarriers hand stages over; ragged tile edges (S = 1025, 389,
//   281, 256) read TMA's zeros and metadata 0, which the segment rule masks.
// - Forward: each consumer warpgroup owns 64 query rows; S = Q.K^T with both
//   operands in shared memory, the online softmax on the accumulator in
//   base 2 (one FFMA and one ex2 an element), then O += P.V with P re-packed
//   to bf16 as the A operand from registers and V read MN-major (wgmma's
//   transposed B). Tiles of 128 keys (64 at D 256).
// - dq: the same rows; S = Q.K^T and dP = dO.V^T, dS in registers, dQ +=
//   dS.K with K read MN-major, tiles of 64 keys (32 at D 256). The scores of
//   the next tile are issued before dQ's product of this one and its dS is
//   taken while that product runs; the last tile is peeled so that the
//   pipeline has one shape and ptxas keeps the products asynchronous.
// - dk/dv: a block owns 128 keys (64 per consumer warpgroup) and walks the
//   group's q heads and q tiles of 64: S^T = K.Q^T and dP^T = V.dO^T, then
//   dV += P^T.dO and dK += dS^T.Q with P^T and dS^T from registers, GQA's
//   group summed in registers: no float atomics, deterministic. At D <= 72
//   it overlaps tiles as dq does. At D 256 the two warpgroups share 64
//   keys: one computes S^T, the other dP^T, each over the full D and q
//   tiles of 32; P (fp32, and 1 - t^2 with a softcap) and dS (bf16) cross
//   through shared memory between two named barriers, and each warpgroup
//   owns one 128-wide half of D of both dK and dV: no product is recomputed.
// - Short queries (Sq < 64, a GQA group of 2-32 heads that divides 32): the
//   tile rows hold (q row, head) pairs, row r = (q row r / G, head r % G of
//   the group), so that one block reads the KV head's K/V once for its whole
//   group (the 4-row serving suffix: 32 of 128 rows live in one block, not 4
//   rows in each of 8). launch_plan() in kernels/flash_attention.py mirrors
//   this plan and the tests hold it.
// - Masks and the -1e30 sentinel stay fp32 (-1e30 overflows half precision),
//   masked entries are selected to 0 rather than multiplied (exp(s - lse) of
//   a fully masked row is inf, and inf * 0 is NaN). A tile whose keys (q
//   rows in dk/dv) all share one metadata value that the thread's rows
//   allow, inside their position bounds, skips the per-element mask. Causal
//   and window skip whole tiles that no pair of theirs may see. The softcap
//   is a template flag (the kernels without it carry no tanh).
// - Tensor maps are encoded on the host and cached by every argument of the
//   encode (sm90.cuh, one cache for every TMA kernel); they reach the
//   kernels as __grid_constant__ parameters.
// Not done yet: a persistent grid (each block's Q load and prologue sit
// unhidden), ping-pong scheduling of the consumer warpgroups, and the
// backward at more than ~180 TFLOP/s (SDPA's reaches ~290 at the ViT shape).
#include <climits>

#include "common.cuh"
#include "sm90.cuh"

namespace fa {

using namespace sm90;

constexpr int WG = 128;                  // threads of a warpgroup
constexpr int NCW = 2;                   // consumer warpgroups of a block
constexpr int THREADS = (NCW + 1) * WG;  // + the producer warpgroup
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr float NEG = -1e30f;

// Per head dim: DP = D rounded up to the product depth (TMA zero-fills the
// columns past D); CW = columns of a swizzle row (64: 128-byte swizzle, 16:
// 32-byte swizzle), NCH = chunks of a tile; the tile sizes of each kernel.
template <int D>
struct Dims {
  static_assert(D % 8 == 0, "head_dim must be a multiple of 8");
  static constexpr int DP = (D + 15) / 16 * 16;
  static constexpr int CW = DP % 64 == 0 ? 64 : 16;
  static constexpr int NCH = DP / CW;
  static constexpr int ROWB = CW * 2;  // bytes of a swizzle row
  static constexpr uint32_t LAYOUT = CW == 64 ? 1 : 3;
  static constexpr int FWD_BKV = D > 128 ? 64 : 128;  // keys per tile
  static constexpr int DQ_BKV = D > 128 ? 32 : 64;
  static constexpr bool SPLIT = D > 128;  // dk/dv splits S^T / dP^T and D
  static constexpr int DKV_BK = SPLIT ? 64 : 64 * NCW;  // keys per block
  static constexpr int DKV_BQ = SPLIT ? 32 : 64;        // q rows per tile
};

// The mask and logit options of one call.
struct Opts {
  int causal, q_offset, window;  // window < 0: none
  float scale, softcap;          // softcap 0: none
};

__device__ __forceinline__ bool by_pos(const Opts& o) {
  return o.causal || o.window >= 0;
}
// Keys a query at qpos may see by position: [lo, hi].
__device__ __forceinline__ int key_lo(int qpos, const Opts& o) {
  return o.window < 0 ? INT_MIN : qpos - o.window;
}
__device__ __forceinline__ int key_hi(int qpos, const Opts& o) {
  return o.causal ? qpos : INT_MAX;
}
// Queries a key at kpos is seen by: [lo, hi].
__device__ __forceinline__ int query_lo(int kpos, const Opts& o) {
  return o.causal ? kpos : INT_MIN;
}
__device__ __forceinline__ int query_hi(int kpos, const Opts& o) {
  return o.window < 0 ? INT_MAX : kpos + o.window;
}
// First key tile that a query block starting at q_start may see.
__device__ __forceinline__ int k_first(int q_start, int bkv, int window) {
  return window < 0 ? 0 : max(0, q_start - window) / bkv * bkv;
}

constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

// Lanes of the producer warp: the metadata of keys (or q rows) k0 .. k0 + n
// - 1 of src (0 past S) into dst. -> to every lane, the value all n share,
// or -1 where they differ: a consumer then checks the mask once for the tile.
__device__ __forceinline__ int load_meta(int* dst, const int* src, int k0,
                                         int n, int S, int lane) {
  const int first = k0 < S ? src[k0] : 0;
  bool same = true;
  for (int i = lane; i < n; i += 32) {
    const int v = k0 + i < S ? src[k0 + i] : 0;
    dst[i] = v;
    same = same && v == first;
  }
  return __all_sync(0xffffffffu, same) ? first : -1;
}

// z = scale * s -> the logit; with CAP, cap * tanh(z / cap) and t its tanh.
template <bool CAP>
__device__ __forceinline__ float logit(float s, const Opts& o, float inv_cap,
                                       float& t) {
  const float z = s * o.scale;
  if constexpr (CAP) {
    t = tanhf(z * inv_cap);
    return o.softcap * t;
  }
  return z;
}

__device__ __forceinline__ bool allowed(int qm, int km) {
  const int qs = qm >> 2, ks = km >> 2;
  return qs == ks && ks != 0 && (km & 3) <= (qm & 3);
}

// -- tiles in shared memory ---------------------------------------------------
// Descriptor of a K-major operand: rows [r0, ...) of a tile of R rows,
// k-step kk (columns 16 kk .. 16 kk + 15).
template <int D>
__device__ __forceinline__ uint64_t kmaj(const bf16* tile, int R, int r0,
                                         int kk) {
  using C = Dims<D>;
  const int e = kk * 16;
  const char* p = reinterpret_cast<const char*>(tile) +
                  (e / C::CW) * R * C::ROWB + r0 * C::ROWB + (e % C::CW) * 2;
  return desc(p, 16, 8 * C::ROWB, C::LAYOUT);
}
// Descriptor of an MN-major B operand: rows (the contraction) 16 kk .. 16 kk
// + 15 of a tile of R rows, its columns from chunk c0 on.
template <int D>
__device__ __forceinline__ uint64_t mnmaj(const bf16* tile, int R, int kk,
                                          int c0 = 0) {
  using C = Dims<D>;
  const char* p = reinterpret_cast<const char*>(tile) + c0 * R * C::ROWB +
                  kk * 16 * C::ROWB;
  return desc(p, R * C::ROWB, 8 * C::ROWB, C::LAYOUT);
}
// TMA: a tile of R rows of a [B, S, heads, D] tensor whose map's box is (CW,
// nh, R / nh, 1): rows s.. of heads h.. of batch b, one load per chunk.
template <int D>
__device__ __forceinline__ void load_tile(bf16* tile, int R,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int h, int s, int b) {
  using C = Dims<D>;
#pragma unroll
  for (int c = 0; c < C::NCH; ++c)
    tma_load_4d(tile + c * R * C::CW, map, bar, c * C::CW, h, s, b);
}

// -- forward ------------------------------------------------------------------
template <int D>
struct FwdL {
  using C = Dims<D>;
  // three consumer warpgroups at D 64, where a short Q.K^T leaves the
  // tensor cores idle behind the softmax unless more rows share the SM;
  // registers then split 160 / 32 (at D 72 SigLIP's 256 rows fill two
  // 128-row blocks exactly, and 192-row blocks would waste a third)
  static constexpr int NCW = D == 64 ? 3 : 2;
  static constexpr int THREADS = (NCW + 1) * WG;
  static constexpr int CREGS = NCW == 3 ? 160 : CONSUMER_REGS;
  static constexpr int PREGS = NCW == 3 ? 32 : PRODUCER_REGS;
  static constexpr int BQ = 64 * NCW, BKV = C::FWD_BKV, NST = 2;
  static constexpr int Q_BYTES = BQ * C::DP * 2, KV_BYTES = BKV * C::DP * 2;
  static constexpr int K_OFF = Q_BYTES;  // stage s: K, then V
  static constexpr int META_OFF = K_OFF + NST * 2 * KV_BYTES;
  static constexpr int FLAG_OFF = META_OFF + NST * BKV * 4;
  static constexpr int BAR_OFF = FLAG_OFF + 16;
  static constexpr int BYTES = BAR_OFF + (2 * NST + 1) * 8 + 1024;
};

// grid (ceil(Sq / (BQ / pack)), H / pack, B): the block's rows are the pairs
// (q row i0 + r / pack, head h0 + r % pack), r < BQ. Softmax statistics are
// kept in base 2 (logits x log2 e: one FFMA and one ex2 an element).
template <int D, bool CAP>
__global__ void __launch_bounds__(FwdL<D>::THREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const int* __restrict__ qmeta, const int* __restrict__ kmeta,
               bf16* __restrict__ out, float* __restrict__ lse, int Sq,
               int Skv, int H, int KVH, int pack, Opts o) {
  using C = Dims<D>;
  using L = FwdL<D>;
  constexpr int BQ = L::BQ, BKV = L::BKV, DP = C::DP, NST = L::NST;
  constexpr int NCW = L::NCW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1k(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm);
  int* kms = reinterpret_cast<int*>(sm + L::META_OFF);
  int* kflag = reinterpret_cast<int*>(sm + L::FLAG_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  uint64_t* empty = full + NST;
  uint64_t* qbar = empty + NST;
  auto k_tile = [&](int s) {
    return reinterpret_cast<bf16*>(sm + L::K_OFF + s * 2 * L::KV_BYTES);
  };

  const int nq = BQ / pack;
  const int i0 = blockIdx.x * nq, h0 = blockIdx.y * pack, b = blockIdx.z;
  const int kvh = h0 / (H / KVH);
  const int q_last = o.q_offset + min(i0 + nq, Sq) - 1;
  const int k_begin = k_first(o.q_offset + i0, BKV, o.window);
  const int k_end = o.causal ? min(Skv, q_last + 1) : Skv;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BKV - 1) / BKV : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1 + 32);   // the TMA lane's expect_tx + 32 lanes
      mbar_init(&empty[s], 4 * NCW);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCW * WG) {
    // the producer warpgroup: its first warp loads, the rest idle
    reg_dealloc<L::PREGS>();
    if (threadIdx.x < NCW * WG + 32) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_expect_tx(qbar, L::Q_BYTES);
        load_tile<D>(Qs, BQ, &tq, qbar, h0, i0, b);
      }
      for (int n = 0; n < ntiles; ++n) {
        const int s = n % NST, k0 = k_begin + n * BKV;
        mbar_wait(&empty[s], ((n / NST) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * L::KV_BYTES);
          load_tile<D>(k_tile(s), BKV, &tk, &full[s], kvh, k0, b);
          load_tile<D>(k_tile(s) + BKV * DP, BKV, &tv, &full[s], kvh, k0, b);
        }
        const int u = load_meta(kms + s * BKV, kmeta + (size_t)b * Skv, k0,
                                BKV, Skv, lane);
        if (lane == 0) kflag[s] = u;
        mbar_arrive(&full[s]);
      }
    }
  } else {
    reg_alloc<L::CREGS>();
    const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const float inv_cap = o.softcap > 0.f ? 1.f / o.softcap : 0.f;
    const float sl2 = o.scale * LOG2E;
    const bool pos = by_pos(o);
    int qi[2], hh[2], qm_r[2], klo[2], khi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pr = wg * 64 + warp * 16 + g + 8 * r;
      qi[r] = i0 + pr / pack;
      hh[r] = h0 + pr % pack;
      qm_r[r] = qi[r] < Sq ? qmeta[(size_t)b * Sq + qi[r]] : 0;
      klo[r] = key_lo(o.q_offset + qi[r], o);
      khi[r] = key_hi(o.q_offset + qi[r], o);
    }
    // the base-2 logit of a product
    auto logit2 = [&](float x) {
      if constexpr (CAP) {
        float tc;
        return logit<CAP>(x, o, inv_cap, tc) * LOG2E;
      }
      return x * sl2;
    };
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    float acc[DP / 2];
    uint32_t pa[BKV / 4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    mbar_wait(qbar, 0);

    for (int n = 0; n < ntiles; ++n) {
      const int st = n % NST, k0 = k_begin + n * BKV;
      const bf16* Ks = k_tile(st);
      const bf16* Vs = Ks + BKV * DP;
      const int* km = kms + st * BKV;
      mbar_wait(&full[st], (n / NST) & 1);

      float s[BKV / 2];  // the first k-step overwrites (scale_d = 0)
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        Mma<BKV>::ss(s, kmaj<D>(Qs, BQ, wg * 64, kk), kmaj<D>(Ks, BKV, 0, kk),
                     kk);
      wg_commit();
      wg_wait_all();
      fence_regs(s);

      // the mask: per element, unless every key of the tile shares one
      // metadata value that both rows allow and the tile lies inside both
      // rows' position bounds
      const int u = kflag[st];
      const bool whole =
          u >= 0 && allowed(qm_r[0], u) && allowed(qm_r[1], u) &&
          (!pos || (k0 >= max(klo[0], klo[1]) &&
                    k0 + BKV - 1 <= min(khi[0], khi[1])));
      float mx[2] = {NEG, NEG};
      if (whole) {
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) {
          s[e] = logit2(s[e]);
          mx[rsel(e)] = fmaxf(mx[rsel(e)], s[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) {
          const int r = rsel(e), c = col(e, t), kp = k0 + c;
          const bool ok = allowed(qm_r[r], km[c]) &&
                          (!pos || (kp >= klo[r] && kp <= khi[r]));
          s[e] = ok ? logit2(s[e]) : NEG;
          mx[r] = fmaxf(mx[r], s[e]);
        }
      }
      float alpha[2], mnew[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mnew[r] = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = exp2f(m[r] - mnew[r]);
      }
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) {
        const int r = rsel(e);
        // a masked entry holds the sentinel; no logit comes near it
        const float p = s[e] > 0.5f * NEG ? exp2f(s[e] - mnew[r]) : 0.f;
        s[e] = p;
        ls[r] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = alpha[r] * l[r] + quad_sum(ls[r]);
        m[r] = mnew[r];
      }
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) acc[e] *= alpha[rsel(e)];
      to_frags<BKV>(pa, s);

      fence_regs(acc);
      fence_regs(pa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        Mma<DP>::rs(acc, frag(pa, kk), mnmaj<D>(Vs, BKV, kk), 1);
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qi[r] >= Sq) continue;
      const float safe = l[r] == 0.f ? 1.f : l[r];
      const float inv = 1.f / safe;
      bf16* op = out + (((size_t)b * Sq + qi[r]) * H + hh[r]) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int c = 8 * j + 2 * t;
        if (c < D)
          *reinterpret_cast<uint32_t*>(op + c) =
              pack_f(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      }
      // back to natural logs; a row with no allowed key keeps the sentinel
      if (t == 0)
        lse[((size_t)b * H + hh[r]) * Sq + qi[r]] =
            (m[r] > 0.5f * NEG ? m[r] * LN2 : NEG) + logf(safe);
    }
  }
}

// -- backward: delta ----------------------------------------------------------
constexpr int DELTA_ROWS = 8;  // rows (one a warp) per block

// delta [B, H, Sq] = rowsum(dO * O) in fp32, rows [B, Sq, H] in memory order:
// a warp reads a row's D bf16 pairs contiguously.
__global__ void __launch_bounds__(32 * DELTA_ROWS)
    delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                 float* __restrict__ delta, int rows, int Sq, int H, int D) {
  const int row = blockIdx.x * DELTA_ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const __nv_bfloat162* po =
      reinterpret_cast<const __nv_bfloat162*>(out + (size_t)row * D);
  const __nv_bfloat162* pd =
      reinterpret_cast<const __nv_bfloat162*>(dout + (size_t)row * D);
  float d = 0.f;
  for (int c = lane; c < D / 2; c += 32) {
    const float2 x = __bfloat1622float2(po[c]);
    const float2 y = __bfloat1622float2(pd[c]);
    d += x.x * y.x + x.y * y.y;
  }
  d = warp_sum(d);
  if (lane == 0) {
    const int h = row % H, bi = row / H;
    delta[((size_t)(bi / Sq) * H + h) * Sq + bi % Sq] = d;
  }
}

// -- backward: dq -------------------------------------------------------------
template <int D>
struct DqL {
  using C = Dims<D>;
  static constexpr int NCW = FwdL<D>::NCW;  // as the forward's, same rows
  static constexpr int THREADS = (NCW + 1) * WG;
  static constexpr int CREGS = FwdL<D>::CREGS, PREGS = FwdL<D>::PREGS;
  static constexpr int BQ = 64 * NCW, BKV = C::DQ_BKV, NST = 3;
  static constexpr int Q_BYTES = BQ * C::DP * 2, KV_BYTES = BKV * C::DP * 2;
  static constexpr int K_OFF = 2 * Q_BYTES;  // Q, dO; stage s: K, then V
  static constexpr int META_OFF = K_OFF + NST * 2 * KV_BYTES;
  static constexpr int FLAG_OFF = META_OFF + NST * BKV * 4;
  static constexpr int BAR_OFF = FLAG_OFF + 16;
  static constexpr int BYTES = BAR_OFF + (2 * NST + 1) * 8 + 1024;
};

// dq = scale * sum_k dS K, dS = P * (dP - delta) (* (1 - t^2) with CAP).
// grid and rows as fwd_kernel.
template <int D, bool CAP>
__global__ void __launch_bounds__(DqL<D>::THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const int* __restrict__ qmeta, const int* __restrict__ kmeta,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int Sq, int Skv, int H, int KVH,
              int pack, Opts o) {
  using C = Dims<D>;
  using L = DqL<D>;
  constexpr int BQ = L::BQ, BKV = L::BKV, DP = C::DP, NST = L::NST;
  constexpr int NCW = L::NCW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1k(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm);
  bf16* Os = Qs + BQ * DP;  // dO
  int* kms = reinterpret_cast<int*>(sm + L::META_OFF);
  int* kflag = reinterpret_cast<int*>(sm + L::FLAG_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  uint64_t* empty = full + NST;
  uint64_t* qbar = empty + NST;
  auto k_tile = [&](int s) {
    return reinterpret_cast<bf16*>(sm + L::K_OFF + s * 2 * L::KV_BYTES);
  };

  const int nq = BQ / pack;
  const int i0 = blockIdx.x * nq, h0 = blockIdx.y * pack, b = blockIdx.z;
  const int kvh = h0 / (H / KVH);
  const int q_last = o.q_offset + min(i0 + nq, Sq) - 1;
  const int k_begin = k_first(o.q_offset + i0, BKV, o.window);
  const int k_end = o.causal ? min(Skv, q_last + 1) : Skv;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BKV - 1) / BKV : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1 + 32);
      mbar_init(&empty[s], 4 * NCW);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCW * WG) {
    reg_dealloc<L::PREGS>();
    if (threadIdx.x < NCW * WG + 32) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_expect_tx(qbar, 2 * L::Q_BYTES);
        load_tile<D>(Qs, BQ, &tq, qbar, h0, i0, b);
        load_tile<D>(Os, BQ, &tdo, qbar, h0, i0, b);
      }
      for (int n = 0; n < ntiles; ++n) {
        const int s = n % NST, k0 = k_begin + n * BKV;
        mbar_wait(&empty[s], ((n / NST) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * L::KV_BYTES);
          load_tile<D>(k_tile(s), BKV, &tk, &full[s], kvh, k0, b);
          load_tile<D>(k_tile(s) + BKV * DP, BKV, &tv, &full[s], kvh, k0, b);
        }
        const int u = load_meta(kms + s * BKV, kmeta + (size_t)b * Skv, k0,
                                BKV, Skv, lane);
        if (lane == 0) kflag[s] = u;
        mbar_arrive(&full[s]);
      }
    }
  } else {
    reg_alloc<L::CREGS>();
    const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const float inv_cap = o.softcap > 0.f ? 1.f / o.softcap : 0.f;
    const float sl2 = o.scale * LOG2E;
    const bool pos = by_pos(o);
    int qi[2], hh[2], qm_r[2], klo[2], khi[2];
    float lse_r[2], del_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pr = wg * 64 + warp * 16 + g + 8 * r;
      qi[r] = i0 + pr / pack;
      hh[r] = h0 + pr % pack;
      const bool in = qi[r] < Sq;
      const size_t hr = ((size_t)b * H + hh[r]) * Sq + qi[r];
      qm_r[r] = in ? qmeta[(size_t)b * Sq + qi[r]] : 0;
      lse_r[r] = in ? lse[hr] * LOG2E : 0.f;  // base 2, as the logits
      klo[r] = key_lo(o.q_offset + qi[r], o);
      khi[r] = key_hi(o.q_offset + qi[r], o);
      del_r[r] = in ? delta[hr] : 0.f;
    }
    float acc[DP / 2];
    uint32_t pa[BKV / 4];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    // S = Q.K^T and dP = dO.V^T of tile n, issued (committed, not waited for)
    auto scores = [&](float (&x)[BKV / 2], float (&y)[BKV / 2], int n) {
      const bf16* Ks = k_tile(n % NST);
      const bf16* Vs = Ks + BKV * DP;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        Mma<BKV>::ss(x, kmaj<D>(Qs, BQ, wg * 64, kk), kmaj<D>(Ks, BKV, 0, kk),
                     kk);
        Mma<BKV>::ss(y, kmaj<D>(Os, BQ, wg * 64, kk),
                     kmaj<D>(Vs, BKV, 0, kk), kk);
      }
      wg_commit();
    };
    // dQ += dS.K of tile n, issued
    auto dsk = [&](int n) {
      const bf16* Ks = k_tile(n % NST);
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        Mma<DP>::rs(acc, frag(pa, kk), mnmaj<D>(Ks, BKV, kk), 1);
      wg_commit();
    };
    auto wait_full = [&](int n) {
      mbar_wait(&full[n % NST], (n / NST) & 1);
    };
    auto release = [&](int n) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[n % NST]);
    };
    // dS of tile n from S (x) and dP (y), into x; the mask per element
    // unless the whole tile is allowed (as in fwd_kernel)
    auto grad = [&](float (&x)[BKV / 2], const float (&y)[BKV / 2], int n) {
      const int k0 = k_begin + n * BKV;
      const int* km = kms + (n % NST) * BKV;
      const int u = kflag[n % NST];
      const bool whole =
          u >= 0 && allowed(qm_r[0], u) && allowed(qm_r[1], u) &&
          (!pos || (k0 >= max(klo[0], klo[1]) &&
                    k0 + BKV - 1 <= min(khi[0], khi[1])));
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) {
        const int r = rsel(e), c = col(e, t), kp = k0 + c;
        const bool ok = whole || (allowed(qm_r[r], km[c]) &&
                                  (!pos || (kp >= klo[r] && kp <= khi[r])));
        float tc = 0.f;
        const float z = CAP ? logit<CAP>(x[e], o, inv_cap, tc) * LOG2E
                            : x[e] * sl2;
        const float p = ok ? exp2f(z - lse_r[r]) : 0.f;
        float ds = p * (y[e] - del_r[r]);
        if constexpr (CAP) ds *= 1.f - tc * tc;
        x[e] = ds;
      }
    };

    // the scores of tile n + 1 run beside dQ += dS_n.K_n; the last tile is
    // peeled, so that the pipeline has one shape on every path and ptxas
    // can see which product each wait retires
    mbar_wait(qbar, 0);
    if (ntiles > 0) {
      float s0[BKV / 2], dp0[BKV / 2];
      wait_full(0);
      wg_fence();
      scores(s0, dp0, 0);
      wg_wait_all();
      fence_regs(s0);
      fence_regs(dp0);
      grad(s0, dp0, 0);
      to_frags<BKV>(pa, s0);
      for (int n = 0; n + 1 < ntiles; ++n) {
        float s[BKV / 2], dp[BKV / 2];
        wait_full(n + 1);
        fence_regs(acc);
        fence_regs(pa);
        wg_fence();
        scores(s, dp, n + 1);
        dsk(n);
        wg_wait<1>();  // S, dP of tile n + 1 are done; dQ may still run
        fence_regs(s);
        fence_regs(dp);
        grad(s, dp, n + 1);
        wg_wait_all();
        fence_regs(acc);
        fence_regs(pa);
        release(n);
        to_frags<BKV>(pa, s);
      }
      fence_regs(acc);
      fence_regs(pa);
      wg_fence();
      dsk(ntiles - 1);
      wg_wait_all();
      fence_regs(acc);
      fence_regs(pa);
      release(ntiles - 1);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qi[r] >= Sq) continue;
      bf16* op = dq + (((size_t)b * Sq + qi[r]) * H + hh[r]) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int c = 8 * j + 2 * t;
        if (c < D)
          *reinterpret_cast<uint32_t*>(op + c) = pack_f(
              acc[4 * j + 2 * r] * o.scale, acc[4 * j + 2 * r + 1] * o.scale);
      }
    }
  }
}

// -- backward: dk, dv ---------------------------------------------------------
template <int D>
struct DkvL {
  using C = Dims<D>;
  static constexpr int BK = C::DKV_BK, BQ = C::DKV_BQ, NST = 3;
  static constexpr int K_BYTES = BK * C::DP * 2, Q_BYTES = BQ * C::DP * 2;
  static constexpr int Q_OFF = 2 * K_BYTES;  // K, V; stage s: Q, then dO
  static constexpr int META_OFF = Q_OFF + NST * 2 * Q_BYTES;
  // split mode's exchange: P and 1 - t^2 (fp32, BQ / 2 a thread), dS (bf16
  // pairs, BQ / 4 a thread), indexed [entry][thread]: no bank conflicts
  static constexpr int X_OFF = META_OFF + NST * 3 * BQ * 4;
  static constexpr int X_BYTES = C::SPLIT ? (BQ + BQ / 4) * 4 * WG : 0;
  static constexpr int FLAG_OFF = X_OFF + X_BYTES;
  static constexpr int BAR_OFF = FLAG_OFF + 16;
  static constexpr int BYTES = BAR_OFF + (2 * NST + 1) * 8 + 1024;
};

// The q tiles a dk/dv block walks, the same on the producer's side and the
// consumers': head group jg (heads kvh * G + jg * pack ..), q tile qt (q rows
// qt * nq .., nq = BQ / pack); a tile that no key of the block may see by
// position is skipped.
struct QWalk {
  int n_it, ntq, nq, k0, bk, Sq;
  Opts o;
  __device__ int next(int it) const {  // the first live tile from it on
    while (it < n_it && !live(it)) ++it;
    return it;
  }
  __device__ bool live(int it) const {
    const int qt = it % ntq;
    const int qs = o.q_offset + qt * nq;
    const int qe = o.q_offset + min(qt * nq + nq, Sq) - 1;
    if (o.causal && qe < k0) return false;
    if (o.window >= 0 && qs - (k0 + bk - 1) > o.window) return false;
    return true;
  }
};

// dv = sum_q P^T dO, dk = scale * sum_q dS^T Q over the group's q heads.
// grid (ceil(Skv / BK), KVH, B). Not split: consumer warpgroup w owns keys
// [64 w, 64 w + 64) of the block, all of D. Split (D 256): both own the
// block's 64 keys; warpgroup 0 computes S^T, warpgroup 1 dP^T, and w owns
// columns [128 w, 128 w + 128) of dK and dV.
template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const int* __restrict__ qmeta, const int* __restrict__ kmeta,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv,
               int H, int KVH, int pack, Opts o) {
  using C = Dims<D>;
  using L = DkvL<D>;
  constexpr int BK = L::BK, BQ = L::BQ, DP = C::DP, NST = L::NST;
  constexpr bool SPLIT = C::SPLIT;
  constexpr int DW = SPLIT ? DP / 2 : DP;  // columns of dK / dV a thread owns
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1k(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(sm);
  bf16* Vs = Ks + BK * DP;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  uint64_t* empty = full + NST;
  uint64_t* kvbar = empty + NST;
  auto q_tile = [&](int s) {
    return reinterpret_cast<bf16*>(sm + L::Q_OFF + s * 2 * L::Q_BYTES);
  };
  auto meta = [&](int s) {  // qm, lse (base 2), delta of each tile column
    return reinterpret_cast<int*>(sm + L::META_OFF + s * 3 * BQ * 4);
  };
  int* qflag = reinterpret_cast<int*>(sm + L::FLAG_OFF);

  const int G = H / KVH, nq = BQ / pack;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int ntq = (Sq + nq - 1) / nq;
  const QWalk walk{(G / pack) * ntq, ntq, nq, k0, BK, Sq, o};

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1 + 32);
      mbar_init(&empty[s], 4 * NCW);
    }
    mbar_init(kvbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCW * WG) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x < NCW * WG + 32) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * L::K_BYTES);
        load_tile<D>(Ks, BK, &tk, kvbar, kvh, k0, b);
        load_tile<D>(Vs, BK, &tv, kvbar, kvh, k0, b);
      }
      int n = 0;
      for (int it = 0; it < walk.n_it; ++it) {
        if (!walk.live(it)) continue;
        const int s = n % NST, hg = kvh * G + (it / ntq) * pack;
        const int q0 = (it % ntq) * nq;
        mbar_wait(&empty[s], ((n / NST) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * L::Q_BYTES);
          load_tile<D>(q_tile(s), BQ, &tq, &full[s], hg, q0, b);
          load_tile<D>(q_tile(s) + BQ * DP, BQ, &tdo, &full[s], hg, q0, b);
        }
        int* qm = meta(s);
        float* ls = reinterpret_cast<float*>(qm + BQ);
        float* dl = ls + BQ;
        const int first = qmeta[(size_t)b * Sq + q0];  // q0 < Sq
        bool same = true;
        for (int c = lane; c < BQ; c += 32) {
          const int i = q0 + c / pack, h = hg + c % pack;
          const bool in = i < Sq;
          const size_t hr = ((size_t)b * H + h) * Sq + i;
          qm[c] = in ? qmeta[(size_t)b * Sq + i] : 0;
          ls[c] = in ? lse[hr] * LOG2E : 0.f;
          dl[c] = in ? delta[hr] : 0.f;
          same = same && qm[c] == first;
        }
        same = __all_sync(0xffffffffu, same);
        if (lane == 0) qflag[s] = same ? first : -1;
        mbar_arrive(&full[s]);
        ++n;
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int wg = threadIdx.x / WG, tid = threadIdx.x % WG;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const float inv_cap = o.softcap > 0.f ? 1.f / o.softcap : 0.f;
    const float sl2 = o.scale * LOG2E;
    const bool pos = by_pos(o);
    const int kr0 = SPLIT ? 0 : wg * 64;  // the warpgroup's first key row
    int kp[2], km_r[2], qlo[2], qhi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      kp[r] = k0 + kr0 + warp * 16 + g + 8 * r;
      km_r[r] = kp[r] < Skv ? kmeta[(size_t)b * Skv + kp[r]] : 0;
      qlo[r] = query_lo(kp[r], o);
      qhi[r] = query_hi(kp[r], o);
    }
    float dka[DW / 2], dva[DW / 2];
#pragma unroll
    for (int i = 0; i < DW / 2; ++i) dka[i] = dva[i] = 0.f;
    uint32_t pf[BQ / 4], df[BQ / 4];  // P^T, dS^T as A operands
    auto wait_full = [&](int n) {
      mbar_wait(&full[n % NST], (n / NST) & 1);
    };
    auto release = [&](int n) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[n % NST]);
    };
    // S^T = K.Q^T into x and dP^T = V.dO^T into y (rows: keys, columns: the
    // tile's q rows), issued; split: warpgroup 0 takes S^T, 1 takes dP^T,
    // both into x
    auto scores = [&](float (&x)[BQ / 2], float (&y)[BQ / 2], int n) {
      const bf16* Qs = q_tile(n % NST);
      const bf16* Os = Qs + BQ * DP;
      if constexpr (SPLIT) {
        const bf16* A = wg == 0 ? Ks : Vs;
        const bf16* Bt = wg == 0 ? Qs : Os;
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          Mma<BQ>::ss(x, kmaj<D>(A, BK, 0, kk), kmaj<D>(Bt, BQ, 0, kk), kk);
      } else {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          Mma<BQ>::ss(x, kmaj<D>(Ks, BK, kr0, kk), kmaj<D>(Qs, BQ, 0, kk), kk);
          Mma<BQ>::ss(y, kmaj<D>(Vs, BK, kr0, kk), kmaj<D>(Os, BQ, 0, kk), kk);
        }
      }
      wg_commit();
    };
    // dV += P^T.dO and dK += dS^T.Q of tile n over the columns this
    // warpgroup owns, issued
    auto products = [&](int n) {
      const bf16* Qs = q_tile(n % NST);
      const bf16* Os = Qs + BQ * DP;
      const int c0 = SPLIT ? wg * (C::NCH / 2) : 0;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        Mma<DW>::rs(dva, frag(pf, kk), mnmaj<D>(Os, BQ, kk, c0), 1);
        Mma<DW>::rs(dka, frag(df, kk), mnmaj<D>(Qs, BQ, kk, c0), 1);
      }
      wg_commit();
    };
    // P^T of tile n (walk position it) from S^T in x, into x; tcap gets 1 -
    // tanh^2 of each logit
    // (the mask per element unless the whole tile is allowed, as in
    // fwd_kernel; base-2 exponentials)
    auto prob = [&](float (&x)[BQ / 2], float (&tcap)[BQ / 2], int n,
                    int it) {
      const int qs = o.q_offset + (it % ntq) * nq;
      const int* qm = meta(n % NST);
      const float* ls = reinterpret_cast<const float*>(qm + BQ);
      const int u = qflag[n % NST];
      const bool whole =
          u >= 0 && allowed(u, km_r[0]) && allowed(u, km_r[1]) &&
          (!pos || (qs >= max(qlo[0], qlo[1]) &&
                    qs + nq - 1 <= min(qhi[0], qhi[1])));
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int r = rsel(e), c = col(e, t), qp = qs + c / pack;
        const bool ok = whole || (allowed(qm[c], km_r[r]) &&
                                  (!pos || (qp >= qlo[r] && qp <= qhi[r])));
        float tc = 0.f;
        const float z = CAP ? logit<CAP>(x[e], o, inv_cap, tc) * LOG2E
                            : x[e] * sl2;
        x[e] = ok ? exp2f(z - ls[c]) : 0.f;
        tcap[e] = 1.f - tc * tc;
      }
    };
    // P^T into x and dS^T into y, from S^T in x and dP^T in y
    auto grad = [&](float (&x)[BQ / 2], float (&y)[BQ / 2], int n, int it) {
      float tcap[BQ / 2];
      prob(x, tcap, n, it);
      const float* dl =
          reinterpret_cast<const float*>(meta(n % NST)) + 2 * BQ;
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        float ds = x[e] * (y[e] - dl[col(e, t)]);
        if constexpr (CAP) ds *= tcap[e];
        y[e] = ds;
      }
    };
    mbar_wait(kvbar, 0);

    int it = walk.next(0);
    if constexpr (!SPLIT && DP <= 80) {
      // as fwd_kernel: S^T and dP^T of the next tile run beside the dV and
      // dK products of this one (at D <= 72 the registers hold both); the
      // last tile is peeled so that the pipeline has one shape
      if (it < walk.n_it) {
        float x[BQ / 2], y[BQ / 2];
        wait_full(0);
        wg_fence();
        scores(x, y, 0);
        wg_wait_all();
        fence_regs(x);
        fence_regs(y);
        grad(x, y, 0, it);
        to_frags<BQ>(pf, x);
        to_frags<BQ>(df, y);
        int n = 0;
        for (int nx = walk.next(it + 1); nx < walk.n_it;
             it = nx, nx = walk.next(it + 1), ++n) {
          float x2[BQ / 2], y2[BQ / 2];
          wait_full(n + 1);
          fence_regs(dka);
          fence_regs(dva);
          fence_regs(pf);
          fence_regs(df);
          wg_fence();
          scores(x2, y2, n + 1);
          products(n);
          wg_wait<1>();
          fence_regs(x2);
          fence_regs(y2);
          grad(x2, y2, n + 1, nx);
          wg_wait_all();
          fence_regs(dka);
          fence_regs(dva);
          fence_regs(pf);
          fence_regs(df);
          release(n);
          to_frags<BQ>(pf, x2);
          to_frags<BQ>(df, y2);
        }
        fence_regs(dka);
        fence_regs(dva);
        fence_regs(pf);
        fence_regs(df);
        wg_fence();
        products(n);
        wg_wait_all();
        fence_regs(dka);
        fence_regs(dva);
        fence_regs(pf);
        fence_regs(df);
        release(n);
      }
    } else {
      float* xp = reinterpret_cast<float*>(sm + L::X_OFF);  // split only
      float* xt = xp + (BQ / 2) * WG;
      uint32_t* xd = reinterpret_cast<uint32_t*>(xt + (BQ / 2) * WG);
      for (int n = 0; it < walk.n_it; it = walk.next(it + 1), ++n) {
        float x[BQ / 2], y[BQ / 2];
        wait_full(n);
        wg_fence();
        scores(x, y, n);
        wg_wait_all();
        fence_regs(x);
        fence_regs(y);
        if constexpr (SPLIT) {
          // P and 1 - t^2 cross from warpgroup 0, dS from warpgroup 1
          const float* dl = reinterpret_cast<const float*>(meta(n % NST)) +
                            2 * BQ;
          if (wg == 0) {
            float tc[BQ / 2];
            prob(x, tc, n, it);
#pragma unroll
            for (int e = 0; e < BQ / 2; ++e) {
              xp[e * WG + tid] = x[e];
              if constexpr (CAP) xt[e * WG + tid] = tc[e];
            }
          }
          bar_sync(1, 2 * WG);
          if (wg == 1) {
#pragma unroll
            for (int e = 0; e < BQ / 2; ++e) {
              float ds = xp[e * WG + tid] * (x[e] - dl[col(e, t)]);
              if constexpr (CAP) ds *= xt[e * WG + tid];
              y[e] = ds;
              x[e] = xp[e * WG + tid];
            }
            to_frags<BQ>(df, y);
#pragma unroll
            for (int i = 0; i < BQ / 4; ++i) xd[i * WG + tid] = df[i];
          }
          bar_sync(2, 2 * WG);
          if (wg == 0) {
#pragma unroll
            for (int i = 0; i < BQ / 4; ++i) df[i] = xd[i * WG + tid];
          }
        } else {
          grad(x, y, n, it);
          to_frags<BQ>(df, y);
        }
        to_frags<BQ>(pf, x);
        fence_regs(dka);
        fence_regs(dva);
        fence_regs(pf);
        fence_regs(df);
        wg_fence();
        products(n);
        wg_wait_all();
        fence_regs(dka);
        fence_regs(dva);
        fence_regs(pf);
        fence_regs(df);
        release(n);
      }
    }

    const int d0 = SPLIT ? wg * DW : 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kp[r] >= Skv) continue;
      const size_t off = (((size_t)b * Skv + kp[r]) * KVH + kvh) * D + d0;
#pragma unroll
      for (int j = 0; j < DW / 8; ++j) {
        const int c = 8 * j + 2 * t;
        if (d0 + c < D) {
          *reinterpret_cast<uint32_t*>(dk + off + c) =
              pack_f(dka[4 * j + 2 * r] * o.scale,
                     dka[4 * j + 2 * r + 1] * o.scale);
          *reinterpret_cast<uint32_t*>(dv + off + c) =
              pack_f(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// -- the first product of each kind, alone ------------------------------------
// One 64-row tile at head dim D: S = Q.K^T (both K-major, from shared
// memory) and O = bf16(S).V (A from registers, V MN-major), Q, K and V [64,
// D] loaded by TMA -> s_out [64, 64] fp32, o_out [64, D] fp32. The smallest
// check of the descriptors, swizzles and fragment layouts the kernels use.
template <int D>
__global__ void __launch_bounds__(2 * WG, 1)
    probe_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 float* __restrict__ s_out, float* __restrict__ o_out) {
  constexpr int DP = Dims<D>::DP, TILE = 64 * DP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1k(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(sm);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + 3 * TILE * 2);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == WG) {
    mbar_expect_tx(bar, 3 * TILE * 2);
    load_tile<D>(Qs, 64, &tq, bar, 0, 0, 0);
    load_tile<D>(Qs + TILE, 64, &tk, bar, 0, 0, 0);
    load_tile<D>(Qs + 2 * TILE, 64, &tv, bar, 0, 0, 0);
  }
  if (threadIdx.x >= WG) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  mbar_wait(bar, 0);
  float s[32], o[DP / 2];
  uint32_t pa[16];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    Mma<64>::ss(s, kmaj<D>(Qs, 64, 0, kk), kmaj<D>(Qs + TILE, 64, 0, kk), kk);
  wg_commit();
  wg_wait_all();
  fence_regs(s);
#pragma unroll
  for (int e = 0; e < 32; ++e)
    s_out[(warp * 16 + g + 8 * rsel(e)) * 64 + col(e, t)] = s[e];
  to_frags<64>(pa, s);
  fence_regs(o);
  fence_regs(pa);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Mma<DP>::rs(o, frag(pa, kk), mnmaj<D>(Qs + 2 * TILE, 64, kk), 1);
  wg_commit();
  wg_wait_all();
  fence_regs(o);
  fence_regs(pa);
#pragma unroll
  for (int e = 0; e < DP / 2; ++e)
    if (col(e, t) < D)
      o_out[(warp * 16 + g + 8 * rsel(e)) * D + col(e, t)] = o[e];
}

// -- host: tensor maps --------------------------------------------------------
// A [B, S, heads, D] bf16 tensor, box (CW, nh, rows, 1), swizzled as the
// kernels' tiles are (sm90.cuh encodes and caches it).
template <int D>
static int bshd_map(CUtensorMap* map, const void* ptr, int B, int S,
                    int heads, int nh, int rows) {
  using C = Dims<D>;
  TmapArgs a{};
  a.ptr = ptr;
  a.dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  a.rank = 4;
  a.swizzle = C::CW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_32B;
  a.l2 = CU_TENSOR_MAP_L2_PROMOTION_L2_128B;
  a.dims[0] = D;
  a.dims[1] = heads;
  a.dims[2] = S;
  a.dims[3] = B;
  a.strides[0] = (cuuint64_t)D * 2;
  a.strides[1] = (cuuint64_t)heads * D * 2;
  a.strides[2] = (cuuint64_t)S * heads * D * 2;
  a.box[0] = C::CW;
  a.box[1] = nh;
  a.box[2] = rows;
  a.box[3] = 1;
  return tmap_encode(map, a);
}

// Rows (q head, q row) pairs share a tile when the queries are few: pack =
// G when Sq < 64 and the group G divides 32, else 1 (one head a tile).
// kernels/flash_attention.py::launch_plan follows the same rule.
static int pack_of(int Sq, int H, int KVH) {
  const int G = H / KVH;
  return Sq < 64 && G > 1 && 32 % G == 0 ? G : 1;
}

template <int D, bool CAP>
int fwd(const void* q, const void* k, const void* v, const void* qm,
        const void* km, void* out, void* lse, int B, int Sq, int Skv, int H,
        int KVH, Opts o, cudaStream_t st) {
  using L = FwdL<D>;
  static const int attr = set_smem(fwd_kernel<D, CAP>, L::BYTES);
  if (attr) return attr;
  const int pack = pack_of(Sq, H, KVH), nq = L::BQ / pack;
  CUtensorMap tq, tk, tv;
  if (int e = bshd_map<D>(&tq, q, B, Sq, H, pack, nq)) return e;
  if (int e = bshd_map<D>(&tk, k, B, Skv, KVH, 1, L::BKV)) return e;
  if (int e = bshd_map<D>(&tv, v, B, Skv, KVH, 1, L::BKV)) return e;
  dim3 grid((Sq + nq - 1) / nq, H / pack, B);
  fwd_kernel<D, CAP><<<grid, L::THREADS, L::BYTES, st>>>(
      tq, tk, tv, (const int*)qm, (const int*)km, (bf16*)out, (float*)lse, Sq,
      Skv, H, KVH, pack, o);
  RETURN_IF_ERR();
  return 0;
}

template <int D, bool CAP>
int bwd(const void* q, const void* k, const void* v, const void* out,
        const void* dout, const void* qm, const void* km, const void* lse,
        void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Skv,
        int H, int KVH, Opts o, cudaStream_t st) {
  using Lq = DqL<D>;
  using Lk = DkvL<D>;
  static const int attr_q = set_smem(dq_kernel<D, CAP>, Lq::BYTES);
  static const int attr_k = set_smem(dkv_kernel<D, CAP>, Lk::BYTES);
  if (attr_q) return attr_q;
  if (attr_k) return attr_k;
  const int pack = pack_of(Sq, H, KVH);
  CUtensorMap tq, tdo, tk, tv;
  const int nq = Lq::BQ / pack;
  if (int e = bshd_map<D>(&tq, q, B, Sq, H, pack, nq)) return e;
  if (int e = bshd_map<D>(&tdo, dout, B, Sq, H, pack, nq)) return e;
  if (int e = bshd_map<D>(&tk, k, B, Skv, KVH, 1, Lq::BKV)) return e;
  if (int e = bshd_map<D>(&tv, v, B, Skv, KVH, 1, Lq::BKV)) return e;
  const int rows = B * Sq * H;
  delta_kernel<<<(rows + DELTA_ROWS - 1) / DELTA_ROWS, 32 * DELTA_ROWS, 0,
                 st>>>((const bf16*)out, (const bf16*)dout, (float*)delta,
                       rows, Sq, H, D);
  RETURN_IF_ERR();
  dim3 gq((Sq + nq - 1) / nq, H / pack, B);
  dq_kernel<D, CAP><<<gq, Lq::THREADS, Lq::BYTES, st>>>(
      tq, tdo, tk, tv, (const int*)qm, (const int*)km, (const float*)lse,
      (const float*)delta, (bf16*)dq, Sq, Skv, H, KVH, pack, o);
  RETURN_IF_ERR();
  const int nqk = Lk::BQ / pack;
  if (int e = bshd_map<D>(&tq, q, B, Sq, H, pack, nqk)) return e;
  if (int e = bshd_map<D>(&tdo, dout, B, Sq, H, pack, nqk)) return e;
  if (int e = bshd_map<D>(&tk, k, B, Skv, KVH, 1, Lk::BK)) return e;
  if (int e = bshd_map<D>(&tv, v, B, Skv, KVH, 1, Lk::BK)) return e;
  dim3 gk((Skv + Lk::BK - 1) / Lk::BK, KVH, B);
  dkv_kernel<D, CAP><<<gk, THREADS, Lk::BYTES, st>>>(
      tq, tdo, tk, tv, (const int*)qm, (const int*)km, (const float*)lse,
      (const float*)delta, (bf16*)dk, (bf16*)dv, Sq, Skv, H, KVH, pack, o);
  RETURN_IF_ERR();
  return 0;
}

template <int D>
int probe(const void* q, const void* k, const void* v, void* s_out,
          void* o_out, cudaStream_t st) {
  constexpr int BYTES = 3 * 64 * Dims<D>::DP * 2 + 8 + 1024;
  static const int attr = set_smem(probe_kernel<D>, BYTES);
  if (attr) return attr;
  CUtensorMap tq, tk, tv;
  if (int e = bshd_map<D>(&tq, q, 1, 64, 1, 1, 64)) return e;
  if (int e = bshd_map<D>(&tk, k, 1, 64, 1, 1, 64)) return e;
  if (int e = bshd_map<D>(&tv, v, 1, 64, 1, 1, 64)) return e;
  probe_kernel<D><<<1, 2 * WG, BYTES, st>>>(tq, tk, tv, (float*)s_out,
                                            (float*)o_out);
  RETURN_IF_ERR();
  return 0;
}

}  // namespace fa

#define FA_HEAD_DIMS(X) X(64) X(72) X(128) X(256)

// out [B, Sq, H, D] bf16, lse [B, H, Sq] fp32. D is 64, 72, 128 or 256;
// softcap 0 = none, window < 0 = none. q, k, v 16-byte aligned.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* q_meta, const void* kv_meta,
                                   void* out, void* lse, int B, int Sq, int Skv,
                                   int H, int KVH, int D, int causal,
                                   int q_offset, float scale, float softcap,
                                   int window, void* stream) {
  if (KVH <= 0 || H % KVH || Skv <= 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Sq <= 0) return 0;
  const fa::Opts o{causal, q_offset, window, scale, softcap};
  cudaStream_t st = (cudaStream_t)stream;
#define FA_FWD(DD)                                                          \
  if (D == DD)                                                              \
    return o.softcap > 0.f                                                  \
               ? fa::fwd<DD, true>(q, k, v, q_meta, kv_meta, out, lse, B,   \
                                   Sq, Skv, H, KVH, o, st)                  \
               : fa::fwd<DD, false>(q, k, v, q_meta, kv_meta, out, lse, B,  \
                                    Sq, Skv, H, KVH, o, st);
  FA_HEAD_DIMS(FA_FWD)
#undef FA_FWD
  return (int)cudaErrorInvalidValue;
}

// dq [B, Sq, H, D], dk/dv [B, Skv, KVH, D] bf16; delta [B, H, Sq] fp32
// scratch, written by the delta kernel (rowsum(dO * O)), read by dq and
// dk/dv.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout,
                                   const void* q_meta, const void* kv_meta,
                                   const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int B, int Sq, int Skv,
                                   int H, int KVH, int D, int causal,
                                   int q_offset, float scale, float softcap,
                                   int window, void* stream) {
  if (KVH <= 0 || H % KVH || Skv <= 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Sq <= 0) return 0;
  const fa::Opts o{causal, q_offset, window, scale, softcap};
  cudaStream_t st = (cudaStream_t)stream;
#define FA_BWD(DD)                                                           \
  if (D == DD)                                                               \
    return o.softcap > 0.f                                                   \
               ? fa::bwd<DD, true>(q, k, v, out, dout, q_meta, kv_meta, lse, \
                                   delta, dq, dk, dv, B, Sq, Skv, H, KVH, o, \
                                   st)                                       \
               : fa::bwd<DD, false>(q, k, v, out, dout, q_meta, kv_meta,     \
                                    lse, delta, dq, dk, dv, B, Sq, Skv, H,   \
                                    KVH, o, st);
  FA_HEAD_DIMS(FA_BWD)
#undef FA_BWD
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of a kernel at head dim D (which: 0 forward, 1 dq,
// 2 dk/dv), in bytes; -1 for another head dim.
extern "C" int flash_attention_smem(int D, int which) {
#define FA_SMEM(DD)                                               \
  if (D == DD)                                                    \
    return which == 0 ? fa::FwdL<DD>::BYTES                       \
                      : which == 1 ? fa::DqL<DD>::BYTES : fa::DkvL<DD>::BYTES;
  FA_HEAD_DIMS(FA_SMEM)
#undef FA_SMEM
  return -1;
}

// The probe tile (probe_kernel): q, k, v [64, D] bf16 -> s_out [64, 64], o_out
// [64, D] fp32.
extern "C" int flash_wgmma_probe(const void* q, const void* k, const void* v,
                                 void* s_out, void* o_out, int D,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define FA_PROBE(DD) \
  if (D == DD) return fa::probe<DD>(q, k, v, s_out, o_out, st);
  FA_HEAD_DIMS(FA_PROBE)
#undef FA_PROBE
  return (int)cudaErrorInvalidValue;
}
