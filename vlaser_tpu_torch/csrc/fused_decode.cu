// Fused decoder stack (Qwen2-family layers, R rows) for Hopper: one
// persistent cooperative kernel a stack.
//
// Replaces: vlaser_tpu/kernels/fused_decode.py :: fused_int8_stack (the
// Pallas kernel built by _make_kernel; pallas_call at fused_decode.py:337),
// both weight modes: int8 weights with per-output-channel fp32 scales, and
// bf16 weights with unit scales.
//
// Two callers, both R-row GEMV chains against an external K/V:
//  - the VLA denoise suffix (policy/fused_infer.py): R = 4 or 5 action rows
//    of the 768-wide, 28-layer action expert over the prompt's K/V;
//  - the VLM decode (inference/fused_runner.py): R = 1 token of the
//    1536-wide, 28-layer Qwen2.5-1.5B over the whole growing KV cache
//    (E = prompt bucket + new tokens, up to max_position_embeddings).
//
// What bounds it on the H100: every layer streams its weights once for R
// rows, ~2*R FLOP per weight element: device-memory bandwidth (3.35 TB/s).
// Int8 weights are ~23 MB per expert layer (0.66 GB a call) and ~47 MB per
// VLM layer (1.31 GB a token); bf16 weights twice that. At a few
// microseconds of traffic per GEMV, the steps between the GEMVs
// (reductions, norms, attention) and any launch between them weigh as much
// as the stream itself; at decode the attention reads the cache too (2 x E
// x 512 bytes a layer).
//
// What the design does about it: the whole stack is ONE cooperative launch
// (as the TPU kernel is one pallas_call). Its grid is as many blocks as are
// co-resident (the occupancy query, at most two per SM); the blocks walk
// every layer's phases and meet at a grid barrier after each:
//   1. q/k/v GEMV partials (the RMSNorm of the rows computed by each block
//      for its own K chunk, in one fixed order, so no norm phase);
//   2. reduce + scale + bias + rope, write q and this layer's self K/V;
//   3. attention, split-KV: (kv head, row, key chunk) items dealt over all
//      blocks, each scoring its chunk for every q head of the group and
//      writing an fp32 partial (m, l, o[128]) per q head;
//   4. o GEMV partials, each block combining the attention partials of its
//      own K chunk (fixed chunk order) on the way in;
//   5. residual: xn = bf16(x + o);
//   6. gate/up GEMV partials (RMSNorm of xn on the fly);
//   7. down GEMV partials, each block forming bf16(silu(g) * u) of its K
//      chunk from the gate/up partials on the way in;
//   8. residual: x = bf16(xn + down).
// The GEMVs keep the earlier design: weights read exactly once, 8 columns
// per thread (8 bytes of int8 or 16 of bf16), neighbouring threads on
// neighbouring columns, 8 rows in flight per warp (the next 8 loading while
// these are used), the activation rows in shared memory (bf16, the values
// they hold; a K chunk of up to 512 columns), the scale
// applied to the [R, N] output (fused_decode.py:159-167); K split across
// items by a plan that depends on the shapes alone (not on the grid). The
// elementwise phases sum each element's split-K partials over a group of
// lanes (8 partials a lane, one load round) and add the lanes in a fixed
// tree, so two calls give equal bits. Data written inside the kernel is
// read with ld.global.cg (L2, never a stale L1 line). Masks stay fp32
// (NEG_INF = -1e30 would overflow half precision); a chunk whose keys are
// all masked has m = -1e30 and weight exp(m - M) = 0 in the combine. No
// scores live in shared memory beyond one chunk, so any cache length fits.
// R is a runtime argument, up to 8 (the GEMV accumulators are sized 1, 4,
// 5 or 8 rows); head_dim is 128. While the light rope phase runs, each
// block prefetches the external K/V rows of its own attention items into
// L2. Prefetching the next GEMV's weights into L2 during the serial
// phases, as the TPU kernel prefetches layer l+1's matrices, was measured
// slower here (it queued ahead of the serial phases' loads), and so was
// finishing each tile in the block that wrote its last partial instead of
// in a phase of its own (that block's serial sum outlasts a grid barrier):
// neither is done.
#include "common.cuh"

namespace dec {

constexpr int RMAX = 8;
constexpr int D = 128;            // head_dim: the action expert's and Qwen2.5's
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GV_COLS = 256;      // 32 lanes x 8 columns
constexpr int GV_UNROLL = 8;      // the split plan's batch of rows a warp
constexpr int KCHUNK_MAX = 512;
constexpr int TARGET_BLOCKS = 264;  // the split-K plan's wave (two per SM)
constexpr int BLOCKS_PER_SM = 2;
constexpr int GQ_MAX = 8;         // q heads per kv head
constexpr int KV_CHUNK_MAX = THREADS;  // keys of an attention item
constexpr int PART = 2 + D;       // an attention partial: m, l, o[D]

// Shared memory, one layout per kind of phase.
struct GemvSmem {
  bf16 as[RMAX * KCHUNK_MAX];  // activation rows (bf16 values)
  float red[WARPS * 4 * GV_COLS];
  float rr[RMAX];
  float cm[GQ_MAX * RMAX * 4], cl[GQ_MAX * RMAX * 4];  // combine: M, L
  int last;  // the last block to leave (grid_release)
};
struct AttnSmem {
  float qs[GQ_MAX * D];
  float sc[GQ_MAX * KV_CHUNK_MAX];
  float pv[WARPS * GQ_MAX * D];
  float ml[2 * GQ_MAX];
};
union Smem {
  GemvSmem g;
  AttnSmem a;
};

struct Plan {
  int ks_qkv, kc_qkv, ks_o, kc_o, ks_gu, kc_gu, ks_d, kc_d;
};

struct Args {
  const bf16* x;
  const void* cos;
  const void* sin;
  const float *selfm, *extm, *ln1, *ln2, *bq, *bk, *bv;
  const char *wq, *wk, *wv, *wo, *wg, *wu, *wd;  // [L, K, N], bytes
  const float *sq, *sk, *sv, *so, *sg, *su, *sd;
  const bf16 *kext, *vext;
  const bf16* q;  // the roped q rows the attention reads (= qr in the stack)
  bf16 *xout, *kself, *vself, *xn, *qr;
  float* part;   // GEMV partials: q/k/v, o and gate/up in turn
  float* part2;  // down's partials (read beside gate/up's)
  float* apart;  // attention partials [H, R, nch, PART]
  unsigned* bar;  // [3], zero between calls: arrivals, barriers passed,
                  // departures
  unsigned long long* trace;  // null, or 1 + 8 L phase end times (ns)
  int L, R, C, H, KVH, I, E, rope_f32, kv_chunk, nch, wbytes;
  float eps;
  Plan p;
};

// -- loads --------------------------------------------------------------------
// Data written earlier in the same launch: through L2 (ld.global.cg).
__device__ __forceinline__ float ldf(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldb(const bf16* p) {
  return __bfloat162float(__ldcg(p));
}

// Eight weight columns as one load: 8 bytes of int8, 16 bytes of bf16.
template <typename W>
struct Lane8;
template <>
struct Lane8<int8_t> {
  typedef uint2 T;
  static __device__ __forceinline__ void unpack(const T& w, float* f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = (float)(int8_t)((w.x >> (8 * i)) & 0xffu);
      f[4 + i] = (float)(int8_t)((w.y >> (8 * i)) & 0xffu);
    }
  }
};
template <>
struct Lane8<bf16> {
  typedef uint4 T;
  static __device__ __forceinline__ void unpack(const T& w, float* f) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(p[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
};

// -- the grid barrier ----------------------------------------------------------
// bar[0] counts arrivals (gridDim.x a barrier), bar[1] is the number of the
// last barrier that every block has reached: the block whose arrival
// completes barrier `gen` stores it, the others wait for it, so the
// arrivals' atomics and the waits' loads fall on different words. As in
// CUTLASS's barrier, thread 0 arrives with release and waits with acquire
// semantics between two __syncthreads, which extend them to its block.
// A stuck barrier traps after ~10^10 cycles instead of hanging the device.
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& gen) {
  ++gen;
  __syncthreads();
  if (threadIdx.x == 0) {
    if (add_acq_rel(bar, 1u) == gen * gridDim.x - 1) {
      st_release(bar + 1, gen);
    } else {
      const long long t0 = clock64();
      while (ld_acquire(bar + 1) < gen)
        if (clock64() - t0 > 10000000000LL) __trap();
    }
  }
  __syncthreads();
}

// At the end: the last block to leave zeroes the counters for the next call
// (every block has passed its last wait by then).
__device__ __forceinline__ void grid_release(unsigned* bar, int& last) {
  __syncthreads();
  if (threadIdx.x == 0) last = add_acq_rel(bar + 2, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last)
    for (int i = threadIdx.x; i < 3; i += blockDim.x) bar[i] = 0;
}

// Sum of the split-K partials of element (r, n), in split order (8 loads
// in flight; the adds in the same order whatever the unroll).
__device__ __forceinline__ float reduce_parts(const float* part, int ksplit,
                                              int R, int N, int r, int n) {
  const size_t stride = (size_t)R * N;
  const float* p = part + (size_t)r * N + n;
  float v = 0.f;
  for (int s = 0; s < ksplit; s += 8) {
    float t[8];  // past ksplit: +0, which leaves the sum's bits alone
#pragma unroll
    for (int i = 0; i < 8; ++i)
      t[i] = s + i < ksplit ? ldf(p + (s + i) * stride) : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) v += t[i];
  }
  return v;
}

// The same sum spread over a group of g lanes (a power of two, 8 partials a
// lane at most): lane j of the group adds splits 8 j .. 8 j + 7 in order,
// then the group's lanes are added in a fixed tree (xor 1, 2, ...), which
// gives every lane of the group the same bits (a + b == b + a). Every lane
// of the warp calls it; a lane with !valid adds nothing.
__device__ __forceinline__ int group_lanes(int ksplit) {
  int g = 1;
  while (g * 8 < ksplit && g < 32) g <<= 1;
  return g;
}
__device__ __forceinline__ float reduce_wide(const float* part, int ksplit,
                                             int R, int N, int r, int n,
                                             int j, int g, bool valid) {
  float v = 0.f;
  if (valid) {
    const size_t stride = (size_t)R * N;
    const float* p = part + (size_t)r * N + n;
    float t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = 8 * j + i;
      t[i] = s < ksplit ? ldf(p + s * stride) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) v += t[i];
  }
  for (int o = 1; o < g; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// -- elementwise phases: every warp of the grid takes whole groups --------------
// Rotate-half rope of the bf16-rounded pair (a, b) in the dtype of the
// tables (fused_decode.py:176-180): with bf16 cos/sin each product and the
// sum round to bf16; with fp32 ones (the VLM decode) the products and the
// sum are fp32, rounded once.
__device__ __forceinline__ float rope_half(float a, float b, float c,
                                           float s, bool f32) {
  return f32 ? __fadd_rn(__fmul_rn(a, c), __fmul_rn(b, s))
             : bf(a * c) + bf(b * s);
}
__device__ __forceinline__ float table(const void* t, int i, bool f32) {
  return f32 ? static_cast<const float*>(t)[i]
             : __bfloat162float(static_cast<const bf16*>(t)[i]);
}

// q/k/v = parts * scale + bias (fp32) -> bf16 -> rotate-half rope. Writes
// roped q [R, H*D] and the layer's self k/v rows [R, KVH, D]. Units: the
// (row, q or k head, pair d / d + 64) pairs, then the (row, v column)s.
__device__ void qkv_post(const Args& a, int l) {
  const int R = a.R, QD = a.H * D, KD = a.KVH * D, half = D / 2;
  const int npairs = (a.H + a.KVH) * half, per_row = npairs + KD;
  const int ks = a.p.ks_qkv, g = group_lanes(ks), lane = threadIdx.x & 31;
  const float* pq = a.part;
  const float* pk = pq + (size_t)ks * R * QD;
  const float* pv = pk + (size_t)ks * R * KD;
  const float *sq = a.sq + (size_t)l * QD, *bq = a.bq + (size_t)l * QD;
  const float *sk = a.sk + (size_t)l * KD, *bk = a.bk + (size_t)l * KD;
  const float *sv = a.sv + (size_t)l * KD, *bv = a.bv + (size_t)l * KD;
  bf16* kself = a.kself + (size_t)l * R * KD;
  bf16* vself = a.vself + (size_t)l * R * KD;
  const bool f32 = a.rope_f32;
  const int units = R * per_row;
  for (int i0 = blockIdx.x * THREADS + threadIdx.x - lane; i0 < units * g;
       i0 += gridDim.x * THREADS) {
    const int i = i0 + lane, u = i / g, j = i % g;
    const bool valid = u < units;
    const int r = valid ? u / per_row : 0, idx = valid ? u % per_row : 0;
    const bool isv = idx >= npairs;
    const int hh = idx / half, d = idx % half;
    const bool isq = !isv && hh < a.H;
    const float* part = isv ? pv : isq ? pq : pk;
    const int N = isq ? QD : KD;
    const int c = isv ? idx - npairs : (isq ? hh : hh - a.H) * D + d;
    const float v1 = reduce_wide(part, ks, R, N, r, c, j, g, valid);
    const float v2 = reduce_wide(part, ks, R, N, r, c + half, j, g,
                                 valid && !isv);
    if (!valid || j) continue;
    if (isv) {
      vself[(size_t)r * KD + c] = __float2bfloat16(v1 * sv[c] + bv[c]);
      continue;
    }
    const float* sc = isq ? sq : sk;
    const float* bi = isq ? bq : bk;
    const float x1 = bf(v1 * sc[c] + bi[c]);
    const float x2 = bf(v2 * sc[c + half] + bi[c + half]);
    const float c1 = table(a.cos, r * D + d, f32);
    const float s1 = table(a.sin, r * D + d, f32);
    const float c2 = table(a.cos, r * D + d + half, f32);
    const float s2 = table(a.sin, r * D + d + half, f32);
    bf16* dst = isq ? a.qr + (size_t)r * QD : kself + (size_t)r * KD;
    dst[c] = __float2bfloat16(rope_half(x1, -x2, c1, s1, f32));
    dst[c + half] = __float2bfloat16(rope_half(x2, x1, c2, s2, f32));
  }
}

// out = bf16(in + parts * scale), elementwise over [R, C].
__device__ void residual(const Args& a, const float* part, int ksplit,
                         const float* scale, const bf16* in, bf16* out) {
  const int R = a.R, C = a.C, g = group_lanes(ksplit);
  const int lane = threadIdx.x & 31;
  for (int i0 = blockIdx.x * THREADS + threadIdx.x - lane; i0 < R * C * g;
       i0 += gridDim.x * THREADS) {
    const int i = i0 + lane, u = i / g, j = i % g;
    const bool valid = u < R * C;
    const int r = valid ? u / C : 0, n = valid ? u % C : 0;
    const float o = reduce_wide(part, ksplit, R, C, r, n, j, g, valid);
    if (valid && !j)
      out[u] = __float2bfloat16(ldb(in + u) + o * scale[n]);
  }
}

// -- GEMV phases --------------------------------------------------------------
// Where a GEMV's activation rows come from.
enum Src {
  SRC_RMS = 0,   // bf16(x * rsqrt(mean(x^2) + eps) * w), x [R, C]
  SRC_ATTN = 1,  // the attention rows, combined from their chunk partials
  SRC_SILU = 2   // bf16(silu(g) * u) from the gate/up partials
};

struct Seg {
  const char* w;  // [K, N] int8 or bf16
  float* part;    // [ksplit, R, N] fp32 partial sums
  int N;
};

__device__ __forceinline__ int tiles(int n) { return (n + GV_COLS - 1) / GV_COLS; }

// as[r, kk] <- row r, column k0 + kk of the activation, kk < kn.
__device__ void load_act(const Args& a, Smem& sm, int src, const bf16* x,
                         const float* w, const float* sg, const float* su,
                         int K, int k0, int kn) {
  const int R = a.R, tid = threadIdx.x;
  bf16* as = sm.g.as;
  if (src == SRC_RMS) {
    // sm.g.rr holds each row's rsqrt(mean(x^2) + eps) (gemv_phase)
    for (int i = tid; i < R * kn; i += THREADS) {
      const int r = i / kn, kk = i % kn;
      const float v = ldb(x + (size_t)r * K + k0 + kk);
      as[r * KCHUNK_MAX + kk] = __float2bfloat16(v * sm.g.rr[r] * w[k0 + kk]);
    }
  } else if (src == SRC_SILU) {
    const float* pg = a.part;
    const float* pu = a.part + (size_t)a.p.ks_gu * R * K;
    for (int i = tid; i < R * kn; i += THREADS) {
      const int r = i / kn, n = k0 + i % kn;
      const float g = reduce_parts(pg, a.p.ks_gu, R, K, r, n) * sg[n];
      const float u = reduce_parts(pu, a.p.ks_gu, R, K, r, n) * su[n];
      as[r * KCHUNK_MAX + i % kn] =
          __float2bfloat16(g * (1.f / (1.f + expf(-g))) * u);
    }
  } else {  // SRC_ATTN: K = H * D, column k = head k / D, dim k % D
    const int h0 = k0 / D, np = ((k0 + kn - 1) / D - h0 + 1) * R;
    const int lane = tid & 31, warp = tid >> 5, nch = a.nch;
    // M and L of each (head, row) the chunk touches: a warp a pair
    for (int pr = warp; pr < np; pr += WARPS) {
      const int h = h0 + pr / R, r = pr % R;
      const float* base = a.apart + (size_t)(h * R + r) * nch * PART;
      float M = -3.0e38f;
      for (int c = lane; c < nch; c += 32) M = fmaxf(M, ldf(base + c * PART));
      M = warp_max(M);
      float Ls = 0.f;
      for (int c = lane; c < nch; c += 32)
        Ls += expf(ldf(base + c * PART) - M) * ldf(base + c * PART + 1);
      Ls = warp_sum(Ls);
      if (lane == 0) {
        sm.g.cm[pr] = M;
        sm.g.cl[pr] = Ls;
      }
    }
    __syncthreads();
    // each element's sum over the chunks, in ng interleaved groups (fixed
    // by the shapes), the groups added in order
    const int nel = R * kn, ng = nel < THREADS ? THREADS / nel : 1;
    for (int i = tid; i < nel * ng; i += THREADS) {
      const int el = i % nel, grp = i / nel, r = el / kn, k = k0 + el % kn;
      const int pr = (k / D - h0) * R + r;
      const float* base =
          a.apart + (size_t)((k / D) * R + r) * nch * PART;
      const float M = sm.g.cm[pr];
      float o = 0.f;
      for (int c0 = grp; c0 < nch; c0 += 8 * ng) {  // 8 chunks in flight
        float mm[8], oo[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int c = c0 + u * ng;
          mm[u] = c < nch ? ldf(base + c * PART) : 0.f;
          oo[u] = c < nch ? ldf(base + c * PART + 2 + k % D) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (c0 + u * ng < nch) o += expf(mm[u] - M) * oo[u];
      }
      sm.g.red[grp * nel + el] = o;
    }
    __syncthreads();
    for (int el = tid; el < nel; el += THREADS) {
      const int r = el / kn, kk = el % kn;
      float o = 0.f;
      for (int grp = 0; grp < ng; ++grp) o += sm.g.red[grp * nel + el];
      as[r * KCHUNK_MAX + kk] =
          __float2bfloat16(o / sm.g.cl[((k0 + kk) / D - h0) * R + r]);
    }
  }
  __syncthreads();
}

// One GEMV phase: items (segment, 256-column tile, K split) dealt over the
// blocks; part[split, r, n] = sum_{k in split} act[r, k] * w[k, n]. `before`
// is the grid barrier that ends the phase before: each block issues its
// first item's first weight rows ahead of it (they never wait for the
// activation).
template <int RM, typename W, typename Before>
__device__ void gemv_phase(const Args& a, Smem& sm, int src, const bf16* x,
                           const float* lnw, const float* sg,
                           const float* su, const Seg* segs, int nseg, int K,
                           int kchunk, int ksplit, Before before) {
  const int R = a.R, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  typedef typename Lane8<W>::T LT;
  constexpr int UNR = GV_UNROLL, stride = WARPS * UNR;
  int per_split = 0;
  for (int s = 0; s < nseg; ++s) per_split += tiles(segs[s].N);
  const int items = per_split * ksplit;
  bool first = true;
  for (int it = blockIdx.x;; it += gridDim.x) {
    if (it >= items) {
      if (first) before();
      break;
    }
    const int split = it / per_split;
    int t = it % per_split, s = 0;
    while (t >= tiles(segs[s].N)) t -= tiles(segs[s].N), ++s;
    const Seg sg_ = segs[s];
    const int N = sg_.N, n_base = t * GV_COLS;
    const int k0 = split * kchunk, kn = min(kchunk, K - k0);
    const int n0 = n_base + lane * 8;
    // the first batch of weight rows loads while the activation is formed
    // (the weights do not wait for it)
    const W* wcol = reinterpret_cast<const W*>(sg_.w) + (size_t)k0 * N + n0;
    LT cur[UNR], nxt[UNR];
    auto load = [&](LT* dst, int kb) {
#pragma unroll
      for (int u = 0; u < UNR; ++u)
        dst[u] = kb + u < kn ? *reinterpret_cast<const LT*>(
                                   wcol + (size_t)(kb + u) * N)
                             : LT{};
    };
    int kb = warp * UNR;
    if (n0 < N && kb < kn) load(cur, kb);
    if (first) before();
    if (src == SRC_RMS && first) {
      // each row's mean square, once a phase: a thread's columns, then its
      // warp, then the warps in order (the same order in every block)
      float ss[RMAX];
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        ss[r] = 0.f;
        if (r < R) {
#pragma unroll 4
          for (int n = tid; n < K; n += THREADS) {
            const float v = ldb(x + (size_t)r * K + n);
            ss[r] += v * v;
          }
          ss[r] = warp_sum(ss[r]);
        }
      }
      if (lane == 0)
        for (int r = 0; r < R; ++r) sm.g.red[warp * RMAX + r] = ss[r];
      __syncthreads();
      if (tid < R) {
        float tt = 0.f;
        for (int w = 0; w < WARPS; ++w) tt += sm.g.red[w * RMAX + tid];
        sm.g.rr[tid] = rsqrtf(tt / K + a.eps);
      }
      __syncthreads();
    }
    first = false;
    load_act(a, sm, src, x, lnw, sg, su, K, k0, kn);
    const bf16* as = sm.g.as;
    float acc[RM][8];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
    if (n0 < N) {
      // two batches of rows in flight: the next loads while this one is
      // used, into the other buffer (no register copy waits on a load)
      auto use = [&](const LT* w, int kb_) {
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          if (kb_ + u < kn) {
            float wf[8];
            Lane8<W>::unpack(w[u], wf);
#pragma unroll
            for (int r = 0; r < RM; ++r) {
              if (r < R) {
                const float av =
                    __bfloat162float(as[r * KCHUNK_MAX + kb_ + u]);
#pragma unroll
                for (int i = 0; i < 8; ++i) acc[r][i] += av * wf[i];
              }
            }
          }
        }
      };
      for (; kb < kn; kb += 2 * stride) {
        if (kb + stride < kn) load(nxt, kb + stride);
        use(cur, kb);
        if (kb + 2 * stride < kn) load(cur, kb + 2 * stride);
        if (kb + stride < kn) use(nxt, kb + stride);
      }
    }
    // rows in groups of 4: each warp parks its sums, then thread t adds
    // column t over the warps in order and writes the partial
    float* red = sm.g.red;
#pragma unroll
    for (int rg = 0; rg < RM; rg += 4) {
      if (rg >= R) break;
#pragma unroll
      for (int rr = 0; rr < 4 && rg + rr < RM; ++rr) {
        float4* dst = reinterpret_cast<float4*>(
            &red[(warp * 4 + rr) * GV_COLS + lane * 8]);
        dst[0] = make_float4(acc[rg + rr][0], acc[rg + rr][1], acc[rg + rr][2],
                             acc[rg + rr][3]);
        dst[1] = make_float4(acc[rg + rr][4], acc[rg + rr][5], acc[rg + rr][6],
                             acc[rg + rr][7]);
      }
      __syncthreads();
      const int c = tid;  // THREADS == GV_COLS
      if (n_base + c < N) {
        for (int rr = 0; rr < 4 && rg + rr < R; ++rr) {
          float v = 0.f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) v += red[(w * 4 + rr) * GV_COLS + c];
          sg_.part[((size_t)split * R + rg + rr) * N + n_base + c] = v;
        }
      }
      __syncthreads();
    }
  }
}

// -- attention, split-KV -------------------------------------------------------
// Item (kv head g, row r, chunk c) over keys j0 .. j0 + nk - 1 of [external
// | self]: for each q head of the group, s = q.k * scale + mask (fp32), m =
// max s, p = exp(s - m), l = sum p, o = p.V -> apart[h, r, c] = (m, l, o).
// Warps split the keys and lanes the dims, for the scores (coalesced
// 8-byte loads, each head's dot summed over the warp in a fixed tree) and
// for P.V; the warps' P.V sums meet in shared memory in order. A warp loads
// 4 (scores) or 8 (P.V) keys before it uses any.
__device__ void attention_item(const Args& a, Smem& sm, int l, int g, int r,
                               int c) {
  const int R = a.R, E = a.E, T = E + R, KD = a.KVH * D, QD = a.H * D;
  const int Gq = a.H / a.KVH, tid = threadIdx.x, warp = tid >> 5,
            lane = tid & 31;
  const int j0 = c * a.kv_chunk, nk = min(a.kv_chunk, T - j0);
  const float scale = rsqrtf((float)D);
  const bf16* kext = a.kext + (size_t)l * E * KD + g * D;
  const bf16* vext = a.vext + (size_t)l * E * KD + g * D;
  const bf16* kself = a.kself + (size_t)l * R * KD + g * D;
  const bf16* vself = a.vself + (size_t)l * R * KD + g * D;
  AttnSmem& s = sm.a;
  for (int i = tid; i < Gq * D; i += THREADS)
    s.qs[i] = ldb(a.q + (size_t)r * QD + g * Gq * D + i) * scale;
  __syncthreads();
  // scores: a warp a key (keys warp, warp + 8, ..., KB of them loaded at
  // once), a lane 4 dims (8 bytes of the row: coalesced); each head's dot
  // is the lane's 4 products, then the warp's lanes in a fixed tree
  {
    constexpr int KB = 4;
    float qv[GQ_MAX][4];
#pragma unroll
    for (int i = 0; i < GQ_MAX; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        qv[i][e] = i < Gq ? s.qs[i * D + 4 * lane + e] : 0.f;
    for (int t0 = warp; t0 < nk; t0 += KB * WARPS) {
      uint2 u[KB];
      float mk[KB];
#pragma unroll
      for (int b = 0; b < KB; ++b) {
        const int t = t0 + b * WARPS, j = j0 + t;
        u[b] = make_uint2(0, 0);
        mk[b] = 0.f;
        if (t < nk) {
          u[b] = j < E ? *reinterpret_cast<const uint2*>(
                             kext + (size_t)j * KD + 4 * lane)
                       : __ldcg(reinterpret_cast<const uint2*>(
                             kself + (size_t)(j - E) * KD + 4 * lane));
          mk[b] = j < E ? a.extm[j] : a.selfm[r * R + j - E];
        }
      }
#pragma unroll
      for (int b = 0; b < KB; ++b) {
        const int t = t0 + b * WARPS;
        if (t >= nk) break;
        const float2 k01 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u[b].x));
        const float2 k23 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u[b].y));
#pragma unroll
        for (int i = 0; i < GQ_MAX; ++i) {
          if (i >= Gq) break;
          float d = qv[i][0] * k01.x + qv[i][1] * k01.y + qv[i][2] * k23.x +
                    qv[i][3] * k23.y;
          d = warp_sum(d);
          if (lane == 0) s.sc[i * KV_CHUNK_MAX + t] = d + mk[b];
        }
      }
    }
  }
  __syncthreads();
  for (int i = warp; i < Gq; i += WARPS) {  // a warp a head: m, p, l
    float* sc = s.sc + i * KV_CHUNK_MAX;
    float m = -3.0e38f;
    for (int t = lane; t < nk; t += 32) m = fmaxf(m, sc[t]);
    m = warp_max(m);
    float sum = 0.f;
    for (int t = lane; t < nk; t += 32) {
      const float p = expf(sc[t] - m);
      sc[t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      s.ml[2 * i] = m;
      s.ml[2 * i + 1] = sum;
    }
  }
  __syncthreads();
  float acc[GQ_MAX][4];
#pragma unroll
  for (int i = 0; i < GQ_MAX; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  constexpr int VB = 8;  // keys a warp loads at once
  for (int t0 = warp; t0 < nk; t0 += VB * WARPS) {
    __nv_bfloat162 v0[VB], v1[VB];
#pragma unroll
    for (int b = 0; b < VB; ++b) {
      const int t = t0 + b * WARPS, j = j0 + t;
      if (t >= nk) break;
      const bf16* vp = j < E ? vext + (size_t)j * KD
                             : vself + (size_t)(j - E) * KD;
      if (j < E) {
        v0[b] = *reinterpret_cast<const __nv_bfloat162*>(vp + 2 * lane);
        v1[b] = *reinterpret_cast<const __nv_bfloat162*>(vp + 64 + 2 * lane);
      } else {
        v0[b] = __ldcg(reinterpret_cast<const __nv_bfloat162*>(vp + 2 * lane));
        v1[b] = __ldcg(
            reinterpret_cast<const __nv_bfloat162*>(vp + 64 + 2 * lane));
      }
    }
#pragma unroll
    for (int b = 0; b < VB; ++b) {
      const int t = t0 + b * WARPS;
      if (t >= nk) break;
      const float2 f0 = __bfloat1622float2(v0[b]), f1 = __bfloat1622float2(v1[b]);
#pragma unroll
      for (int i = 0; i < GQ_MAX; ++i) {
        if (i >= Gq) break;
        const float p = s.sc[i * KV_CHUNK_MAX + t];
        acc[i][0] += p * f0.x;
        acc[i][1] += p * f0.y;
        acc[i][2] += p * f1.x;
        acc[i][3] += p * f1.y;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < GQ_MAX; ++i) {
    if (i >= Gq) break;
    float* pv = s.pv + (warp * GQ_MAX + i) * D;
    pv[2 * lane] = acc[i][0];
    pv[2 * lane + 1] = acc[i][1];
    pv[64 + 2 * lane] = acc[i][2];
    pv[64 + 2 * lane + 1] = acc[i][3];
  }
  __syncthreads();
  for (int e = tid; e < Gq * D; e += THREADS) {
    const int i = e / D, d = e % D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) o += s.pv[(w * GQ_MAX + i) * D + d];
    float* dst = a.apart +
                 ((size_t)((g * Gq + i) * R + r) * a.nch + c) * PART;
    dst[2 + d] = o;
    if (d == 0) {
      dst[0] = s.ml[2 * i];
      dst[1] = s.ml[2 * i + 1];
    }
  }
  __syncthreads();
}

// The external K and V rows of this block's attention items into L2, one
// 128-byte line a thread at a time (issued in the phase before, whose loads
// are few: the items then find them there).
__device__ void prefetch_kv(const Args& a, int l) {
  const int items = a.KVH * a.R * a.nch, T = a.E + a.R, KD = a.KVH * D;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int c = it % a.nch, g = it / a.nch / a.R;
    const int j0 = c * a.kv_chunk, j1 = min(min(j0 + a.kv_chunk, T), a.E);
    for (int i = threadIdx.x; i < 4 * max(j1 - j0, 0); i += THREADS) {
      const int j = j0 + i / 4, half = i % 2;
      const bf16* base = i % 4 < 2 ? a.kext : a.vext;
      const bf16* p = base + ((size_t)l * a.E + j) * KD + g * D + half * 64;
      asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
    }
  }
}

__device__ void attention_phase(const Args& a, Smem& sm, int l) {
  const int items = a.KVH * a.R * a.nch;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int c = it % a.nch, gr = it / a.nch;
    attention_item(a, sm, l, gr / a.R, gr % a.R, c);
  }
}

// -- the stack -----------------------------------------------------------------
template <int RM, typename W>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    stack_kernel(const __grid_constant__ Args a) {
  __shared__ __align__(16) Smem sm;
  const int C = a.C, QD = a.H * D, KD = a.KVH * D, I = a.I;
  const size_t wb = a.wbytes;
  unsigned gen = 0;  // barriers passed
  // with a trace buffer: block 0's clock at the start and as each phase
  // ends (after its barrier; the last one without)
  int tk = 0;
  auto mark = [&]() {
    if (a.trace && blockIdx.x == 0 && threadIdx.x == 0) {
      unsigned long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      a.trace[tk] = t;
    }
    ++tk;
  };
  auto sync = [&]() {
    grid_sync(a.bar, gen);
    mark();
  };
  auto none = [] {};
  // x_out = x (the residual stream of layer 0)
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < a.R * C;
       i += gridDim.x * THREADS)
    a.xout[i] = a.x[i];
  mark();
  for (int l = 0; l < a.L; ++l) {
    const Plan& p = a.p;
    float* pq = a.part;
    // 1. q/k/v partials over RMSNorm_1(x)
    const Seg s3[3] = {
        {a.wq + (size_t)l * C * QD * wb, pq, QD},
        {a.wk + (size_t)l * C * KD * wb, pq + (size_t)p.ks_qkv * a.R * QD, KD},
        {a.wv + (size_t)l * C * KD * wb,
         pq + (size_t)p.ks_qkv * a.R * (QD + KD), KD}};
    if (l == 0)
      gemv_phase<RM, W>(a, sm, SRC_RMS, a.x, a.ln1, nullptr, nullptr, s3, 3,
                        C, p.kc_qkv, p.ks_qkv, none);
    else  // the barrier after the last layer's residual
      gemv_phase<RM, W>(a, sm, SRC_RMS, a.xout, a.ln1 + (size_t)l * C,
                        nullptr, nullptr, s3, 3, C, p.kc_qkv, p.ks_qkv, sync);
    sync();
    // 2. q and the self K/V; the attention's external K/V start into L2
    prefetch_kv(a, l);
    qkv_post(a, l);
    sync();
    // 3. attention partials
    attention_phase(a, sm, l);
    // 4. o partials over the combined attention rows
    const Seg so1[1] = {{a.wo + (size_t)l * QD * C * wb, a.part, C}};
    gemv_phase<RM, W>(a, sm, SRC_ATTN, nullptr, nullptr, nullptr, nullptr,
                      so1, 1, QD, p.kc_o, p.ks_o, sync);
    sync();
    // 5. xn = x + o
    residual(a, a.part, p.ks_o, a.so + (size_t)l * C, a.xout, a.xn);
    // 6. gate/up partials over RMSNorm_2(xn)
    const Seg s2[2] = {{a.wg + (size_t)l * C * I * wb, a.part, I},
                       {a.wu + (size_t)l * C * I * wb,
                        a.part + (size_t)p.ks_gu * a.R * I, I}};
    gemv_phase<RM, W>(a, sm, SRC_RMS, a.xn, a.ln2 + (size_t)l * C, nullptr,
                      nullptr, s2, 2, C, p.kc_gu, p.ks_gu, sync);
    // 7. down partials over bf16(silu(g) * u)
    const Seg sd1[1] = {{a.wd + (size_t)l * I * C * wb, a.part2, C}};
    gemv_phase<RM, W>(a, sm, SRC_SILU, nullptr, nullptr,
                      a.sg + (size_t)l * I, a.su + (size_t)l * I, sd1, 1, I,
                      p.kc_d, p.ks_d, sync);
    sync();
    // 8. x = xn + down
    residual(a, a.part2, p.ks_d, a.sd + (size_t)l * C, a.xn, a.xout);
  }
  mark();
  grid_release(a.bar, sm.g.last);
}

// -- the split-KV attention alone (timing and tests; the stack never calls
// it): phase 2, a grid barrier, then the combine of each (q head, row) into
// qr [R, H*D] bf16, for layer 0 of k_self / v_self.
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    attention_kernel(const __grid_constant__ Args a) {
  __shared__ __align__(16) Smem sm;
  unsigned gen = 0;
  attention_phase(a, sm, 0);
  grid_sync(a.bar, gen);
  const int QD = a.H * D;
  for (int it = blockIdx.x; it < QD / 64; it += gridDim.x) {
    load_act(a, sm, SRC_ATTN, nullptr, nullptr, nullptr, nullptr, QD, it * 64,
             64);
    for (int i = threadIdx.x; i < a.R * 64; i += THREADS)
      a.qr[(size_t)(i / 64) * QD + it * 64 + i % 64] =
          sm.g.as[(i / 64) * KCHUNK_MAX + i % 64];
    __syncthreads();
  }
  grid_release(a.bar, sm.g.last);
}

static int tiles_h(int n) { return (n + GV_COLS - 1) / GV_COLS; }

static void choose_split(int K, int n_blocks, int* ksplit, int* kchunk) {
  int ks = TARGET_BLOCKS / n_blocks;  // one wave: no tail of a few blocks
  if (ks < 1) ks = 1;
  // whole batches of GV_UNROLL rows for every warp
  constexpr int step = WARPS * GV_UNROLL;
  int kc = (K + ks - 1) / ks;
  kc = ((kc + step - 1) / step) * step;
  if (kc > KCHUNK_MAX) kc = KCHUNK_MAX;
  *kchunk = kc;
  *ksplit = (K + kc - 1) / kc;
}

static Plan plan(int C, int QD, int KD, int I) {
  Plan p;
  choose_split(C, tiles_h(QD) + 2 * tiles_h(KD), &p.ks_qkv, &p.kc_qkv);
  choose_split(QD, tiles_h(C), &p.ks_o, &p.kc_o);
  choose_split(C, 2 * tiles_h(I), &p.ks_gu, &p.kc_gu);
  choose_split(I, tiles_h(C), &p.ks_d, &p.kc_d);
  return p;
}

// fp32 elements of `part` (q/k/v, o, gate/up in turn) and of `part2` (down).
static void scratch(const Plan& p, int R, int C, int QD, int KD, int I,
                    long long* part, long long* part2) {
  long long m = (long long)p.ks_qkv * R * (QD + 2 * KD);
  const long long o = (long long)p.ks_o * R * C;
  const long long gu = (long long)p.ks_gu * R * 2 * I;
  if (o > m) m = o;
  if (gu > m) m = gu;
  *part = m;
  *part2 = (long long)p.ks_d * R * C;
}

template <typename K>
static int grid_of(K kernel, int* grid) {
  int dev = 0, sms = 0, nb = 0;
  if (cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kernel, THREADS, 0))
    return (int)cudaGetLastError();
  if (nb < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = (nb < BLOCKS_PER_SM ? nb : BLOCKS_PER_SM) * sms;
  return 0;
}

template <typename K>
static int launch(K kernel, const Args& a, cudaStream_t st) {
  int grid = 0;
  if (int e = grid_of(kernel, &grid)) return e;
  void* args[] = {const_cast<Args*>(&a)};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                          dim3(THREADS), args, 0, st);
}

template <int RM>
static int launch_rm(bool wbf16, const Args& a, cudaStream_t st) {
  return wbf16 ? launch(stack_kernel<RM, bf16>, a, st)
               : launch(stack_kernel<RM, int8_t>, a, st);
}

}  // namespace dec

// fp32 elements of the partial-sum scratch that int8_stack_forward needs
// (part, then part2, in one buffer).
extern "C" long long int8_stack_scratch_floats(int R, int C, int QD, int KD,
                                               int I) {
  long long part, part2;
  dec::scratch(dec::plan(C, QD, KD, I), R, C, QD, KD, I, &part, &part2);
  return part + part2;
}

// Blocks of the cooperative grid (the occupancy query, at most two per SM)
// of the stack kernel for R rows and the weight mode, on the current device.
extern "C" int int8_stack_grid(int R, int wbf16) {
  using namespace dec;
  int g = 0, e;
  if (R <= 1)
    e = wbf16 ? grid_of(stack_kernel<1, bf16>, &g)
              : grid_of(stack_kernel<1, int8_t>, &g);
  else if (R <= 4)
    e = wbf16 ? grid_of(stack_kernel<4, bf16>, &g)
              : grid_of(stack_kernel<4, int8_t>, &g);
  else if (R == 5)
    e = wbf16 ? grid_of(stack_kernel<5, bf16>, &g)
              : grid_of(stack_kernel<5, int8_t>, &g);
  else
    e = wbf16 ? grid_of(stack_kernel<8, bf16>, &g)
              : grid_of(stack_kernel<8, int8_t>, &g);
  return e ? -e : g;
}

// The whole stack, one cooperative launch. Weights int8 (wbf16 = 0) or bf16
// (wbf16 = 1) [L, K, N]; scales fp32 [L, 1, N] (ones with bf16 weights);
// ln/bias fp32 [L, n]; cos/sin [R, D] bf16 (rope_f32 = 0) or fp32;
// self_mask fp32 [R, R]; ext_mask fp32 [1, E]; k_ext/v_ext bf16 [L, E, KVH,
// D]. Outputs: x_out bf16 [R, C], k_self/v_self bf16 [L, R, KVH, D].
// Scratch: xn bf16 [R, C], qr bf16 [R, QD], part fp32
// (int8_stack_scratch_floats), apart fp32 [H, R, nch, 2 + D] with nch =
// ceil((E + R) / kv_chunk), bar u32 [3] zero (the kernel leaves it zero);
// trace: null, or u64 [1 + 8 L] for the phases' end times (ns, block 0).
// Every N is a multiple of 8 (8-column weight loads); head_dim is 128, H /
// KVH <= 8, kv_chunk <= 256. A refused cooperative launch returns its
// error.
extern "C" int int8_stack_forward(
    const void* x_, const void* cos_, const void* sin_, const void* selfm_,
    const void* extm_, const void* ln1_, const void* ln2_, const void* bq_,
    const void* bk_, const void* bv_, const void* wq_, const void* sq_,
    const void* wk_, const void* sk_, const void* wv_, const void* sv_,
    const void* wo_, const void* so_, const void* wg_, const void* sg_,
    const void* wu_, const void* su_, const void* wd_, const void* sd_,
    const void* kext_, const void* vext_, void* xout_, void* kself_,
    void* vself_, void* xn_, void* qr_, void* part_, void* apart_, void* bar_,
    void* trace_, int L, int R, int C, int H, int KVH, int D, int I, int E, int wbf16,
    int rope_f32, int kv_chunk, float eps, void* stream) {
  using namespace dec;
  const int QD = H * D, KD = KVH * D;
  if (R < 1 || R > RMAX || D != dec::D || KVH < 1 || H % KVH ||
      H / KVH > GQ_MAX || C % 8 || QD % 8 || KD % 8 || I % 8 || E < 0 ||
      kv_chunk < 1 || kv_chunk > KV_CHUNK_MAX || L < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = (const bf16*)x_;
  a.cos = cos_;
  a.sin = sin_;
  a.selfm = (const float*)selfm_;
  a.extm = (const float*)extm_;
  a.ln1 = (const float*)ln1_;
  a.ln2 = (const float*)ln2_;
  a.bq = (const float*)bq_;
  a.bk = (const float*)bk_;
  a.bv = (const float*)bv_;
  a.wq = (const char*)wq_;
  a.wk = (const char*)wk_;
  a.wv = (const char*)wv_;
  a.wo = (const char*)wo_;
  a.wg = (const char*)wg_;
  a.wu = (const char*)wu_;
  a.wd = (const char*)wd_;
  a.sq = (const float*)sq_;
  a.sk = (const float*)sk_;
  a.sv = (const float*)sv_;
  a.so = (const float*)so_;
  a.sg = (const float*)sg_;
  a.su = (const float*)su_;
  a.sd = (const float*)sd_;
  a.kext = (const bf16*)kext_;
  a.vext = (const bf16*)vext_;
  a.xout = (bf16*)xout_;
  a.kself = (bf16*)kself_;
  a.vself = (bf16*)vself_;
  a.xn = (bf16*)xn_;
  a.qr = (bf16*)qr_;
  a.q = a.qr;
  a.p = plan(C, QD, KD, I);
  long long part, part2;
  scratch(a.p, R, C, QD, KD, I, &part, &part2);
  a.part = (float*)part_;
  a.part2 = a.part + part;
  a.apart = (float*)apart_;
  a.bar = (unsigned*)bar_;
  a.trace = (unsigned long long*)trace_;
  a.L = L;
  a.R = R;
  a.C = C;
  a.H = H;
  a.KVH = KVH;
  a.I = I;
  a.E = E;
  a.rope_f32 = rope_f32;
  a.kv_chunk = kv_chunk;
  a.nch = (E + R + kv_chunk - 1) / kv_chunk;
  a.wbytes = wbf16 ? 2 : 1;
  a.eps = eps;
  cudaStream_t st = (cudaStream_t)stream;
  return R <= 1   ? launch_rm<1>(wbf16, a, st)
         : R <= 4 ? launch_rm<4>(wbf16, a, st)
         : R == 5 ? launch_rm<5>(wbf16, a, st)
                  : launch_rm<8>(wbf16, a, st);
}

// The split-KV attention alone (dec::attention_kernel): q [R, H*D] bf16
// (roped), the external K/V [E, KVH, D] and the self K/V [R, KVH, D] of one
// layer, the masks -> out [R, H*D] bf16. apart and bar as for the stack.
extern "C" int int8_stack_attention(const void* q_, const void* kext_,
                                    const void* vext_, const void* kself_,
                                    const void* vself_, const void* selfm_,
                                    const void* extm_, void* out_,
                                    void* apart_, void* bar_, int R, int H,
                                    int KVH, int E, int kv_chunk,
                                    void* stream) {
  using namespace dec;
  if (R < 1 || R > RMAX || KVH < 1 || H % KVH || H / KVH > GQ_MAX ||
      kv_chunk < 1 || kv_chunk > KV_CHUNK_MAX || E < 0)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.q = (const bf16*)q_;
  a.qr = (bf16*)out_;
  a.kext = (const bf16*)kext_;
  a.vext = (const bf16*)vext_;
  a.kself = (bf16*)kself_;
  a.vself = (bf16*)vself_;
  a.selfm = (const float*)selfm_;
  a.extm = (const float*)extm_;
  a.apart = (float*)apart_;
  a.bar = (unsigned*)bar_;
  a.R = R;
  a.H = H;
  a.KVH = KVH;
  a.E = E;
  a.kv_chunk = kv_chunk;
  a.nch = (E + R + kv_chunk - 1) / kv_chunk;
  return launch(attention_kernel, a, (cudaStream_t)stream);
}
