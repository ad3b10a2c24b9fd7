// Fused decoder stack (Qwen2-family layers, R rows) for Hopper.
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
// microseconds of traffic per GEMV, launch latency and the serial steps
// between the GEMVs (reductions, norms, attention) weigh as much as the
// stream itself; at decode the attention reads the cache too (2 x E x 512
// bytes a layer).
//
// What the design does about it: weights are read exactly once per call, 8
// columns per thread (8 bytes of int8 or 16 bytes of bf16), neighbouring
// threads on neighbouring columns (coalesced rows per warp, 8 rows in
// flight per warp, the next 8 loading while these are used); the activation
// rows sit in shared memory as fp32 and the weight -> fp32 convert is a
// register op; the per-output-channel scale is applied to the [R, N] output
// (fused_decode.py:159-167), never to the weight. K is split across blocks
// (one wave of two blocks per SM) so even the 256-column k/v projections
// fill the 132 SMs; the partial sums go through a small fp32 scratch and are
// reduced in a fixed order by a wide elementwise kernel that also applies
// scale, bias, the SiLU gate or the residual -- so no dequantized weight and
// no extra pass over the weights ever exists. (Reducing in the last block of
// each tile instead, to save those launches, was measured slower: one block
// then sums up to 70 partials per column serially.) A rope kernel rounds
// q/k/v (bf16 or fp32 rope tables, as the caller passes them) and writes
// the self K/V; one attention kernel per (q head, row) keeps the additive
// masks in fp32 (NEG_INF = -1e30 would overflow half precision), scores one
// key per thread (16-byte loads) into shared memory -- above 48 KB it opts
// into the SM's larger dynamic shared memory, so a 32,768-slot cache fits
// -- and splits P.V over 16 warps. R is a runtime argument, up to 8. The
// host loops over layers in C: one ctypes call per stack. Simple first: no
// TMA prefetch of the next layer's weights yet, and the decode's attention
// runs H x R = 12 blocks.
#include "common.cuh"

namespace dec {

constexpr int RMAX = 8;
constexpr int HEAD_DIM = 128;  // the action expert's and Qwen2.5-1.5B's
constexpr int GV_THREADS = 256;  // 8 warps split K inside the block
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_COLS = 256;     // 32 lanes x 8 int8 columns
constexpr int GV_UNROLL = 8;     // weight rows in flight per warp
constexpr int KCHUNK_MAX = 384;
constexpr int TARGET_BLOCKS = 264;  // two per SM
constexpr int AT_THREADS = 512;
constexpr int AT_WARPS = AT_THREADS / 32;

struct Seg {
  const void* w;    // [K, N] int8 or bf16
  float* part;      // [ksplit, R, N] fp32 partial sums
  int N;
};
struct Segs {
  Seg s[3];
};

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

// part[split, r, n] = sum_{k in split} a[r, k] * w[k, n]; blockIdx.z picks
// the weight (q/k/v or gate/up share one launch). RM >= R rows; W is the
// weight element type. Each warp keeps GV_UNROLL independent 8-column
// weight loads in flight; the 8 warps' sums meet in shared memory in a
// fixed order (deterministic).
template <int RM, typename W>
__global__ void __launch_bounds__(GV_THREADS)
gemv_partial_kernel(const bf16* __restrict__ a, int R, int K, int kchunk,
                    Segs segs) {
  __shared__ float as[RMAX * KCHUNK_MAX];
  __shared__ __align__(16) float red[GV_WARPS * 4 * GV_COLS];
  const Seg sg = segs.s[blockIdx.z];
  const int N = sg.N;
  const int n_base = blockIdx.x * GV_COLS;
  if (n_base >= N) return;
  const int k0 = blockIdx.y * kchunk;
  const int kn = min(kchunk, K - k0);
  for (int i = threadIdx.x; i < R * kn; i += GV_THREADS) {
    const int r = i / kn, kk = i % kn;
    as[r * KCHUNK_MAX + kk] = __bfloat162float(a[(size_t)r * K + k0 + kk]);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = n_base + lane * 8;
  float acc[RM][8];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  if (n0 < N) {
    // software pipeline: the next batch of rows loads while this one is used
    typedef typename Lane8<W>::T LT;
    const W* wcol = static_cast<const W*>(sg.w) + (size_t)k0 * N + n0;
    constexpr int stride = GV_WARPS * GV_UNROLL;
    LT cur[GV_UNROLL], nxt[GV_UNROLL];
    auto load = [&](LT* dst, int kb) {
#pragma unroll
      for (int u = 0; u < GV_UNROLL; ++u)
        dst[u] = kb + u < kn
                     ? *reinterpret_cast<const LT*>(wcol + (size_t)(kb + u) * N)
                     : LT{};
    };
    int kb = warp * GV_UNROLL;
    if (kb < kn) load(cur, kb);
    for (; kb < kn; kb += stride) {
      if (kb + stride < kn) load(nxt, kb + stride);
#pragma unroll
      for (int u = 0; u < GV_UNROLL; ++u) {
        if (kb + u < kn) {
          float wf[8];
          Lane8<W>::unpack(cur[u], wf);
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            if (r < R) {
              const float av = as[r * KCHUNK_MAX + kb + u];
#pragma unroll
              for (int i = 0; i < 8; ++i) acc[r][i] += av * wf[i];
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < GV_UNROLL; ++u) cur[u] = nxt[u];
    }
  }
  // rows in groups of 4: each warp parks its sums, then thread t adds column
  // t over the warps in order and writes the partial
#pragma unroll
  for (int rg = 0; rg < RM; rg += 4) {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float4* dst = reinterpret_cast<float4*>(
          &red[(warp * 4 + rr) * GV_COLS + lane * 8]);
      dst[0] = make_float4(acc[rg + rr][0], acc[rg + rr][1], acc[rg + rr][2],
                           acc[rg + rr][3]);
      dst[1] = make_float4(acc[rg + rr][4], acc[rg + rr][5], acc[rg + rr][6],
                           acc[rg + rr][7]);
    }
    __syncthreads();
    const int c = threadIdx.x;  // GV_THREADS == GV_COLS
    if (n_base + c < N) {
      for (int rr = 0; rr < 4 && rg + rr < R; ++rr) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < GV_WARPS; ++w) v += red[(w * 4 + rr) * GV_COLS + c];
        sg.part[((size_t)blockIdx.y * R + rg + rr) * N + n_base + c] = v;
      }
    }
    __syncthreads();
  }
}

// Sum of the split-K partials of element (r, n), in split order.
__device__ __forceinline__ float reduce_parts(const float* part, int ksplit,
                                              int R, int N, int r, int n) {
  const size_t stride = (size_t)R * N;
  const float* p = part + (size_t)r * N + n;
  float v = 0.f;
  int s = 0;
  for (; s + 4 <= ksplit; s += 4) {
    const float a = p[s * stride], b = p[(s + 1) * stride];
    const float c = p[(s + 2) * stride], d = p[(s + 3) * stride];
    v += a;
    v += b;
    v += c;
    v += d;
  }
  for (; s < ksplit; ++s) v += p[s * stride];
  return v;
}

// Rotate-half rope of the bf16-rounded pair (a, b) in the dtype of the
// tables (fused_decode.py:176-180): with bf16 cos/sin each product and the
// sum round to bf16; with fp32 ones (the VLM decode) the products and the
// sum are fp32, rounded once.
__device__ __forceinline__ float rope_half(float a, float b, float c, float s,
                                           const bf16*) {
  return bf(a * c) + bf(b * s);
}
__device__ __forceinline__ float rope_half(float a, float b, float c, float s,
                                           const float*) {
  return __fadd_rn(__fmul_rn(a, c), __fmul_rn(b, s));
}
__device__ __forceinline__ float ld(const bf16* p, int i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float ld(const float* p, int i) { return p[i]; }

// q/k/v = parts * scale + bias (fp32) -> bf16 -> rotate-half rope (CT: the
// tables' type). Writes roped q [R, H*D] and this layer's k/v self rows [R,
// KVH, D]. Grid (ceil(((H + KVH) * D/2 + KVH * D) / blockDim), R).
template <typename CT>
__global__ void qkv_post_kernel(const float* __restrict__ pq,
                                const float* __restrict__ pk,
                                const float* __restrict__ pv, int ksplit, int R,
                                int H, int KVH, int D,
                                const float* __restrict__ sq, const float* __restrict__ bq,
                                const float* __restrict__ sk, const float* __restrict__ bk,
                                const float* __restrict__ sv, const float* __restrict__ bv,
                                const CT* __restrict__ cos, const CT* __restrict__ sin,
                                bf16* __restrict__ qr, bf16* __restrict__ kself,
                                bf16* __restrict__ vself) {
  const int r = blockIdx.y, half = D / 2;
  const int QD = H * D, KD = KVH * D;
  const int npairs = (H + KVH) * half;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= npairs) {
    const int n = idx - npairs;
    if (n < KD) {
      const float v = reduce_parts(pv, ksplit, R, KD, r, n) * sv[n] + bv[n];
      vself[(size_t)r * KD + n] = __float2bfloat16(v);
    }
    return;
  }
  const int hh = idx / half, d = idx % half;
  const bool isq = hh < H;
  const float* part = isq ? pq : pk;
  const int N = isq ? QD : KD;
  const int col = (isq ? hh : hh - H) * D + d;
  const float* sc = isq ? sq : sk;
  const float* bi = isq ? bq : bk;
  const float v1 = reduce_parts(part, ksplit, R, N, r, col) * sc[col] + bi[col];
  const float v2 =
      reduce_parts(part, ksplit, R, N, r, col + half) * sc[col + half] + bi[col + half];
  const float a = bf(v1), b = bf(v2);
  const float c1 = ld(cos, r * D + d), s1 = ld(sin, r * D + d);
  const float c2 = ld(cos, r * D + d + half), s2 = ld(sin, r * D + d + half);
  bf16* dst = isq ? qr + (size_t)r * QD : kself + (size_t)r * KD;
  dst[col] = __float2bfloat16(rope_half(a, -b, c1, s1, cos));
  dst[col + half] = __float2bfloat16(rope_half(b, a, c2, s2, cos));
}

// One (q head, row): fp32 softmax over [external keys | self keys] with the
// additive fp32 masks, out = p . V -> bf16. One key per thread for the
// scores (D/8 16-byte loads, all in flight), keys split over the 16 warps
// for P.V (bf16 pairs per lane). Dynamic smem: (17 * D + E + R) floats.
template <int D>
__global__ void __launch_bounds__(AT_THREADS)
attention_kernel(const bf16* __restrict__ qr, const bf16* __restrict__ kext,
                 const bf16* __restrict__ vext, const bf16* __restrict__ kself,
                 const bf16* __restrict__ vself,
                 const float* __restrict__ ext_mask,
                 const float* __restrict__ self_mask, bf16* __restrict__ out,
                 int R, int H, int KVH, int E, float scale) {
  extern __shared__ float sm[];
  __shared__ float red[32];
  constexpr int NP = D / 64;  // bf16 pairs per lane in P.V
  const int T = E + R, KD = KVH * D;
  float* qs = sm;           // [D]
  float* sc = sm + D;       // [T]
  float* pv = sc + T;       // [AT_WARPS, D]
  const int h = blockIdx.x, r = blockIdx.y, g = h / (H / KVH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < D; i += AT_THREADS)
    qs[i] = __bfloat162float(qr[(size_t)r * H * D + h * D + i]) * scale;
  __syncthreads();
  for (int j = tid; j < T; j += AT_THREADS) {
    const bf16* kp = j < E ? kext + (size_t)j * KD + g * D
                           : kself + (size_t)(j - E) * KD + g * D;
    uint4 u[D / 8];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) u[c] = reinterpret_cast<const uint4*>(kp)[c];
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const bf16* e = reinterpret_cast<const bf16*>(&u[c]);
#pragma unroll
      for (int i = 0; i < 8; ++i) dot += qs[8 * c + i] * __bfloat162float(e[i]);
    }
    sc[j] = dot + (j < E ? ext_mask[j] : self_mask[r * R + j - E]);
  }
  __syncthreads();
  float mx = -3.0e38f;
  for (int j = tid; j < T; j += AT_THREADS) mx = fmaxf(mx, sc[j]);
  mx = block_max(mx, red);
  float sum = 0.f;
  for (int j = tid; j < T; j += AT_THREADS) {
    const float e = expf(sc[j] - mx);
    sc[j] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  const float inv = 1.f / sum;
  for (int j = tid; j < T; j += AT_THREADS) sc[j] = sc[j] * inv;
  __syncthreads();
  float acc[NP][2];
#pragma unroll
  for (int i = 0; i < NP; ++i) acc[i][0] = acc[i][1] = 0.f;
#pragma unroll 8
  for (int j = warp; j < T; j += AT_WARPS) {
    const bf16* vp = j < E ? vext + (size_t)j * KD + g * D
                           : vself + (size_t)(j - E) * KD + g * D;
    const float p = sc[j];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vp + 2 * lane + 64 * i));
      acc[i][0] += p * f.x;
      acc[i][1] += p * f.y;
    }
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    pv[warp * D + 2 * lane + 64 * i] = acc[i][0];
    pv[warp * D + 2 * lane + 64 * i + 1] = acc[i][1];
  }
  __syncthreads();
  for (int d = tid; d < D; d += AT_THREADS) {
    float o = 0.f;
    for (int w = 0; w < AT_WARPS; ++w) o += pv[w * D + d];
    out[(size_t)r * H * D + h * D + d] = __float2bfloat16(o);
  }
}

static int attention(dim3 grid, size_t smem, cudaStream_t st, const bf16* qr,
                     const bf16* kext, const bf16* vext, const bf16* kself,
                     const bf16* vself, const float* extm, const float* selfm,
                     bf16* out, int R, int H, int KVH, int E, float scale) {
  // above the default 48 KB of dynamic shared memory a kernel must opt in
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    cudaFuncSetAttribute(attention_kernel<HEAD_DIM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    RETURN_IF_ERR();
    opted = smem;
  }
  attention_kernel<HEAD_DIM><<<grid, AT_THREADS, smem, st>>>(
      qr, kext, vext, kself, vself, extm, selfm, out, R, H, KVH, E, scale);
  RETURN_IF_ERR();
  return 0;
}

// resid_out = bf16(resid_in + parts * scale), elementwise over [R, C].
__global__ void residual_kernel(const float* __restrict__ part, int ksplit,
                                int R, int C, const float* __restrict__ scale,
                                const bf16* __restrict__ resid_in,
                                bf16* __restrict__ resid_out) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= R * C) return;
  const int r = idx / C, n = idx % C;
  const float o = reduce_parts(part, ksplit, R, C, r, n) * scale[n];
  resid_out[idx] = __float2bfloat16(__bfloat162float(resid_in[idx]) + o);
}

// h = bf16(x * rsqrt(mean(x^2) + eps) * w), fp32 statistics. One block/row.
__global__ void rms_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                           bf16* __restrict__ h, int C, float eps) {
  __shared__ float red[32];
  const bf16* xr = x + (size_t)blockIdx.x * C;
  float ss = 0.f;
  for (int n = threadIdx.x; n < C; n += blockDim.x) {
    const float v = __bfloat162float(xr[n]);
    ss += v * v;
  }
  ss = block_sum(ss, red);
  const float rr = rsqrtf(ss / C + eps);
  for (int n = threadIdx.x; n < C; n += blockDim.x)
    h[(size_t)blockIdx.x * C + n] = __float2bfloat16(__bfloat162float(xr[n]) * rr * w[n]);
}

// act = bf16(silu(g) * u), g/u = parts * scale (the gu_s staging,
// fused_decode.py:258-281).
__global__ void gate_up_kernel(const float* __restrict__ pg,
                               const float* __restrict__ pu, int ksplit, int R,
                               int I, const float* __restrict__ sg,
                               const float* __restrict__ su,
                               bf16* __restrict__ act) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= R * I) return;
  const int r = idx / I, n = idx % I;
  const float g = reduce_parts(pg, ksplit, R, I, r, n) * sg[n];
  const float u = reduce_parts(pu, ksplit, R, I, r, n) * su[n];
  act[idx] = __float2bfloat16(g * (1.f / (1.f + expf(-g))) * u);
}

static int tiles(int n) { return (n + GV_COLS - 1) / GV_COLS; }

static void choose_split(int K, int n_blocks, int* ksplit, int* kchunk) {
  int ks = TARGET_BLOCKS / n_blocks;  // one wave: no tail of a few blocks
  if (ks < 1) ks = 1;
  // whole batches of GV_UNROLL rows for every warp
  constexpr int step = GV_WARPS * GV_UNROLL;
  int kc = (K + ks - 1) / ks;
  kc = ((kc + step - 1) / step) * step;
  if (kc > KCHUNK_MAX) kc = KCHUNK_MAX;
  *kchunk = kc;
  *ksplit = (K + kc - 1) / kc;
}

struct Plan {
  int ks_qkv, kc_qkv, ks_o, kc_o, ks_gu, kc_gu, ks_d, kc_d;
};

static Plan plan(int C, int QD, int KD, int I) {
  Plan p;
  choose_split(C, tiles(QD) + 2 * tiles(KD), &p.ks_qkv, &p.kc_qkv);
  choose_split(QD, tiles(C), &p.ks_o, &p.kc_o);
  choose_split(C, 2 * tiles(I), &p.ks_gu, &p.kc_gu);
  choose_split(I, tiles(C), &p.ks_d, &p.kc_d);
  return p;
}

template <typename W>
static int gemv_t(const bf16* a, int R, int K, int kchunk, int ksplit,
                  int ntiles, int nseg, const Segs& segs, cudaStream_t st) {
  const dim3 grid(ntiles, ksplit, nseg);
  if (R <= 4)
    gemv_partial_kernel<4, W><<<grid, GV_THREADS, 0, st>>>(a, R, K, kchunk, segs);
  else
    gemv_partial_kernel<8, W><<<grid, GV_THREADS, 0, st>>>(a, R, K, kchunk, segs);
  RETURN_IF_ERR();
  return 0;
}

static int gemv(bool wbf16, const bf16* a, int R, int K, int kchunk, int ksplit,
                int ntiles, int nseg, const Segs& segs, cudaStream_t st) {
  return wbf16 ? gemv_t<bf16>(a, R, K, kchunk, ksplit, ntiles, nseg, segs, st)
               : gemv_t<int8_t>(a, R, K, kchunk, ksplit, ntiles, nseg, segs, st);
}

// Dynamic shared memory of the attention kernel for E external keys.
static size_t attn_smem_bytes(int R, int D, int E) {
  return (size_t)((1 + AT_WARPS) * D + E + R) * sizeof(float);
}

}  // namespace dec

// fp32 elements of the partial-sum scratch that int8_stack_forward needs.
extern "C" long long int8_stack_scratch_floats(int R, int C, int QD, int KD,
                                               int I) {
  const dec::Plan p = dec::plan(C, QD, KD, I);
  long long m = (long long)p.ks_qkv * R * (QD + 2 * KD);
  const long long o = (long long)p.ks_o * R * C;
  const long long gu = (long long)p.ks_gu * R * 2 * I;
  const long long d = (long long)p.ks_d * R * C;
  if (o > m) m = o;
  if (gu > m) m = gu;
  if (d > m) m = d;
  return m;
}

// The largest external K/V length the attention kernel takes for R rows on
// the current device (its scores stay in shared memory).
extern "C" long long int8_stack_max_ext(int R) {
  using namespace dec;
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&fa, attention_kernel<HEAD_DIM>) != cudaSuccess)
    return -1;
  const long long avail = (long long)optin - (long long)fa.sharedSizeBytes;
  return avail / (long long)sizeof(float) - (1 + AT_WARPS) * HEAD_DIM - R;
}

// The whole stack. Weights int8 (wbf16 = 0) or bf16 (wbf16 = 1) [L, K, N];
// scales fp32 [L, 1, N] (ones with bf16 weights); ln/bias fp32 [L, n];
// cos/sin [R, D] bf16 (rope_f32 = 0) or fp32; self_mask fp32 [R, R]; ext_mask fp32
// [1, E]; k_ext/v_ext bf16 [L, E, KVH, D]. Outputs: x_out bf16 [R, C],
// k_self/v_self bf16 [L, R, KVH, D]. Scratch: h bf16 [R, max(C, QD, I)],
// xn bf16 [R, C], qr bf16 [R, QD], part fp32 (int8_stack_scratch_floats).
// Every N is a multiple of 8 (8-column weight loads); head_dim is HEAD_DIM;
// E <= int8_stack_max_ext(R).
extern "C" int int8_stack_forward(
    const void* x_, const void* cos_, const void* sin_, const void* selfm_,
    const void* extm_, const void* ln1_, const void* ln2_, const void* bq_,
    const void* bk_, const void* bv_, const void* wq_, const void* sq_,
    const void* wk_, const void* sk_, const void* wv_, const void* sv_,
    const void* wo_, const void* so_, const void* wg_, const void* sg_,
    const void* wu_, const void* su_, const void* wd_, const void* sd_,
    const void* kext_, const void* vext_, void* xout_, void* kself_,
    void* vself_, void* h_, void* xn_, void* qr_, void* part_, int L, int R,
    int C, int H, int KVH, int D, int I, int E, int wbf16, int rope_f32,
    float eps, void* stream) {
  using namespace dec;
  const int QD = H * D, KD = KVH * D;
  const size_t attn_smem = attn_smem_bytes(R, D, E);
  if (R < 1 || R > RMAX || D != HEAD_DIM || H % KVH || C % 8 || QD % 8 ||
      KD % 8 || I % 8 || E > int8_stack_max_ext(R))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bf16* x = (const bf16*)x_;
  const float *selfm = (const float*)selfm_, *extm = (const float*)extm_;
  const float *ln1 = (const float*)ln1_, *ln2 = (const float*)ln2_;
  const float *bq = (const float*)bq_, *bk = (const float*)bk_, *bv = (const float*)bv_;
  const char *wq = (const char*)wq_, *wk = (const char*)wk_, *wv = (const char*)wv_;
  const char *wo = (const char*)wo_, *wg = (const char*)wg_, *wu = (const char*)wu_;
  const char* wd = (const char*)wd_;
  const size_t wb = wbf16 ? sizeof(bf16) : 1;  // bytes per weight element
  const float *sq = (const float*)sq_, *sk = (const float*)sk_, *sv = (const float*)sv_;
  const float *so = (const float*)so_, *sg = (const float*)sg_, *su = (const float*)su_;
  const float* sd = (const float*)sd_;
  const bf16 *kext = (const bf16*)kext_, *vext = (const bf16*)vext_;
  bf16 *xout = (bf16*)xout_, *kself = (bf16*)kself_, *vself = (bf16*)vself_;
  bf16 *h = (bf16*)h_, *xn = (bf16*)xn_, *qr = (bf16*)qr_;
  float* part = (float*)part_;
  const Plan p = plan(C, QD, KD, I);
  const float scale = 1.f / sqrtf((float)D);
  const int rc_blocks = (R * C + 255) / 256;
  const int post_blocks = ((H + KVH) * (D / 2) + KD + 127) / 128;
  int err;

  // x_out = x; h = RMSNorm_0(x)
  cudaMemcpyAsync(xout, x, (size_t)R * C * sizeof(bf16), cudaMemcpyDeviceToDevice, st);
  RETURN_IF_ERR();
  rms_kernel<<<R, 256, 0, st>>>(xout, ln1, h, C, eps);
  RETURN_IF_ERR();
  for (int l = 0; l < L; ++l) {
    float *pq = part, *pk = part + (size_t)p.ks_qkv * R * QD,
          *pv = part + (size_t)p.ks_qkv * R * (QD + KD);
    Segs s3 = {{{wq + (size_t)l * C * QD * wb, pq, QD},
                {wk + (size_t)l * C * KD * wb, pk, KD},
                {wv + (size_t)l * C * KD * wb, pv, KD}}};
    if ((err = gemv(wbf16, h, R, C, p.kc_qkv, p.ks_qkv, tiles(QD), 3, s3, st)))
      return err;
    bf16* ks_l = kself + (size_t)l * R * KD;
    bf16* vs_l = vself + (size_t)l * R * KD;
    const dim3 pgrid(post_blocks, R);
    if (rope_f32)
      qkv_post_kernel<float><<<pgrid, 128, 0, st>>>(
          pq, pk, pv, p.ks_qkv, R, H, KVH, D, sq + (size_t)l * QD,
          bq + (size_t)l * QD, sk + (size_t)l * KD, bk + (size_t)l * KD,
          sv + (size_t)l * KD, bv + (size_t)l * KD, (const float*)cos_,
          (const float*)sin_, qr, ks_l, vs_l);
    else
      qkv_post_kernel<bf16><<<pgrid, 128, 0, st>>>(
          pq, pk, pv, p.ks_qkv, R, H, KVH, D, sq + (size_t)l * QD,
          bq + (size_t)l * QD, sk + (size_t)l * KD, bk + (size_t)l * KD,
          sv + (size_t)l * KD, bv + (size_t)l * KD, (const bf16*)cos_,
          (const bf16*)sin_, qr, ks_l, vs_l);
    RETURN_IF_ERR();
    if ((err = attention(dim3(H, R), attn_smem, st, qr, kext + (size_t)l * E * KD,
                         vext + (size_t)l * E * KD, ks_l, vs_l, extm, selfm, h, R,
                         H, KVH, E, scale)))
      return err;
    Segs so1 = {{{wo + (size_t)l * QD * C * wb, part, C}}};
    if ((err = gemv(wbf16, h, R, QD, p.kc_o, p.ks_o, tiles(C), 1, so1, st)))
      return err;
    residual_kernel<<<rc_blocks, 256, 0, st>>>(part, p.ks_o, R, C, so + (size_t)l * C,
                                               xout, xn);
    RETURN_IF_ERR();
    rms_kernel<<<R, 256, 0, st>>>(xn, ln2 + (size_t)l * C, h, C, eps);
    RETURN_IF_ERR();
    float *pg = part, *pu = part + (size_t)p.ks_gu * R * I;
    Segs s2 = {{{wg + (size_t)l * C * I * wb, pg, I},
                {wu + (size_t)l * C * I * wb, pu, I}}};
    if ((err = gemv(wbf16, h, R, C, p.kc_gu, p.ks_gu, tiles(I), 2, s2, st)))
      return err;
    gate_up_kernel<<<(R * I + 255) / 256, 256, 0, st>>>(
        pg, pu, p.ks_gu, R, I, sg + (size_t)l * I, su + (size_t)l * I, h);
    RETURN_IF_ERR();
    Segs sd1 = {{{wd + (size_t)l * I * C * wb, part, C}}};
    if ((err = gemv(wbf16, h, R, I, p.kc_d, p.ks_d, tiles(C), 1, sd1, st)))
      return err;
    residual_kernel<<<rc_blocks, 256, 0, st>>>(part, p.ks_d, R, C, sd + (size_t)l * C,
                                               xn, xout);
    RETURN_IF_ERR();
    if (l + 1 < L) {
      rms_kernel<<<R, 256, 0, st>>>(xout, ln1 + (size_t)(l + 1) * C, h, C, eps);
      RETURN_IF_ERR();
    }
  }
  return 0;
}
