// Block-wise 8-bit AdamW step for Hopper (the bitsandbytes AdamW8bit role).
//
// Replaces: vlaser_tpu/train/optim8bit.py :: scale_by_adam8bit.update_leaf
// (:142, an XLA lax.scan over slabs of blocks, not Pallas) chained with
// adamw8bit's decoupled decay and learning rate (:238-250). Its plain twin
// is train/optim8bit.py adam8bit_update_plain; the two agree bit for bit.
//
// Per block of 256 elements of a leaf (its JAX flattened order): decode the
// uint8 float codes of m (sign + 7-bit magnitude) and v (8-bit magnitude)
// through their tables and the block's fp32 scales; Adam's moments in fp32;
// the block's absmax of the new m and max of the new v (floored at 1e-32)
// become the new scales; encode |m| / scale and v / scale by a lower-bound
// search over the tables' midpoints (a value on a midpoint takes the lower
// code, searchsorted's left rule); the update (m / bc1) / (sqrt(v / bc2) +
// eps) from the unquantized moments; p <- p + (-lr) * (upd + wd * p).
//
// What bounds it on the H100: device memory. Each parameter reads g and p
// (fp32) and its two code bytes and writes p and the two code bytes: 16
// bytes (plus 16 bytes of scales a block), ~40 GB a step over Vlaser-2B-VLA's
// 2.51 G parameters, ~12 ms at 3.35 TB/s.
//
// Design: one warp per block, 8 contiguous elements a lane (two 16-byte
// loads of g and of p, one 8-byte load of each code row); the four tables
// (128 + 256 decode values, 127 + 255 midpoints: the numpy arrays of
// optim8bit.py, passed in as one device tensor) sit in shared memory, not
// constant memory, because each lane indexes them at its own code; the
// block's maxima by warp shuffles; a grid-stride loop over blocks so the
// tables are loaded once a resident block. Every product and sum is
// rounded on its own (__fmul_rn / __fadd_rn, which the compiler never
// contracts into an FMA) and division and sqrt are IEEE (__fdiv_rn,
// __fsqrt_rn), in the twin's order, so the codes, scales and parameters
// equal the twin's. A tail block (n % 256 != 0) reads g as 0 past n, as the
// JAX leaf pads it, writes its 256 codes and leaves p past n alone.
#include "common.cuh"

namespace adam8 {

constexpr int BLOCK = 256;     // elements a quantization block (a warp)
constexpr int WARPS = 8;       // warps a thread block
constexpr int PER_LANE = BLOCK / 32;
constexpr int SMAP_N = 128, UMAP_N = 256, SMID_N = 127, UMID_N = 255;
constexpr int TABLE_N = SMAP_N + UMAP_N + SMID_N + UMID_N;
constexpr int BLOCKS_PER_SM = 8;  // grid: at most this many a SM
constexpr int SMS = 132;

struct Hyper {
  float b1, c1, b2, c2, eps, bc1, bc2, wd, neglr;
};

// Number of the 2^k - 1 sorted midpoints below x (searchsorted, left).
template <int K>
__device__ __forceinline__ int lower_bound(const float* mids, float x) {
  int lo = 0;
#pragma unroll
  for (int step = 1 << (K - 1); step >= 1; step >>= 1)
    if (mids[lo + step - 1] < x) lo += step;
  return lo;
}

__global__ void __launch_bounds__(WARPS * 32)
step_kernel(const float* __restrict__ g, float* __restrict__ p,
            uint8_t* __restrict__ mq, float* __restrict__ ms,
            uint8_t* __restrict__ vq, float* __restrict__ vs,
            const float* __restrict__ tables, long long n, long long nb,
            Hyper h) {
  __shared__ float t[TABLE_N];
  for (int i = threadIdx.x; i < TABLE_N; i += blockDim.x) t[i] = tables[i];
  __syncthreads();
  const float* smap = t;
  const float* umap = t + SMAP_N;
  const float* smid = umap + UMAP_N;
  const float* umid = smid + SMID_N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(p)) &
       15) == 0;

  for (long long blk = (long long)blockIdx.x * WARPS + warp; blk < nb;
       blk += (long long)gridDim.x * WARPS) {
    const long long base = blk * BLOCK + lane * PER_LANE;
    float gv[PER_LANE], pv[PER_LANE];
    const bool full = aligned && base + PER_LANE <= n;
    if (full) {
      const float4* g4 = reinterpret_cast<const float4*>(g + base);
      const float4* p4 = reinterpret_cast<const float4*>(p + base);
      float4 a = g4[0], b = g4[1], c = p4[0], d = p4[1];
      gv[0] = a.x; gv[1] = a.y; gv[2] = a.z; gv[3] = a.w;
      gv[4] = b.x; gv[5] = b.y; gv[6] = b.z; gv[7] = b.w;
      pv[0] = c.x; pv[1] = c.y; pv[2] = c.z; pv[3] = c.w;
      pv[4] = d.x; pv[5] = d.y; pv[6] = d.z; pv[7] = d.w;
    } else {
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const long long i = base + j;
        gv[j] = i < n ? g[i] : 0.f;
        pv[j] = i < n ? p[i] : 0.f;
      }
    }
    const uint2 mc = *reinterpret_cast<const uint2*>(mq + base);
    const uint2 vc = *reinterpret_cast<const uint2*>(vq + base);
    const float msc_old = ms[blk], vsc_old = vs[blk];

    float m[PER_LANE], v[PER_LANE];
    float mmax = 0.f, vmax = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const uint32_t qm = ((j < 4 ? mc.x : mc.y) >> (8 * (j & 3))) & 0xffu;
      const uint32_t qv = ((j < 4 ? vc.x : vc.y) >> (8 * (j & 3))) & 0xffu;
      const float mag = smap[qm & 127u];
      const float mo = __fmul_rn(qm >= 128u ? -mag : mag, msc_old);
      m[j] = __fadd_rn(__fmul_rn(h.b1, mo), __fmul_rn(h.c1, gv[j]));
      const float vo = __fmul_rn(umap[qv], vsc_old);
      v[j] = __fadd_rn(__fmul_rn(h.b2, vo),
                       __fmul_rn(__fmul_rn(h.c2, gv[j]), gv[j]));
      mmax = fmaxf(mmax, fabsf(m[j]));
      vmax = fmaxf(vmax, v[j]);
    }
    const float msc = fmaxf(warp_max(mmax), 1e-32f);
    const float vsc = fmaxf(warp_max(vmax), 1e-32f);

    uint32_t mw[2] = {0u, 0u}, vw[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const uint32_t cm =
          lower_bound<7>(smid, __fdiv_rn(fabsf(m[j]), msc)) +
          (m[j] < 0.f ? 128u : 0u);
      const uint32_t cv = lower_bound<8>(umid, __fdiv_rn(v[j], vsc));
      mw[j >> 2] |= cm << (8 * (j & 3));
      vw[j >> 2] |= cv << (8 * (j & 3));
      const float upd = __fdiv_rn(
          __fdiv_rn(m[j], h.bc1),
          __fadd_rn(__fsqrt_rn(__fdiv_rn(v[j], h.bc2)), h.eps));
      const float u = __fadd_rn(upd, __fmul_rn(h.wd, pv[j]));
      pv[j] = __fadd_rn(pv[j], __fmul_rn(h.neglr, u));
    }
    *reinterpret_cast<uint2*>(mq + base) = make_uint2(mw[0], mw[1]);
    *reinterpret_cast<uint2*>(vq + base) = make_uint2(vw[0], vw[1]);
    if (lane == 0) {
      ms[blk] = msc;
      vs[blk] = vsc;
    }
    if (full) {
      float4* p4 = reinterpret_cast<float4*>(p + base);
      p4[0] = make_float4(pv[0], pv[1], pv[2], pv[3]);
      p4[1] = make_float4(pv[4], pv[5], pv[6], pv[7]);
    } else {
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j)
        if (base + j < n) p[base + j] = pv[j];
    }
  }
}

}  // namespace adam8

// g, p: [n] fp32 in the leaf's block order; m_q, v_q: [ceil(n / 256), 256]
// uint8 (8-byte aligned); m_scale, v_scale: [ceil(n / 256)] fp32; tables:
// the 766 fp32 values of optim8bit.code_tables. p and the state are
// updated in place.
extern "C" int adam8bit_step(const void* g, void* p, void* m_q,
                             void* m_scale, void* v_q, void* v_scale,
                             const void* tables, long long n, float b1,
                             float c1, float b2, float c2, float eps,
                             float bc1, float bc2, float wd, float neglr,
                             void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long nb = (n + adam8::BLOCK - 1) / adam8::BLOCK;
  const long long want = (nb + adam8::WARPS - 1) / adam8::WARPS;
  const long long cap = (long long)adam8::SMS * adam8::BLOCKS_PER_SM;
  const int grid = (int)(want < cap ? want : cap);
  const adam8::Hyper h{b1, c1, b2, c2, eps, bc1, bc2, wd, neglr};
  adam8::step_kernel<<<grid, adam8::WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)g, (float*)p, (uint8_t*)m_q, (float*)m_scale,
      (uint8_t*)v_q, (float*)v_scale, (const float*)tables, n, nb, h);
  RETURN_IF_ERR();
  return 0;
}
