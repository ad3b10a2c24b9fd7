// RMSNorm forward and backward for Hopper (y = w * x / rms, fp32 statistics).
//
// Replaces: vlaser_tpu/kernels/rmsnorm.py :: _rms_fwd (_fwd_kernel,
// pallas_call at :68) and _rms_bwd (_bwd_kernel, pallas_call at :94).
//
// What bounds it on the H100: at the training shape (12,288 rows x 1536,
// bf16) the forward moves 2 x 37.7 MB and the backward 3 x 37.7 MB for a few
// flop per element, so device memory bounds both (3.35 TB/s: ~23 / ~34 us).
//
// What the design does about it: one warp per row, 16-byte loads, the row's
// statistic reduced in registers with shuffles, one pass in and one pass out
// (the second read of the row hits L1). The TPU kernel accumulates dw in one
// output block revisited by every grid step, which is race-free only because
// a TPU grid runs in order. Here blocks run in parallel in no order, so each
// block of the backward writes its own fp32 partial row of dw (summed in a
// fixed row order, re-reading its rows from L2 column-wise), and a second
// small kernel sums the partials in block order: no float atomics, so dw is
// the same bit for bit from run to run.
#include "common.cuh"

namespace rms {

constexpr int WARPS = 8, THREADS = 32 * WARPS;

__device__ __forceinline__ void load8(const bf16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }

// y = x * rrms * w (fp32, then x's dtype); rrms = rsqrt(mean(x^2) + eps).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, float* __restrict__ rrms, int n, int H,
               float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n) return;
  const T* xr = x + (size_t)row * H;
  float ss = 0.f;
  for (int c = lane * 8; c < H; c += 256) {
    float v[8];
    load8(xr + c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) ss += v[i] * v[i];
  }
  const float r = rsqrtf(warp_sum(ss) / (float)H + eps);
  T* yr = y + (size_t)row * H;
  for (int c = lane * 8; c < H; c += 256) {
    float v[8], wv[8];
    load8(xr + c, v);
    load8(w + c, wv);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = v[i] * r * wv[i];
    store8(yr + c, v);
  }
  if (lane == 0) rrms[row] = r;
}

// dx = g*w*rrms - x * (sum(g*w*x) * rrms^3 / H) for rows [r0, r0 + R);
// part[blockIdx.x][col] = sum over those rows of g * x * rrms.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ g, const float* __restrict__ rrms,
               T* __restrict__ dx, float* __restrict__ part, int n, int H,
               int R) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * R, r1 = min(n, r0 + R);
  for (int row = r0 + warp; row < r1; row += WARPS) {
    const T* xr = x + (size_t)row * H;
    const T* gr = g + (size_t)row * H;
    const float r = rrms[row];
    float dot = 0.f;
    for (int c = lane * 8; c < H; c += 256) {
      float xv[8], gv[8], wv[8];
      load8(xr + c, xv);
      load8(gr + c, gv);
      load8(w + c, wv);
#pragma unroll
      for (int i = 0; i < 8; ++i) dot += gv[i] * wv[i] * xv[i];
    }
    const float coef = warp_sum(dot) * (r * r * r) / (float)H;
    T* dr = dx + (size_t)row * H;
    for (int c = lane * 8; c < H; c += 256) {
      float xv[8], gv[8], wv[8];
      load8(xr + c, xv);
      load8(gr + c, gv);
      load8(w + c, wv);
#pragma unroll
      for (int i = 0; i < 8; ++i) xv[i] = gv[i] * wv[i] * r - xv[i] * coef;
      store8(dr + c, xv);
    }
  }
  for (int col = threadIdx.x; col < H; col += THREADS) {
    float acc = 0.f;
    for (int row = r0; row < r1; ++row) {
      const size_t i = (size_t)row * H + col;
      acc += to_f(g[i]) * to_f(x[i]) * rrms[row];
    }
    part[(size_t)blockIdx.x * H + col] = acc;
  }
}

// dw[col] = sum over blocks, in block order, of part[block][col].
__global__ void sum_parts_kernel(const float* __restrict__ part,
                                 float* __restrict__ dw, int nparts, int H) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= H) return;
  float acc = 0.f;
  for (int p = 0; p < nparts; ++p) acc += part[(size_t)p * H + col];
  dw[col] = acc;
}

template <typename T>
int fwd(const void* x, const void* w, void* y, void* rrms, int n, int H,
        float eps, cudaStream_t st) {
  fwd_kernel<T><<<(n + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      (const T*)x, (const T*)w, (T*)y, (float*)rrms, n, H, eps);
  RETURN_IF_ERR();
  return 0;
}

template <typename T>
int bwd(const void* x, const void* w, const void* g, const void* rrms, void* dx,
        void* part, void* dw, int n, int H, int R, cudaStream_t st) {
  const int nparts = (n + R - 1) / R;
  bwd_kernel<T><<<nparts, THREADS, 0, st>>>(
      (const T*)x, (const T*)w, (const T*)g, (const float*)rrms, (T*)dx,
      (float*)part, n, H, R);
  RETURN_IF_ERR();
  sum_parts_kernel<<<(H + 255) / 256, 256, 0, st>>>((const float*)part,
                                                    (float*)dw, nparts, H);
  RETURN_IF_ERR();
  return 0;
}

}  // namespace rms

// x/w/y share one dtype (bf16 when is_bf16, else fp32); rrms [n] fp32.
// H % 8 == 0 and 16-byte aligned rows.
extern "C" int rms_norm_fwd(const void* x, const void* w, void* y, void* rrms,
                            int n, int H, float eps, int is_bf16,
                            void* stream) {
  if (H % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? rms::fwd<bf16>(x, w, y, rrms, n, H, eps, st)
                 : rms::fwd<float>(x, w, y, rrms, n, H, eps, st);
}

// part: [ceil(n / rows_per_block), H] fp32 scratch; dw [H] fp32.
extern "C" int rms_norm_bwd(const void* x, const void* w, const void* g,
                            const void* rrms, void* dx, void* part, void* dw,
                            int n, int H, int rows_per_block, int is_bf16,
                            void* stream) {
  if (H % 8 || rows_per_block <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? rms::bwd<bf16>(x, w, g, rrms, dx, part, dw, n, H,
                                  rows_per_block, st)
                 : rms::bwd<float>(x, w, g, rrms, dx, part, dw, n, H,
                                   rows_per_block, st);
}
