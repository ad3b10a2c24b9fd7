// RMSNorm forward and backward for Hopper (y = w * x / rms, fp32 statistics).
//
// Replaces: vlaser_tpu/kernels/rmsnorm.py :: _rms_fwd (_fwd_kernel,
// pallas_call at :68) and _rms_bwd (_bwd_kernel, pallas_call at :94).
//
// What bounds it on the H100: at the training shape (12,288 rows x 1536,
// bf16) the forward moves 2 x 37.7 MB and the backward 3 x 37.7 MB (read x
// and g, write dx) for a few flop per element, so device memory bounds both
// (3.35 TB/s: ~23 / ~34 us).
//
// Forward: one warp per row, 16-byte loads, the row's statistic reduced in
// registers with shuffles, one pass in and one pass out (the second read of
// the row hits L1).
//
// Backward, one pass over x and g: each lane loads its columns of a row (48
// values each of x and g at H 1536, as 16-byte words) into registers once,
// takes the row's sum(g*w*x) from them, writes dx from them and adds g * x *
// rrms into its own fp32 dw accumulators in the same pass (its columns of
// its warp's row of shared memory: in registers, beside x and g, they
// would spill at two blocks an SM). Rows wider than
// 2,048 columns are cut into column slabs of 2,048 (a second grid
// dimension); a slab block then reads its whole row once more for the sum.
// The TPU kernel accumulates dw in one output block revisited by every grid
// step, which is race-free only because a TPU grid runs in order. Here
// blocks run in parallel in no order, so the warps of a block meet in shared
// memory, are summed in warp order into the block's own fp32 partial row of
// dw, and a second small kernel sums the partial rows in a fixed order: no
// float atomics. The rows per block are a function of n alone
// (kernels/rmsnorm.py rows_per_block: about two blocks per SM), never of
// the occupancy found at run time, so dw is the same bit for bit from run to
// run.
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

// 8 consecutive values of a row, held as loaded (bf16: one 16-byte word,
// fp32: two), unpacked to fp32 where they are used.
template <typename T>
struct Pack8 {
  uint4 u[sizeof(T) / 2];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < (int)(sizeof(T) / 2); ++i)
      u[i] = reinterpret_cast<const uint4*>(p)[i];
  }
  __device__ __forceinline__ void get(float v[8]) const {
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
      const float* f = reinterpret_cast<const float*>(u);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = f[i];
    }
  }
};

// The backward over rows [r0, r0 + R) and the columns of slab blockIdx.y
// (NC chunks of 256: lane l holds columns 256 c + 8 l .. + 7 of each):
// dx = g*w*rrms - x * (sum(g*w*x) * rrms^3 / H), and part[blockIdx.x][col] =
// the sum over those rows of g * x * rrms. Each warp takes every WARPS-th
// row; x and g stay in registers from the load to dx and dw. When the slab
// is the whole row (H <= 256 NC) the row's sum comes from those registers,
// else each block sums the whole row itself (read again through L1/L2).
// Each warp adds its rows' dw into its own row of shared memory (each lane
// into its own columns: no two threads share a word), which keeps the
// registers to x, g and the row's temporaries (two blocks of 8 warps an SM
// in bf16); the warps' rows are then summed in warp order.
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1)
    bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ g, const float* __restrict__ rrms,
               T* __restrict__ dx, float* __restrict__ part, int n, int H,
               int R) {
  extern __shared__ float red[];  // [WARPS][256 NC]
  constexpr int W = 256 * NC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.y * W;
  const int r0 = blockIdx.x * R, r1 = min(n, r0 + R);
  const bool whole = gridDim.y == 1;
  float* dw = red + warp * W + 8 * lane;  // + 256 c: this lane's chunk c
  const float zero[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NC; ++c) store8(dw + 256 * c, zero);
  for (int row = r0 + warp; row < r1; row += WARPS) {
    const T* xr = x + (size_t)row * H;
    const T* gr = g + (size_t)row * H;
    Pack8<T> xp[NC], gp[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = c0 + 256 * c + 8 * lane;
      if (col < H) {
        xp[c].load(xr + col);
        gp[c].load(gr + col);
      }
    }
    const float r = rrms[row];
    float dot = 0.f;
    if (whole) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = 256 * c + 8 * lane;
        if (col < H) {
          float xv[8], gv[8], wv[8];
          xp[c].get(xv);
          gp[c].get(gv);
          load8(w + col, wv);
#pragma unroll
          for (int i = 0; i < 8; ++i) dot += gv[i] * wv[i] * xv[i];
        }
      }
    } else {
      for (int col = lane * 8; col < H; col += 256) {
        float xv[8], gv[8], wv[8];
        load8(xr + col, xv);
        load8(gr + col, gv);
        load8(w + col, wv);
#pragma unroll
        for (int i = 0; i < 8; ++i) dot += gv[i] * wv[i] * xv[i];
      }
    }
    const float coef = warp_sum(dot) * (r * r * r) / (float)H;
    T* dr = dx + (size_t)row * H;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = c0 + 256 * c + 8 * lane;
      if (col < H) {
        float xv[8], gv[8], wv[8], acc[8];
        xp[c].get(xv);
        gp[c].get(gv);
        load8(w + col, wv);
        load8(dw + 256 * c, acc);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i] += gv[i] * xv[i] * r;
          xv[i] = gv[i] * wv[i] * r - xv[i] * coef;
        }
        store8(dw + 256 * c, acc);
        store8(dr + col, xv);
      }
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < W && c0 + col < H; col += THREADS) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) acc += red[k * W + col];
    part[(size_t)blockIdx.x * H + c0 + col] = acc;
  }
}

// dw[col] = the sum of part[p][col] over p, in a fixed order: SUM_GROUPS
// runs of consecutive p, each summed in p order, then the runs in order.
constexpr int SUM_COLS = 32, SUM_GROUPS = 8;
__global__ void __launch_bounds__(SUM_COLS* SUM_GROUPS)
    sum_parts_kernel(const float* __restrict__ part, float* __restrict__ dw,
                     int nparts, int H) {
  __shared__ float red[SUM_GROUPS][SUM_COLS];
  const int col = blockIdx.x * SUM_COLS + threadIdx.x, grp = threadIdx.y;
  const int per = (nparts + SUM_GROUPS - 1) / SUM_GROUPS;
  const int p1 = min(nparts, (grp + 1) * per);
  float acc = 0.f;
  if (col < H) {
#pragma unroll 8
    for (int p = grp * per; p < p1; ++p) acc += part[(size_t)p * H + col];
  }
  red[grp][threadIdx.x] = acc;
  __syncthreads();
  if (grp == 0 && col < H) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < SUM_GROUPS; ++k) t += red[k][threadIdx.x];
    dw[col] = t;
  }
}

template <typename T>
int fwd(const void* x, const void* w, void* y, void* rrms, int n, int H,
        float eps, cudaStream_t st) {
  fwd_kernel<T><<<(n + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      (const T*)x, (const T*)w, (T*)y, (float*)rrms, n, H, eps);
  RETURN_IF_ERR();
  return 0;
}

template <typename T, int NC>
int bwd_nc(const void* x, const void* w, const void* g, const void* rrms,
           void* dx, void* part, int n, int H, int R, cudaStream_t st) {
  constexpr int SMEM = WARPS * 256 * NC * 4;
  static const cudaError_t attr = cudaFuncSetAttribute(
      bwd_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((n + R - 1) / R, (H + 256 * NC - 1) / (256 * NC));
  bwd_kernel<T, NC><<<grid, THREADS, SMEM, st>>>(
      (const T*)x, (const T*)w, (const T*)g, (const float*)rrms, (T*)dx,
      (float*)part, n, H, R);
  RETURN_IF_ERR();
  return 0;
}

// NC: the fewest chunks of 256 columns (of 1, 2, 4, 6, 8) that hold the
// row; rows wider than 2,048 are cut into slabs of 2,048.
template <typename T>
int bwd(const void* x, const void* w, const void* g, const void* rrms, void* dx,
        void* part, void* dw, int n, int H, int R, cudaStream_t st) {
  const int chunks = (H + 255) / 256;
  int err = chunks <= 1   ? bwd_nc<T, 1>(x, w, g, rrms, dx, part, n, H, R, st)
            : chunks <= 2 ? bwd_nc<T, 2>(x, w, g, rrms, dx, part, n, H, R, st)
            : chunks <= 4 ? bwd_nc<T, 4>(x, w, g, rrms, dx, part, n, H, R, st)
            : chunks <= 6 ? bwd_nc<T, 6>(x, w, g, rrms, dx, part, n, H, R, st)
                          : bwd_nc<T, 8>(x, w, g, rrms, dx, part, n, H, R, st);
  if (err) return err;
  const int nparts = (n + R - 1) / R;
  sum_parts_kernel<<<(H + SUM_COLS - 1) / SUM_COLS,
                     dim3(SUM_COLS, SUM_GROUPS), 0, st>>>(
      (const float*)part, (float*)dw, nparts, H);
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
