// Shared helpers for the port's Hopper kernels (plain C ABI, no torch headers).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define RETURN_IF_ERR()                                 \
  do {                                                  \
    cudaError_t e_ = cudaGetLastError();                \
    if (e_ != cudaSuccess) return (int)e_;              \
  } while (0)

__device__ __forceinline__ float bf(float v) {
  // round to bf16 and back: the rounding points of the plain twins
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum; every thread gets the result. blockDim.x % 32 == 0, <= 1024.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < nw; ++i) t += red[i];
  return t;
}
