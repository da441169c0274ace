// Device helpers shared by the projection kernels of mono.cu (boxes up to
// 73 pixels a side) and wide.cu (larger boxes).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace scarlet {

constexpr int kUnroll = 4;  // passes per convergence test (MONO_UNROLL)

// NEIGHBOR_OFFSETS[d] = (dy, dx), d = 0..7
__device__ __forceinline__ int dir_dy(int d) {
  return d < 3 ? -1 : (d < 5 ? 0 : 1);
}
__device__ __forceinline__ int dir_dx(int d) {
  return (d == 0 || d == 3 || d == 5) ? -1 : ((d == 1 || d == 6) ? 0 : 1);
}

// The max over the block of each thread's v; every thread gets it.
// `red`: 33 floats of shared memory.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float u = lane < nwarps ? red[lane] : -CUDART_INF_F;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      u = fmaxf(u, __shfl_xor_sync(0xffffffffu, u, off));
    if (lane == 0) red[32] = u;
  }
  __syncthreads();
  return red[32];
}

}  // namespace scarlet
