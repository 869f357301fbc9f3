// Shared helpers of the hand-written Hopper kernels of fibergen_tpu_torch.
//
// Fields are (ncomp, nx, ny, nz) contiguous, z fastest; one thread owns one
// voxel, so neighbouring threads of a warp touch neighbouring z addresses.
// Periodic neighbours come from index arithmetic, never from padded copies.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace fg {

// Linear offsets of the six periodic face neighbours of voxel v = (i, j, k).
struct Nbr {
  int64_t xm, xp, ym, yp, zm, zp;
};

__device__ __forceinline__ Nbr neighbours(int64_t v, int nx, int ny, int nz,
                                          int* ii = nullptr) {
  const int k = static_cast<int>(v % nz);
  const int64_t q = v / nz;
  const int j = static_cast<int>(q % ny);
  const int i = static_cast<int>(q / ny);
  const int64_t sx = static_cast<int64_t>(ny) * nz;
  const int64_t sy = nz;
  Nbr n;
  n.xm = v + (i == 0 ? (nx - 1) * sx : -sx);
  n.xp = v + (i == nx - 1 ? -(nx - 1) * sx : sx);
  n.ym = v + (j == 0 ? (ny - 1) * sy : -sy);
  n.yp = v + (j == ny - 1 ? -(ny - 1) * sy : sy);
  n.zm = v + (k == 0 ? nz - 1 : -1);
  n.zp = v + (k == nz - 1 ? -(nz - 1) : 1);
  if (ii) { ii[0] = i; ii[1] = j; ii[2] = k; }
  return n;
}

// Deterministic block sum of one double per thread (blockDim.x a multiple
// of 32, at most 1024); the result is valid in thread 0.
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[32];
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  x = (threadIdx.x < nwarps) ? warp_sums[threadIdx.x] : 0.0;
  if (warp == 0)
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace fg

// Each library is built from exactly one .cu file, so this definition
// appears once per library.
extern "C" const char* fg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
