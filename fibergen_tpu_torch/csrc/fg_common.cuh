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

// Deterministic block sums of K doubles per thread (blockDim.x a multiple
// of 32, at most 1024): warp shuffles for all K values, one barrier, then
// thread c < K adds component c's warp sums in warp order.  Returns
// component threadIdx.x's block sum in threads 0..K-1.
template <int K>
__device__ __forceinline__ double block_sums(double (&x)[K]) {
  __shared__ double warp_sums[K][32];
#pragma unroll
  for (int c = 0; c < K; ++c)
    for (int o = 16; o > 0; o >>= 1)
      x[c] += __shfl_down_sync(0xffffffffu, x[c], o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < K; ++c) warp_sums[c][warp] = x[c];
  }
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x < K)
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
      s += warp_sums[threadIdx.x][w];
  return s;
}

// Deterministic block sum of one double per thread; the result is valid
// in thread 0.
__device__ __forceinline__ double block_sum(double x) {
  double v[1] = {x};
  return block_sums(v);
}

// Second pass of a deterministic grid sum: block c adds the `count`
// per-block partials partials[c * count ...] in a fixed order into out[c].
// Launch with one block per summed component and a multiple of 32 threads.
template <typename T>
__global__ void sum_partials(const double* __restrict__ partials,
                             int64_t count, T* __restrict__ out) {
  const double* p = partials + blockIdx.x * count;
  double acc = 0.0;
  for (int64_t i = threadIdx.x; i < count; i += blockDim.x) acc += p[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = static_cast<T>(acc);
}

}  // namespace fg

// Each library is built from exactly one .cu file, so this definition
// appears once per library.
extern "C" const char* fg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
