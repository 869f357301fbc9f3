// K2 eps_from_u_dot: staggered symmetrized gradient plus the CG denominator,
// optionally with the viscosity Delta term.
//
// Replaces the TPU kernels fibergen_tpu/ops/pallas_sweep.py
// eps_from_u_dot_sweep (mu_x=None and the Delta variant with mu_x),
// pallas_kernels.py eps_from_u_dot_staggered and pallas_kernels.py
// eps_from_u_staggered (no-dot mode).  Maths (pallas_kernels.py:286-302,
// staggered.py:39-52, pallas_sweep.py:441-453):
//
//   w0 = E0 + D+x ux     w3 = E3 + (D-y uz + D-z uy) / 2
//   w1 = E1 + D+y uy     w4 = E4 + (D-x uz + D-z ux) / 2
//   w2 = E2 + D+z uz     w5 = E5 + (D-x uy + D-y ux) / 2
//
// in Delta mode plus  w_c += 2 tau2c (mu(x) - mu0) p_c  (tau2c folds the
// Delta coefficient 2 alpha mu0v, fibergen.cpp:20446-20458), and, in dot
// mode, the raw Voigt-weighted sum  sum_v sum_c wv_c p_c (p_c - w_c) with
// wv = (1, 1, 1, 2, 2, 2), against the full w.  Delta mode always takes p
// and computes the dot.
//
// Bound on the card: device-memory bytes (dot mode reads u (3) and p (6) and
// writes w (6): 15 values per voxel for about 40 flops; Delta mode also reads
// mu: 16 values).  Design: one thread per voxel, z fastest; the six
// neighbour values of u come from L1/L2.  The TPU kernel chains a Kahan sum
// across its sequential grid; blocks here run in no order, so each block
// reduces its voxels' terms in double (warp shuffles, then shared memory)
// into one partial in a scratch buffer, and fg::sum_partials sums the
// partials in a fixed order in one block.  No atomics: the result is the
// same from run to run.  E is a device vector.
//
// Halo mode (the sharded x-slab solve; replaces the axis_name variants of
// pallas_kernels.eps_from_u_staggered / eps_from_u_dot_staggered, whose
// dot is a psum over the mesh, pallas_kernels.py:409-410): the kernel runs
// on one x-slab and reads u_x at x+1 of its last plane from the plus halo
// plane and u_y, u_z at x-1 of its first plane from the minus halo plane
// (each a (3, 1, ny, nz) copy of the neighbouring slab's plane).  The dot
// stays this slab's deterministic two-pass sum; the caller adds the slabs'
// sums in slab order.  With the slab's own wrap as its halo the kernel is
// bitwise the periodic one.

#include "fg_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSumThreads = 1024;

template <typename T, bool DOT, bool DELTA>
__global__ void eps_from_u_kernel(
    const T* __restrict__ u, const T* __restrict__ E, const T* __restrict__ p,
    const T* __restrict__ mu, const T* um, const T* up, T tc2, T mu0, T hx,
    T hy, T hz, int nx, int ny, int nz, T* __restrict__ w,
    double* __restrict__ partials) {
  const int64_t n = static_cast<int64_t>(nx) * ny * nz;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  double acc = 0.0;
  if (v < n) {
    const fg::Nbr nb = fg::neighbours(v, nx, ny, nz, um != nullptr);
    const int64_t plane = static_cast<int64_t>(ny) * nz;
    const T* ux = u;
    const T* uy = u + n;
    const T* uz = u + 2 * n;
    // the sources of the x neighbours: the slab or a halo plane
    const T* uxp = nb.hxp ? up : ux;
    const T* uym = nb.hxm ? um + plane : uy;
    const T* uzm = nb.hxm ? um + 2 * plane : uz;
    const T x0 = ux[v], y0 = uy[v], z0 = uz[v];
    T e[6];
    e[0] = E[0] + (uxp[nb.xp] - x0) * hx;
    e[1] = E[1] + (uy[nb.yp] - y0) * hy;
    e[2] = E[2] + (uz[nb.zp] - z0) * hz;
    e[3] = E[3] + T(0.5) * ((z0 - uz[nb.ym]) * hy + (y0 - uy[nb.zm]) * hz);
    e[4] = E[4] + T(0.5) * ((z0 - uzm[nb.xm]) * hx + (x0 - ux[nb.zm]) * hz);
    e[5] = E[5] + T(0.5) * ((y0 - uym[nb.xm]) * hx + (x0 - ux[nb.ym]) * hy);
    T pv[6];
    if (DOT) {
#pragma unroll
      for (int c = 0; c < 6; ++c) pv[c] = p[c * n + v];
    }
    if (DELTA) {
      const T d = tc2 * (mu[v] - mu0);
#pragma unroll
      for (int c = 0; c < 6; ++c) e[c] += d * pv[c];
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) w[c * n + v] = e[c];
    if (DOT) {
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const double t = static_cast<double>(pv[c] * (pv[c] - e[c]));
        acc += c < 3 ? t : 2.0 * t;
      }
    }
  }
  if (DOT) {
    acc = fg::block_sum(acc);
    if (threadIdx.x == 0) partials[blockIdx.x] = acc;
  }
}

template <typename T>
int launch(const void* u, const void* E, const void* p, const void* mu,
           const void* const* halo, double tau2c, double mu0, double hx,
           double hy, double hz, int nx, int ny, int nz, void* w,
           void* partials, void* dot, void* stream) {
  const int64_t n = static_cast<int64_t>(nx) * ny * nz;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  const T* um = halo ? static_cast<const T*>(halo[0]) : nullptr;
  const T* up = halo ? static_cast<const T*>(halo[1]) : nullptr;
  auto go = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, s>>>(
        (const T*)u, (const T*)E, (const T*)p, (const T*)mu, um, up,
        T(2 * tau2c), T(mu0), T(hx), T(hy), T(hz), nx, ny, nz, (T*)w,
        (double*)partials);
  };
  if (!p) {
    go(eps_from_u_kernel<T, false, false>);
    return static_cast<int>(cudaGetLastError());
  }
  if (mu)
    go(eps_from_u_kernel<T, true, true>);
  else
    go(eps_from_u_kernel<T, true, false>);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  fg::sum_partials<T><<<1, kSumThreads, 0, s>>>(
      (const double*)partials, static_cast<int64_t>(blocks), (T*)dot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Number of per-block partials the dot mode writes (the scratch size).
extern "C" long long eps_from_u_dot_partials(int nx, int ny, int nz) {
  const int64_t n = static_cast<int64_t>(nx) * ny * nz;
  return (n + kThreads - 1) / kThreads;
}

// p == nullptr selects no-dot mode (mu, partials and dot unused); mu !=
// nullptr (with p) selects Delta mode.  halo == nullptr: periodic x over the
// nx planes; otherwise halo mode on an x-slab of nx planes (hx still the
// whole grid's n/d), halo a host array of two device pointers: the minus
// and the plus (3, 1, ny, nz) planes of u.
#define FG_K2_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* u, const void* E, const void* p,            \
                      const void* mu, const void* const* halo, double tau2c,  \
                      double mu0, double hx, double hy, double hz, int nx,    \
                      int ny, int nz, void* w, void* partials, void* dot,     \
                      void* stream) {                                         \
    return launch<T>(u, E, p, mu, halo, tau2c, mu0, hx, hy, hz, nx, ny, nz,   \
                     w, partials, dot, stream);                               \
  }

FG_K2_ENTRY(eps_from_u_dot_f32, float)
FG_K2_ENTRY(eps_from_u_dot_f64, double)
