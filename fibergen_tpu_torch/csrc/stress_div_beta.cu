// K1 stress_div_beta: CG direction update + isotropic stress difference +
// staggered divergence in one pass, optionally with the grid sum of tau.
//
// Replaces the TPU kernels fibergen_tpu/ops/pallas_sweep.py
// stress_div_beta_sweep (want_tau_sum=False and True), pallas_kernels.py
// stress_div_beta_staggered and pallas_kernels.py stress_div_staggered
// (init mode).  Maths (pallas_sweep.py:128-150):
//
//   p   = r + beta p_prev                        (step mode; init: p = r)
//   tau = 2(mu - mu0) p + (lam - lam0) tr(p) I   (normals), 2(mu - mu0) p (shears)
//   f0  = D-x tau0 + D+y tau5 + D+z tau4
//   f1  = D+x tau5 + D-y tau1 + D+z tau3
//   f2  = D+x tau4 + D+y tau3 + D-z tau2          (h = n/d per axis)
//
// and, in tau-sum mode, the per-component grid sum of tau (6 values): the
// mean correction of the viscosity Delta scheme (ls.py fused_visc,
// fibergen.cpp:20446-20453).
//
// Bound on the card: device-memory bytes.  Step mode reads r, p_prev (6 each)
// and mu, lam, and writes f (3) and p (6): 23 values per voxel against about
// 60 flops, far below the H100's flop/byte balance; the tau sum adds 6 values
// per block.  Design: one thread per voxel, z fastest so a warp's loads
// coalesce; tau at the six face neighbours is recomputed from p there (p
// itself is recomputed from r and p_prev), so no intermediate field touches
// device memory and every value is written once.  The neighbour re-reads hit
// L1/L2 (a z-row of a plane is reused by the y and x neighbours of nearby
// blocks).  beta is read from device memory (gamma / gamma_prev), so the host
// never syncs for it.  The TPU kernel chains a Kahan sum of tau through its
// sequential grid; blocks here run in no order, so each block reduces its
// voxels' tau in double into six partials (one six-wide reduction, one
// barrier) and fg::sum_partials adds them in a fixed order, as K2 does for
// its dot: the same result on every run.
// Tiling a slab through shared memory, or TMA, is a later refinement.

#include "fg_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSumThreads = 1024;

template <typename T, bool STEP>
struct Dir {
  const T* __restrict__ r;
  const T* __restrict__ pp;
  T b;
  int64_t n;
  __device__ __forceinline__ T operator()(int c, int64_t v) const {
    if (STEP) return r[c * n + v] + b * pp[c * n + v];
    return r[c * n + v];
  }
};

template <typename T, bool STEP, bool TS>
__global__ void stress_div_beta_kernel(
    const T* __restrict__ r, const T* __restrict__ pp,
    const T* __restrict__ bnum, const T* __restrict__ bden,
    const T* __restrict__ mu, const T* __restrict__ lam, T mu0, T lam0,
    T hx, T hy, T hz, int nx, int ny, int nz,
    T* __restrict__ f, T* __restrict__ pout, double* __restrict__ partials) {
  const int64_t n = static_cast<int64_t>(nx) * ny * nz;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  double ts[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};   // this voxel's tau
  if (v < n) {
    T b = T(0);
    if (STEP) b = bden ? bnum[0] / bden[0] : bnum[0];
    const Dir<T, STEP> P{r, pp, b, n};
    const fg::Nbr nb = fg::neighbours(v, nx, ny, nz);

    T p[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) p[c] = P(c, v);
    if (STEP) {
#pragma unroll
      for (int c = 0; c < 6; ++c) pout[c * n + v] = p[c];
    }
    const T dmu = T(2) * (mu[v] - mu0);
    const T ltr = (lam[v] - lam0) * (p[0] + p[1] + p[2]);
    const T t0 = dmu * p[0] + ltr, t1 = dmu * p[1] + ltr, t2 = dmu * p[2] + ltr;
    const T t3 = dmu * p[3], t4 = dmu * p[4], t5 = dmu * p[5];

    // normal component `c` of tau at neighbour w
    auto tn = [&](int c, int64_t w) {
      const T q0 = P(0, w), q1 = P(1, w), q2 = P(2, w);
      const T q = c == 0 ? q0 : (c == 1 ? q1 : q2);
      return T(2) * (mu[w] - mu0) * q + (lam[w] - lam0) * (q0 + q1 + q2);
    };
    // shear component `c` of tau at neighbour w
    auto tsh = [&](int c, int64_t w) { return T(2) * (mu[w] - mu0) * P(c, w); };

    const T f0 = (t0 - tn(0, nb.xm)) * hx + (tsh(5, nb.yp) - t5) * hy
               + (tsh(4, nb.zp) - t4) * hz;
    const T f1 = (tsh(5, nb.xp) - t5) * hx + (t1 - tn(1, nb.ym)) * hy
               + (tsh(3, nb.zp) - t3) * hz;
    const T f2 = (tsh(4, nb.xp) - t4) * hx + (tsh(3, nb.yp) - t3) * hy
               + (t2 - tn(2, nb.zm)) * hz;
    f[v] = f0;
    f[n + v] = f1;
    f[2 * n + v] = f2;
    if (TS) {   // widened only now, so no double is live across the stencil
      ts[0] = t0; ts[1] = t1; ts[2] = t2;
      ts[3] = t3; ts[4] = t4; ts[5] = t5;
    }
  }
  if (TS) {
    const double s = fg::block_sums(ts);
    if (threadIdx.x < 6) partials[threadIdx.x * gridDim.x + blockIdx.x] = s;
  }
}

template <typename T>
int launch(const void* r, const void* pp, const void* bnum, const void* bden,
           const void* mu, const void* lam, double mu0, double lam0,
           double hx, double hy, double hz, int nx, int ny, int nz,
           void* f, void* pout, void* partials, void* tau_sum, void* stream) {
  const int64_t n = static_cast<int64_t>(nx) * ny * nz;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  auto s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel, const void* p_prev, void* p_out) {
    kernel<<<blocks, kThreads, 0, s>>>(
        (const T*)r, (const T*)p_prev, (const T*)bnum, (const T*)bden,
        (const T*)mu, (const T*)lam, T(mu0), T(lam0), T(hx), T(hy), T(hz),
        nx, ny, nz, (T*)f, (T*)p_out, (double*)partials);
  };
  if (pp && partials)
    go(stress_div_beta_kernel<T, true, true>, pp, pout);
  else if (pp)
    go(stress_div_beta_kernel<T, true, false>, pp, pout);
  else if (partials)
    go(stress_div_beta_kernel<T, false, true>, nullptr, nullptr);
  else
    go(stress_div_beta_kernel<T, false, false>, nullptr, nullptr);
  if (!partials) return static_cast<int>(cudaGetLastError());
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  fg::sum_partials<T><<<6, kSumThreads, 0, s>>>(
      (const double*)partials, static_cast<int64_t>(blocks), (T*)tau_sum);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Number of per-block partials per component that tau-sum mode writes (the
// scratch holds six times as many).
extern "C" long long stress_div_beta_partials(int nx, int ny, int nz) {
  const int64_t n = static_cast<int64_t>(nx) * ny * nz;
  return (n + kThreads - 1) / kThreads;
}

// pp == nullptr selects init mode (p = r, pout unused).  bden == nullptr
// reads beta = bnum[0]; otherwise beta = bnum[0] / bden[0].  partials ==
// nullptr skips the tau sum (tau_sum unused); otherwise tau_sum gets the
// six per-component sums of tau.
#define FG_K1_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* r, const void* pp, const void* bnum,        \
                      const void* bden, const void* mu, const void* lam,      \
                      double mu0, double lam0, double hx, double hy,          \
                      double hz, int nx, int ny, int nz, void* f, void* pout, \
                      void* partials, void* tau_sum, void* stream) {          \
    return launch<T>(r, pp, bnum, bden, mu, lam, mu0, lam0, hx, hy, hz, nx,   \
                     ny, nz, f, pout, partials, tau_sum, stream);             \
  }

FG_K1_ENTRY(stress_div_beta_f32, float)
FG_K1_ENTRY(stress_div_beta_f64, double)
