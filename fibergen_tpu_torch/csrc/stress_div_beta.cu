// K1 stress_div_beta: CG direction update + isotropic stress difference +
// staggered divergence in one pass.
//
// Replaces the TPU kernels fibergen_tpu/ops/pallas_sweep.py
// stress_div_beta_sweep (want_tau_sum=False), pallas_kernels.py
// stress_div_beta_staggered and pallas_kernels.py stress_div_staggered
// (init mode).  Maths (pallas_sweep.py:128-150):
//
//   p   = r + beta p_prev                        (step mode; init: p = r)
//   tau = 2(mu - mu0) p + (lam - lam0) tr(p) I   (normals), 2(mu - mu0) p (shears)
//   f0  = D-x tau0 + D+y tau5 + D+z tau4
//   f1  = D+x tau5 + D-y tau1 + D+z tau3
//   f2  = D+x tau4 + D+y tau3 + D-z tau2          (h = n/d per axis)
//
// Bound on the card: device-memory bytes.  Step mode reads r, p_prev (6 each)
// and mu, lam, and writes f (3) and p (6): 23 values per voxel against about
// 60 flops, far below the H100's flop/byte balance.  Design: one thread per
// voxel, z fastest so a warp's loads coalesce; tau at the six face
// neighbours is recomputed from p there (p itself is recomputed from r and
// p_prev), so no intermediate field touches device memory and every value
// is written once.  The neighbour re-reads hit L1/L2 (a z-row of a plane is
// reused by the y and x neighbours of nearby blocks).  beta is read from
// device memory (gamma / gamma_prev), so the host never syncs for it.
// Tiling a slab through shared memory, or TMA, is a later refinement.

#include "fg_common.cuh"

namespace {

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

template <typename T, bool STEP>
__global__ void stress_div_beta_kernel(
    const T* __restrict__ r, const T* __restrict__ pp,
    const T* __restrict__ bnum, const T* __restrict__ bden,
    const T* __restrict__ mu, const T* __restrict__ lam, T mu0, T lam0,
    T hx, T hy, T hz, int nx, int ny, int nz,
    T* __restrict__ f, T* __restrict__ pout) {
  const int64_t n = static_cast<int64_t>(nx) * ny * nz;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= n) return;
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
  auto ts = [&](int c, int64_t w) { return T(2) * (mu[w] - mu0) * P(c, w); };

  const T f0 = (t0 - tn(0, nb.xm)) * hx + (ts(5, nb.yp) - t5) * hy
             + (ts(4, nb.zp) - t4) * hz;
  const T f1 = (ts(5, nb.xp) - t5) * hx + (t1 - tn(1, nb.ym)) * hy
             + (ts(3, nb.zp) - t3) * hz;
  const T f2 = (ts(4, nb.xp) - t4) * hx + (ts(3, nb.yp) - t3) * hy
             + (t2 - tn(2, nb.zm)) * hz;
  f[v] = f0;
  f[n + v] = f1;
  f[2 * n + v] = f2;
}

template <typename T>
int launch(const void* r, const void* pp, const void* bnum, const void* bden,
           const void* mu, const void* lam, double mu0, double lam0,
           double hx, double hy, double hz, int nx, int ny, int nz,
           void* f, void* pout, void* stream) {
  const int64_t n = static_cast<int64_t>(nx) * ny * nz;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  auto s = static_cast<cudaStream_t>(stream);
  if (pp) {
    stress_div_beta_kernel<T, true><<<blocks, threads, 0, s>>>(
        (const T*)r, (const T*)pp, (const T*)bnum, (const T*)bden,
        (const T*)mu, (const T*)lam, T(mu0), T(lam0), T(hx), T(hy), T(hz),
        nx, ny, nz, (T*)f, (T*)pout);
  } else {
    stress_div_beta_kernel<T, false><<<blocks, threads, 0, s>>>(
        (const T*)r, nullptr, nullptr, nullptr,
        (const T*)mu, (const T*)lam, T(mu0), T(lam0), T(hx), T(hy), T(hz),
        nx, ny, nz, (T*)f, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pp == nullptr selects init mode (p = r, pout unused).  bden == nullptr
// reads beta = bnum[0]; otherwise beta = bnum[0] / bden[0].
extern "C" int stress_div_beta_f32(
    const void* r, const void* pp, const void* bnum, const void* bden,
    const void* mu, const void* lam, double mu0, double lam0,
    double hx, double hy, double hz, int nx, int ny, int nz,
    void* f, void* pout, void* stream) {
  return launch<float>(r, pp, bnum, bden, mu, lam, mu0, lam0, hx, hy, hz,
                       nx, ny, nz, f, pout, stream);
}

extern "C" int stress_div_beta_f64(
    const void* r, const void* pp, const void* bnum, const void* bden,
    const void* mu, const void* lam, double mu0, double lam0,
    double hx, double hy, double hz, int nx, int ny, int nz,
    void* f, void* pout, void* stream) {
  return launch<double>(r, pp, bnum, bden, mu, lam, mu0, lam0, hx, hy, hz,
                        nx, ny, nz, f, pout, stream);
}
