// laminate_heat: the dim-3 (heat, porous flow) rank-1 laminate's stress
// difference of B strain fields in one pass over the grid.
//
// Replaces no TPU kernel: the JAX package forms the laminate in plain jnp
// (fibergen_tpu/materials/laminate.py), which XLA fuses.  On the card the
// port's plain sequence (materials/laminate.py: _unit_or_ex, the jump s,
// F1, F2, both phases' flux, then MixedMaterial.stress_diff's P - 2 mu0 F)
// is some 25 full-field passes and allocations a case.
//
// Per voxel, with the phase fractions c1, c2, the raw normal n (e_x where
// |n|^2 <= 1e-12, not normalised, as _unit_or_ex(n, False) leaves it), the
// conductivities k1 = 2 mu1, k2 = 2 mu2 and the jump weights a1 = c2,
// a2 = c1 (the laminate) or a1 = a2 = 1/2 (the infinity laminate):
//
//   s  = (c1 a1 k1 - c2 a2 k2) (n.F) / (c1 a1^2 k1 + c2 a2^2 k2)
//   F1 = F - a1 s n,  F2 = F + a2 s n
//   P  = c1 k1 F1 + c2 k2 F2 = kbar F - gamma (n.F) n
//
// with kbar = c1 k1 + c2 k2 and gamma = (c1 a1 k1 - c2 a2 k2)^2 /
// (c1 a1^2 k1 + c2 a2^2 k2) on the interface (c1 > 1e-7 and c2 > 1e-7),
// gamma = 0 elsewhere, for any length of n.  kbar and gamma are formed once
// a voxel in registers, then each case b writes
//
//   tau_b = (kbar - 2 mu0) F_b - gamma (n.F_b) n
//
// into its own output.  Everything is computed in the field's type.
//
// Bound on the card: device-memory bytes.  It reads phi1, phi2, the three
// normal components and 3 B strain components and writes 3 B stress
// components: 5 + 6 B values a voxel for about 15 + 9 B flops.  Design: a
// streaming kernel without shared memory.  The (3, nvox) fields are three
// contiguous planes, each walked with 16-byte vectors (float4 / double2)
// where nvox is a multiple of the vector and every pointer is 16-byte
// aligned, one scalar voxel at a time otherwise.  The grid is a fixed number
// of blocks for the voxel count and the card's SM count, grid-stride.  Up to
// kMaxCases case pointers go by value in the kernel's parameters, the
// per-case loop unrolled, so a voxel's coefficients stay in registers for
// every case; the host takes a larger batch in chunks.

#include "fg_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;     // 2048 threads a SM: full occupancy
constexpr int kMaxCases = 8;       // material_kernels.MAX_CASES
constexpr int kLaminate = 0;        // a1 = c2, a2 = c1
constexpr int kInfinity = 1;        // a1 = a2 = 1/2

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

template <typename T>
struct Cases {
  const T* x[kMaxCases];
  T* out[kMaxCases];
};

// A voxel's coefficients: the normal m, kbar - 2 mu0 and gamma.
template <typename T>
struct Coef {
  T m0, m1, m2, kd, g;
};

template <typename T, int RULE>
__device__ __forceinline__ Coef<T> coef(T c1, T c2, T n0, T n1, T n2, T k1,
                                        T k2, T two_mu0) {
  Coef<T> k;
  const T nn2 = n0 * n0 + n1 * n1 + n2 * n2;
  const bool keep = nn2 > static_cast<T>(1e-12);
  k.m0 = keep ? n0 : static_cast<T>(1);
  k.m1 = keep ? n1 : static_cast<T>(0);
  k.m2 = keep ? n2 : static_cast<T>(0);
  k.kd = c1 * k1 + c2 * k2 - two_mu0;
  k.g = static_cast<T>(0);
  const T thr = static_cast<T>(1e-7);
  if (c1 > thr && c2 > thr) {
    const T a1 = RULE == kLaminate ? c2 : static_cast<T>(0.5);
    const T a2 = RULE == kLaminate ? c1 : static_cast<T>(0.5);
    const T p1 = c1 * a1 * k1, p2 = c2 * a2 * k2;
    const T d = p1 - p2;
    k.g = d * d / (p1 * a1 + p2 * a2);
  }
  return k;
}

// tau of one voxel of one case, in place of (f0, f1, f2).
template <typename T>
__device__ __forceinline__ void apply(const Coef<T>& k, T& f0, T& f1, T& f2) {
  const T gn = k.g * (k.m0 * f0 + k.m1 * f1 + k.m2 * f2);
  f0 = k.kd * f0 - gn * k.m0;
  f1 = k.kd * f1 - gn * k.m1;
  f2 = k.kd * f2 - gn * k.m2;
}

template <typename T, int RULE>
__global__ void __launch_bounds__(kThreads) laminate_heat_kernel(
    const T* __restrict__ phi1, const T* __restrict__ phi2,
    const T* __restrict__ n, Cases<T> cases, int nb, T k1, T k2, T two_mu0,
    int64_t nvox, bool vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (vec) {
    using V = typename Vec<T>::type;
    constexpr int L = Vec<T>::n;
    const int64_t groups = nvox / L;      // nvox is a multiple of L here
    const V* c1v = reinterpret_cast<const V*>(phi1);
    const V* c2v = reinterpret_cast<const V*>(phi2);
    const V* nv = reinterpret_cast<const V*>(n);
    for (int64_t q = t; q < groups; q += stride) {
      const V c1 = c1v[q], c2 = c2v[q];
      const V n0 = nv[q], n1 = nv[groups + q], n2 = nv[2 * groups + q];
      const T* c1s = reinterpret_cast<const T*>(&c1);
      const T* c2s = reinterpret_cast<const T*>(&c2);
      const T* n0s = reinterpret_cast<const T*>(&n0);
      const T* n1s = reinterpret_cast<const T*>(&n1);
      const T* n2s = reinterpret_cast<const T*>(&n2);
      Coef<T> k[L];
#pragma unroll
      for (int l = 0; l < L; ++l)
        k[l] = coef<T, RULE>(c1s[l], c2s[l], n0s[l], n1s[l], n2s[l], k1, k2,
                             two_mu0);
#pragma unroll
      for (int b = 0; b < kMaxCases; ++b) {
        if (b >= nb) break;
        const V* x = reinterpret_cast<const V*>(cases.x[b]);
        V* o = reinterpret_cast<V*>(cases.out[b]);
        V f0 = x[q], f1 = x[groups + q], f2 = x[2 * groups + q];
        T* f0s = reinterpret_cast<T*>(&f0);
        T* f1s = reinterpret_cast<T*>(&f1);
        T* f2s = reinterpret_cast<T*>(&f2);
#pragma unroll
        for (int l = 0; l < L; ++l) apply(k[l], f0s[l], f1s[l], f2s[l]);
        o[q] = f0;
        o[groups + q] = f1;
        o[2 * groups + q] = f2;
      }
    }
    return;
  }
  for (int64_t i = t; i < nvox; i += stride) {
    const Coef<T> k = coef<T, RULE>(phi1[i], phi2[i], n[i], n[nvox + i],
                                    n[2 * nvox + i], k1, k2, two_mu0);
#pragma unroll
    for (int b = 0; b < kMaxCases; ++b) {
      if (b >= nb) break;
      const T* x = cases.x[b];
      T* o = cases.out[b];
      T f0 = x[i], f1 = x[nvox + i], f2 = x[2 * nvox + i];
      apply(k, f0, f1, f2);
      o[i] = f0;
      o[nvox + i] = f1;
      o[2 * nvox + i] = f2;
    }
  }
}

bool aligned16(const void* x) {
  return (reinterpret_cast<unsigned long long>(x) & 15ull) == 0;
}

template <typename T>
int launch(int rule, long long nvox, const void* phi1, const void* phi2,
           const void* n, int nb, const void* const* xs, void* const* outs,
           double k1, double k2, double two_mu0, int sms, void* stream) {
  if (nb < 1 || nb > kMaxCases || (rule != kLaminate && rule != kInfinity))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int L = Vec<T>::n;
  bool vec = nvox % L == 0 && aligned16(phi1) && aligned16(phi2) &&
             aligned16(n);
  Cases<T> cases = {};
  for (int b = 0; b < nb; ++b) {
    cases.x[b] = static_cast<const T*>(xs[b]);
    cases.out[b] = static_cast<T*>(outs[b]);
    vec = vec && aligned16(xs[b]) && aligned16(outs[b]);
  }
  const int64_t work = vec ? nvox / L : nvox;
  const int64_t need = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSM;
  const int blocks = static_cast<int>(need < cap ? (need > 0 ? need : 1)
                                                 : cap);
  auto s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(phi1), static_cast<const T*>(phi2),
        static_cast<const T*>(n), cases, nb, static_cast<T>(k1),
        static_cast<T>(k2), static_cast<T>(two_mu0),
        static_cast<int64_t>(nvox), vec);
  };
  if (rule == kLaminate)
    go(laminate_heat_kernel<T, kLaminate>);
  else
    go(laminate_heat_kernel<T, kInfinity>);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tau_b = (kbar - two_mu0) x_b - gamma (n.x_b) n for the nb <= 8 (3, nvox)
// fields xs[b] into outs[b], from the (nvox) phase fractions phi1, phi2 and
// the (3, nvox) normals n.  rule 0 is the laminate, 1 the infinity
// laminate.
#define FG_LAMINATE_HEAT_ENTRY(NAME, T)                                      \
  extern "C" int NAME(int rule, long long nvox, const void* phi1,            \
                      const void* phi2, const void* n, int nb,               \
                      const void* const* xs, void* const* outs, double k1,   \
                      double k2, double two_mu0, int sms, void* stream) {    \
    return launch<T>(rule, nvox, phi1, phi2, n, nb, xs, outs, k1, k2,        \
                     two_mu0, sms, stream);                                  \
  }

FG_LAMINATE_HEAT_ENTRY(laminate_heat_f32, float)
FG_LAMINATE_HEAT_ENTRY(laminate_heat_f64, double)
