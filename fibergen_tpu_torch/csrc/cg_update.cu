// cg_update: the end of a linear CG step in one pass over the fields, and
// the fixed-order finishing sum of its <r, r>.
//
// Replaces the end of the JAX package's CG step, which XLA fuses into one
// pass (fibergen_tpu/solvers/ls.py:679-683; no Pallas kernel):
//
//   alpha = gamma / (denom + tiny)
//   eps  <- eps + alpha p
//   r    <- r + alpha (w - p)
//   delta = sum_c wv_c sum_v r_c^2 / nvox + shift
//
// with the Voigt weights wv = (1, 1, 1, 2, 2, 2) for C = 6 and (1, 1, 1) for
// C = 3 as template constants (nothing is uploaded), and gamma and denom 0-d
// device values (no host read).  The float ops are those of the plain
// PyTorch sequence on the card, rounded at the same places (torch's
// addcmul_ is one FMA there; w - p is rounded first), so eps and r come out
// as they did before the kernel.
//
// Bound on the card: device-memory bytes.  It reads eps, r, p and w and
// writes eps and r: 6 C values per voxel for 5 flops a value; the plain
// sequence (addcmul_, sub_, addcmul_, two products and a sum) moves about 15
// field passes for the same result.  Design: the four (C, nvox) fields are
// walked as flat arrays of C nvox values, 16-byte vectors (float4 /
// double2) along the contiguous axis, with a scalar tail for a value count
// that is not a multiple of the vector, and the scalar path alone where a
// pointer is not 16-byte aligned.  The new r is squared and summed in
// double while it is in registers (a float's square is exact in double);
// the weight of a value follows from its flat index (the shear components
// are the last 3 nvox of C = 6).  The grid is a fixed number of blocks for
// the value count and the card's SM count, grid-stride, so each thread
// adds the same values in the same order on every call; a block reduces in
// double (warp shuffles, then shared memory) into one partial, and
// cg_update_finish adds the partials in a fixed order in one block: delta
// is the same bits from run to run.  No atomics.

#include "fg_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;     // 2048 threads a SM: full occupancy
constexpr int kFinishThreads = 1024;

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

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

// One value of the update: eps and r in place; returns wv r_new^2 in double.
// `shear` is the flat index where the weight-2 components begin.
template <typename T, int C>
__device__ __forceinline__ double update_one(T& e, T& r, T p, T w, T a,
                                             int64_t i, int64_t shear) {
  e = fma_rn(p, a, e);
  r = fma_rn(sub_rn(w, p), a, r);
  const double q = static_cast<double>(r) * static_cast<double>(r);
  return (C == 6 && i >= shear) ? 2.0 * q : q;
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads) cg_update_kernel(
    T* __restrict__ eps, T* __restrict__ r, const T* __restrict__ p,
    const T* __restrict__ w, const T* __restrict__ gamma,
    const T* __restrict__ denom, T tiny, int64_t nvox, bool vec,
    double* __restrict__ partials) {
  const T a = div_rn(gamma[0], add_rn(denom[0], tiny));
  const int64_t total = C * nvox;
  const int64_t shear = 3 * nvox;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  double acc = 0.0;
  int64_t done = 0;
  if (vec) {
    using V = typename Vec<T>::type;
    constexpr int L = Vec<T>::n;
    const int64_t groups = total / L;
    for (int64_t g = t; g < groups; g += stride) {
      V ev = reinterpret_cast<const V*>(eps)[g];
      V rv = reinterpret_cast<const V*>(r)[g];
      const V pv = reinterpret_cast<const V*>(p)[g];
      const V wv = reinterpret_cast<const V*>(w)[g];
      T* e = reinterpret_cast<T*>(&ev);
      T* rr = reinterpret_cast<T*>(&rv);
      const T* pp = reinterpret_cast<const T*>(&pv);
      const T* ww = reinterpret_cast<const T*>(&wv);
#pragma unroll
      for (int l = 0; l < L; ++l)
        acc += update_one<T, C>(e[l], rr[l], pp[l], ww[l], a, g * L + l,
                                shear);
      reinterpret_cast<V*>(eps)[g] = ev;
      reinterpret_cast<V*>(r)[g] = rv;
    }
    done = groups * L;
  }
  for (int64_t i = done + t; i < total; i += stride) {
    T e = eps[i], rr = r[i];
    acc += update_one<T, C>(e, rr, p[i], w[i], a, i, shear);
    eps[i] = e;
    r[i] = rr;
  }
  acc = fg::block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

// delta = (the partials added in order) / nvox, rounded to T, plus shift.
template <typename T>
__global__ void cg_update_finish(const double* __restrict__ partials,
                                 int count, int64_t nvox, T shift,
                                 T* __restrict__ delta) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < count; i += blockDim.x) acc += partials[i];
  acc = fg::block_sum(acc);
  if (threadIdx.x == 0)
    delta[0] = add_rn(static_cast<T>(acc / static_cast<double>(nvox)), shift);
}

bool aligned16(const void* x) {
  return (reinterpret_cast<unsigned long long>(x) & 15ull) == 0;
}

template <typename T>
int launch(int c, long long nvox, const void* gamma, const void* denom,
           double tiny, double shift, void* eps, void* r, const void* p,
           const void* w, int sms, void* partials, void* delta,
           void* stream) {
  if (c != 3 && c != 6) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(eps) && aligned16(r) && aligned16(p) &&
                   aligned16(w);
  const int64_t total = static_cast<int64_t>(c) * nvox;
  const int64_t work = vec ? total / Vec<T>::n + total % Vec<T>::n : total;
  const int64_t need = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      need < static_cast<int64_t>(sms) * kBlocksPerSM
          ? (need > 0 ? need : 1)
          : static_cast<int64_t>(sms) * kBlocksPerSM);
  auto s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<T*>(eps), static_cast<T*>(r), static_cast<const T*>(p),
        static_cast<const T*>(w), static_cast<const T*>(gamma),
        static_cast<const T*>(denom), static_cast<T>(tiny),
        static_cast<int64_t>(nvox), vec, static_cast<double*>(partials));
  };
  if (c == 6)
    go(cg_update_kernel<T, 6>);
  else
    go(cg_update_kernel<T, 3>);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  cg_update_finish<T><<<1, kFinishThreads, 0, s>>>(
      static_cast<const double*>(partials), blocks,
      static_cast<int64_t>(nvox), static_cast<T>(shift),
      static_cast<T*>(delta));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The size of the partials scratch (doubles) on a card of `sms` SMs: the
// most blocks the update launches.
extern "C" long long cg_update_partials(int sms) {
  return static_cast<long long>(sms) * kBlocksPerSM;
}

// One update of the (c, nvox) fields eps, r (in place), p and w (read) by
// the 0-d gamma and denom; writes the 0-d delta.  c is 3 or 6; `partials`
// holds cg_update_partials(sms) doubles.
#define FG_CG_UPDATE_ENTRY(NAME, T)                                          \
  extern "C" int NAME(int c, long long nvox, const void* gamma,              \
                      const void* denom, double tiny, double shift,          \
                      void* eps, void* r, const void* p, const void* w,      \
                      int sms, void* partials, void* delta, void* stream) {  \
    return launch<T>(c, nvox, gamma, denom, tiny, shift, eps, r, p, w, sms,  \
                     partials, delta, stream);                               \
  }

FG_CG_UPDATE_ENTRY(cg_update_f32, float)
FG_CG_UPDATE_ENTRY(cg_update_f64, double)
