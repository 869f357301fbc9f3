// K3 g0_staggered_chain, K4 g0_staggered_heat_chain, K5
// gamma_collocated_chain and K6 gamma_collocated_zt_chain: a spectral
// operator between hand-written transforms, u = irfftn(apply(rfftn(f))), on
// a real (C, nx, ny, nz) field.
//
// Replaces the TPU kernel fibergen_tpu/ops/pallas_chain.py _middle with
//   _g0_apply (K3, via g0_staggered_middle): the staggered elasticity G0 on
//     a 3-component force field (elasticity, the viscosity Delta scheme);
//   _g0_heat_apply (K4, via g0_staggered_heat_middle): the scalar G0 on a
//     1-component source field (heat, porous flow);
//   _gamma_collocated_apply (K5, via gamma_collocated_middle): the collocated
//     Gamma on a 6-component strain field (elasticity) or a 3-component
//     gradient field (heat, porous flow);
//   _zt_apply (K6, via gamma_collocated_zt_middle): the zero-trace collocated
//     Gamma of the viscosity Delta scheme on components 1..5 of a traceless
//     6-component field.
// and, with the part function of fibergen_tpu/ops/green.py
// gamma_collocated_hyper_fused, _gamma_collocated_apply (K5 at C = 9): the
// finite-strain collocated Gamma on a 9-component deformation-gradient
// field (hyperelasticity).
// _middle runs four matmul-DFT c2c stages (y, x forward; x, y inverse) with
// the apply between the x stages; the JAX package puts the z r2c/c2r stages
// around it.  Here the whole chain is five kernels, launched one after
// another on one stream:
//
//   z_fwd    real lines along z -> half-spectrum (C, nx, ny, nz/2+1)
//   y_line   c2c forward along y, in place
//   x_apply  c2c forward along x, the apply, c2c inverse along x, in place
//   y_line   c2c inverse along y, in place
//   z_inv    half-spectrum -> real lines along z (Hermitian completion)
//
// Batched (pallas_chain._middle under jax.vmap, which the JAX package's
// run_batched reaches through krylov_gen): B right-hand sides go through
// the same five launches, the case a grid axis of its own in the y and x
// passes (blockIdx.z, so that the C * nx rows of the y pass stay in
// blockIdx.y) and a run of lines in the z passes; each case's lines pair
// and transform as in a single chain, and the apply reads that case's DC
// vector, so the batch is bitwise B single chains.  A single right-hand
// side is the batch of one.
//
// The five passes are templates on the apply functor, which fixes the
// component count C, reads its own per-axis tables (natural rfft bin order,
// built in double on the host) and treats the DC bin itself.  The 1/N of
// norm="forward" is folded into the constants.
//   K3 (C = 3): eta = c1 f - c2 (f . k+) conj(k+), c1 = c10/|k|^2,
//       c2 = c20/|k|^4, k+_a = sin(xi_a) / h_a * exp(i xi_a); DC zeroed
//       (green.py:457-496, pallas_chain.py:288-314).
//   K4 (C = 1): eta = c10 f / |k+|^2, DC zeroed (pallas_chain.py:317-331).
//   K5 (C = 6): t = tau xi, s = xi . t, eta_ij = A (xi_i t_j + xi_j t_i) /
//       |xi|^2 + B xi_i xi_j s / |xi|^4 + beta tau_ij; (C = 3): eta_i = A
//       xi_i (xi . tau) / |xi|^2 + beta tau_i; real xi = f / d per axis, so
//       the coefficients act on the real and imaginary parts apart
//       (green.py:36-135, 260-299, 358-379).  The DC bin takes E, a device
//       vector of C values, in its real part: the unnormalized inverse of a
//       DC-only spectrum is that value at every voxel, so E is not scaled.
//   K5 (C = 9, GammaCollocatedHyper): the full tensor in the order xx yy zz
//       yz xz xy zy zx yx, t_i = tau_il xi_l, s = xi . t, eta_ij = A xi_j
//       t_i / |xi|^2 + B xi_i xi_j s / |xi|^4 + beta tau_ij; not symmetric
//       (yz and zy differ), so it has its own part (green.py:382-421).
//   K6 (C = 5 transformed): component 0 is rebuilt as -(c1 + c2) in
//       registers, the 6-component K5 apply runs, component 0 is dropped;
//       the DC bin takes E[1..5] (green.py:302-355, pallas_chain.py:400-444).
//       The caller forms out[0] = -(out[1] + out[2]) in real space.
// The collocated Gamma is even in xi, so the sign of a Nyquist bin's xi
// does not matter; at the kz = 0 and Nyquist planes the applied spectrum
// need not be Hermitian in (kx, ky), and z_inv keeps the real part there,
// as a c2r transform that drops those imaginary parts does.
//
// Line transforms.  A power-of-two length from 16 to 512 (every axis of
// the 256^3 and 512^3 bench grids) runs the register-resident line FFT (see "The
// register-resident line FFT" below): a line is held by n / V threads of V
// values (256 = 16 threads x 16 values), each Stockham stage is an
// R-point DFT in registers, and one exchange through shared memory (two for
// n = 512) joins the stages; the first stage reads its values straight
// from device memory and the last leaves them in natural order for the
// store.  Twiddles between stages come from a per-length table built in
// double on the host (spectral_kernels.plan_twiddles), those inside a
// stage are compile-time constants.  Any other length loads a tile of whole
// lines into shared memory: a power of two runs radix-4 passes (radix 2
// for an odd power), decimation in frequency to bit-reversed order and
// decimation in time back, the kernels reading bit-reversed bins where they
// store or apply; any other length a direct O(n^2) DFT from a per-axis
// table exp(-2 pi i t / n).  The choice is by length, per axis and pass.
// The z kernels pack two real lines into one complex transform (a + i b)
// and split or join their spectra by Hermitian symmetry (bins k and n - k
// of a line, from the exchange's own slots); with C = 1 the pairs are
// neighbouring y lines.
//
// Bound on the card: device-memory bytes.  The function reads f and writes
// u once (2C values per voxel, 2BC in a batch of B); the chain moves the
// spectrum five times, so it runs at about five times that bound at best.  Design: y and x tiles
// take TK consecutive kz bins of every line (coalesced along kz).  In the
// register passes a line's transform touches shared memory twice per value
// (one exchange, one barrier pair) instead of about eight times with four
// barriers, so the z and y passes run at 80-90 % of their own byte bounds
// at 256^3 (PERF.md).  The x kernel holds all C components of its tile,
// so the apply, which mixes components, happens between the forward and
// inverse x transforms without a trip through device memory, as in the
// TPU kernel: each thread transforms one component's line in registers,
// the C spectra meet in shared memory (natural order) for the apply, and
// each thread takes its line back for the inverse.  Its tile is C * nx *
// TK values with TK a 128-byte row segment (16 float32 bins), halved until
// the block has at most 1024 threads; its rows lie ny * nzl values apart,
// and narrower segments cost more than the lower occupancy of the larger
// tile.  The shared-memory route keeps its x tile within 96 KiB; the
// launcher refuses a tile past Hopper's 227 KiB (the error reaches the
// caller).

#include "fg_common.cuh"

namespace {

template <typename T>
struct alignas(2 * sizeof(T)) Cx {
  T r, i;
};

template <typename T>
__device__ __forceinline__ Cx<T> cmul(Cx<T> a, Cx<T> b) {
  return {a.r * b.r - a.i * b.i, a.r * b.i + a.i * b.r};
}
template <typename T>
__device__ __forceinline__ Cx<T> cadd(Cx<T> a, Cx<T> b) {
  return {a.r + b.r, a.i + b.i};
}
template <typename T>
__device__ __forceinline__ Cx<T> csub(Cx<T> a, Cx<T> b) {
  return {a.r - b.r, a.i - b.i};
}

// Position of bin j after a decimation-in-frequency pass (bit reversal);
// the identity for lengths that are not powers of two.
__device__ __forceinline__ int rev(int j, int log2n) {
  return log2n > 0 ? static_cast<int>(__brev(static_cast<unsigned>(j)) >>
                                      (32 - log2n))
                   : j;
}

// A tile in shared memory: nb batches of 2^log2l lines of length n; element
// j of line l of batch c is at s[c * bs + l * ls + j * es].
struct Tile {
  int n, log2n, log2l, nb, es, ls, bs;
};

// Work item e of a pass with 2^lg groups per line -> batch c, line l and
// group b; lines run fastest where they are adjacent (ls == 1).
__device__ __forceinline__ void item(const Tile& t, int e, int lg, int& c,
                                     int& l, int& b) {
  if (t.ls == 1) {
    l = e & ((1 << t.log2l) - 1);
    const int r = e >> t.log2l;
    b = r & ((1 << lg) - 1);
    c = r >> lg;
  } else {
    b = e & ((1 << lg) - 1);
    const int r = e >> lg;
    l = r & ((1 << t.log2l) - 1);
    c = r >> t.log2l;
  }
}

// Power-of-two DFTs of every line of the tile, in place.  dif: natural ->
// bit-reversed order; otherwise (decimation in time) bit-reversed ->
// natural.  `inv` conjugates the twiddles.  Ends with a __syncthreads.
template <typename T>
__device__ void fft_pow2(Cx<T>* s, const Tile& t, const Cx<T>* __restrict__ tw,
                         bool inv, bool dif) {
  const int nt = blockDim.x;
  const T sg = inv ? T(-1) : T(1);
  int left = t.log2n;
  int lh = dif ? t.log2n - 1 : 0;            // log2 of the current half size
  while (left > 0) {
    if (left >= 2) {
      // two radix-2 stages, half sizes hq and 2 hq, in one radix-4 pass
      const int lq = dif ? lh - 1 : lh;
      const int hq = 1 << lq;
      const int lg = t.log2n - 2;
      const int sa = t.log2n - 1 - lq, sb = t.log2n - 2 - lq;
      const int items = t.nb << (t.log2l + lg);
      for (int e = threadIdx.x; e < items; e += nt) {
        int c, l, b;
        item(t, e, lg, c, l, b);
        const int k = b & (hq - 1);
        const int i0 = ((b - k) << 2) + k;
        Cx<T>* p = s + c * t.bs + l * t.ls + i0 * t.es;
        const int d = hq * t.es;
        Cx<T> x0 = p[0], x1 = p[d], x2 = p[2 * d], x3 = p[3 * d];
        Cx<T> wa = tw[k << sa], wb = tw[k << sb];
        wa.i *= sg;
        wb.i *= sg;
        // W_{4hq}^{k+hq} = wb * W_4: times -i forward, +i inverse
        const Cx<T> wc = inv ? Cx<T>{-wb.i, wb.r} : Cx<T>{wb.i, -wb.r};
        Cx<T> u;
        if (dif) {
          u = csub(x0, x2); x0 = cadd(x0, x2); x2 = cmul(u, wb);
          u = csub(x1, x3); x1 = cadd(x1, x3); x3 = cmul(u, wc);
          u = csub(x0, x1); x0 = cadd(x0, x1); x1 = cmul(u, wa);
          u = csub(x2, x3); x2 = cadd(x2, x3); x3 = cmul(u, wa);
        } else {
          u = cmul(x1, wa); x1 = csub(x0, u); x0 = cadd(x0, u);
          u = cmul(x3, wa); x3 = csub(x2, u); x2 = cadd(x2, u);
          u = cmul(x2, wb); x2 = csub(x0, u); x0 = cadd(x0, u);
          u = cmul(x3, wc); x3 = csub(x1, u); x1 = cadd(x1, u);
        }
        p[0] = x0; p[d] = x1; p[2 * d] = x2; p[3 * d] = x3;
      }
      left -= 2;
      lh += dif ? -2 : 2;
    } else {
      const int h = 1 << lh;
      const int lg = t.log2n - 1;
      const int sa = t.log2n - 1 - lh;
      const int items = t.nb << (t.log2l + lg);
      for (int e = threadIdx.x; e < items; e += nt) {
        int c, l, b;
        item(t, e, lg, c, l, b);
        const int k = b & (h - 1);
        const int i0 = ((b - k) << 1) + k;
        Cx<T>* p = s + c * t.bs + l * t.ls + i0 * t.es;
        const int d = h * t.es;
        Cx<T> w = tw[k << sa];
        w.i *= sg;
        const Cx<T> a = p[0], v = p[d];
        if (dif) {
          p[0] = cadd(a, v);
          p[d] = cmul(csub(a, v), w);
        } else {
          const Cx<T> u = cmul(v, w);
          p[0] = cadd(a, u);
          p[d] = csub(a, u);
        }
      }
      left -= 1;
      lh += dif ? -1 : 1;
    }
    __syncthreads();
  }
}

// Direct DFTs of every line of the tile (any n), natural order in and out,
// through `tmp` (as many values as the tile).  Ends with a __syncthreads.
template <typename T>
__device__ void dft_direct(Cx<T>* s, Cx<T>* tmp, const Tile& t,
                           const Cx<T>* __restrict__ tw, bool inv) {
  const int n = t.n, lines = 1 << t.log2l, nt = blockDim.x;
  const int items = t.nb * lines * n;
  const T sg = inv ? T(-1) : T(1);
  auto at = [&](int e) {
    const int j = e % n, l = (e / n) % lines, c = e / (n * lines);
    return c * t.bs + l * t.ls + j * t.es;
  };
  for (int e = threadIdx.x; e < items; e += nt) tmp[e] = s[at(e)];
  __syncthreads();
  for (int e = threadIdx.x; e < items; e += nt) {
    const int k = e % n;
    const Cx<T>* x = tmp + (e - k);
    T ar = T(0), ai = T(0);
    int q = 0;
    for (int j = 0; j < n; ++j) {
      const Cx<T> w = tw[q];
      ar += x[j].r * w.r - sg * x[j].i * w.i;
      ai += sg * x[j].r * w.i + x[j].i * w.r;
      q += k;
      if (q >= n) q -= n;
    }
    s[at(e)] = {ar, ai};
  }
  __syncthreads();
}

// DFT of every line of the tile: dif selects the output order of a power of
// two (see fft_pow2); a direct DFT keeps natural order either way.
template <typename T>
__device__ void line_dft(Cx<T>* s, Cx<T>* tmp, const Tile& t,
                         const Cx<T>* __restrict__ tw, bool inv, bool dif) {
  if (t.log2n >= 0)
    fft_pow2(s, t, tw, inv, dif);
  else
    dft_direct(s, tmp, t, tw, inv);
}

template <typename T>
__device__ __forceinline__ Cx<T>* smem_base() {
  extern __shared__ __align__(16) unsigned char fg_smem[];
  return reinterpret_cast<Cx<T>*>(fg_smem);
}

// Row blockIdx.y of case blockIdx.z, in a pass whose grid has one y row per
// line set of a case (the y passes: a (component, x) row)
__device__ __forceinline__ int64_t row_of() {
  return static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
}

// ---------------------------------------------------------------------------
// The register-resident line FFT (power-of-two lengths 16..512).
//
// A line of n values is held by TT = n / V threads of V values each:
// thread t holds elements t + TT m (m = 0..V-1) in registers.  The
// transform runs Stockham stages of radix R = plan_radix(n, s), each
// dividing V, so a thread does V / R butterflies a stage.  Butterfly j =
// t + TT b of a stage whose earlier radices multiply to Ns takes the
// elements j + r n / R (registers b + r V / R), multiplies element r by
// W_{Ns R}^{r k} with k = j mod Ns, runs an R-point DFT in registers and
// hands output r to element (j - k) R + k + r Ns of the next stage, through
// shared memory.  The first stage's inputs are the thread's own elements,
// and the last stage leaves element t + TT m, in natural order, in the
// same register, so callers load from and store to device memory straight
// from registers.  n = 16 .. 256 take two stages and one exchange (256 =
// 16 x 16), n = 512 three (8 x 8 x 8).  The twiddles W_{Ns R}^{r k} come
// from a per-n table built in double on the host (spectral_kernels.
// plan_twiddles, which mirrors this plan), those inside the R-point DFTs
// are compile-time constants.
__host__ __device__ constexpr int plan_v(int n) {
  return n == 16 ? 4 : (n == 128 || n == 256) ? 16 : 8;
}
__host__ __device__ constexpr int plan_radix(int n, int s) {
  return s == 0 ? plan_v(n) : n == 512 ? 8 : n / plan_v(n);
}
__host__ __device__ constexpr int plan_stages(int n) {
  return n == 512 ? 3 : 2;
}
inline bool reg_route(int n) {
  return n >= 16 && n <= 512 && !(n & (n - 1));
}

// cos(pi i / 32) for 0 <= i <= 16, and for any i (period 64)
__host__ __device__ constexpr double cos_pi32(int i) {
  return i == 0 ? 1.0 : i == 1 ? 0.9951847266721969
       : i == 2 ? 0.9807852804032304 : i == 3 ? 0.9569403357322088
       : i == 4 ? 0.9238795325112867 : i == 5 ? 0.881921264348355
       : i == 6 ? 0.8314696123025452 : i == 7 ? 0.773010453362737
       : i == 8 ? 0.7071067811865476 : i == 9 ? 0.6343932841636455
       : i == 10 ? 0.5555702330196023 : i == 11 ? 0.4713967368259978
       : i == 12 ? 0.38268343236508984 : i == 13 ? 0.29028467725446233
       : i == 14 ? 0.19509032201612833 : i == 15 ? 0.09801714032956077
       : 0.0;
}
__host__ __device__ constexpr double cos64(int a) {
  return (a & 63) <= 16 ? cos_pi32(a & 63)
       : (a & 63) <= 32 ? -cos_pi32(32 - (a & 63))
       : (a & 63) <= 48 ? -cos_pi32((a & 63) - 32)
       : cos_pi32(64 - (a & 63));
}

// x W_m^k, W_m = exp(-2 pi i / m) (conjugated with INV), for m <= 64; k and
// m are constants once the caller's loops are unrolled
template <bool INV, typename T>
__device__ __forceinline__ Cx<T> rot(Cx<T> x, int k, int m) {
  if (k == 0) return x;
  if (4 * k == m) return INV ? Cx<T>{-x.i, x.r} : Cx<T>{x.i, -x.r};
  const int a = 64 * k / m;
  const T c = T(cos64(a)), s = INV ? T(cos64(a - 16)) : T(-cos64(a - 16));
  return {x.r * c - x.i * s, x.r * s + x.i * c};
}

template <int R>
__host__ __device__ constexpr int brev_c(int i) {
  int r = 0;
  for (int b = 1; b < R; b <<= 1) {
    r = (r << 1) | (i & 1);
    i >>= 1;
  }
  return r;
}

// Radix-2 decimation-in-frequency stages of half size H, H/2, .., 1 on the
// R registers u
template <int R, int H, bool INV, typename T>
struct Dif {
  static __device__ __forceinline__ void run(Cx<T> (&u)[R]) {
#pragma unroll
    for (int b = 0; b < R; b += 2 * H) {
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const Cx<T> a = u[b + k], c = u[b + k + H];
        u[b + k] = cadd(a, c);
        u[b + k + H] = rot<INV>(csub(a, c), k, 2 * H);
      }
    }
    Dif<R, H / 2, INV, T>::run(u);
  }
};
template <int R, bool INV, typename T>
struct Dif<R, 0, INV, T> {
  static __device__ __forceinline__ void run(Cx<T> (&)[R]) {}
};

// R-point DFT of the registers u, natural order in and out (the bit
// reversal of the decimation in frequency is a renaming of registers)
template <int R, bool INV, typename T>
__device__ __forceinline__ void dft_reg(Cx<T> (&u)[R]) {
  Dif<R, R / 2, INV, T>::run(u);
  Cx<T> w[R];
#pragma unroll
  for (int i = 0; i < R; ++i) w[i] = u[brev_c<R>(i)];
#pragma unroll
  for (int i = 0; i < R; ++i) u[i] = w[i];
}

// One Stockham stage (radix R, earlier radices' product NS) of the
// calling thread's butterflies; tw: this stage's W_{NS R}^{r k} at
// (r - 1) NS + k
template <int N, int R, int NS, bool INV, typename T>
__device__ __forceinline__ void stage(Cx<T> (&v)[plan_v(N)], int t,
                                      const Cx<T>* __restrict__ tw) {
  constexpr int V = plan_v(N), TT = N / V, NB = V / R;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int k = (t + TT * b) & (NS - 1);
    Cx<T> u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      u[r] = v[b + r * NB];
      if (NS > 1 && r > 0) {
        Cx<T> w = tw[(r - 1) * NS + k];
        if (INV) w.i = -w.i;
        u[r] = cmul(u[r], w);
      }
    }
    dft_reg<R, INV>(u);
#pragma unroll
    for (int r = 0; r < R; ++r) v[b + r * NB] = u[r];
  }
}

// The exchange after a stage of radix R and earlier product NS: output r
// of butterfly j goes to element (j - k) R + k + r NS; then each thread
// takes elements t + TT m back.  at(j) is the shared-memory slot of element
// j of the thread's line.
template <int N, int R, int NS, typename T, class At>
__device__ __forceinline__ void put(const Cx<T> (&v)[plan_v(N)], int t,
                                    At at) {
  constexpr int V = plan_v(N), TT = N / V, NB = V / R;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int j = t + TT * b, k = j & (NS - 1), d = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) at(d + r * NS) = v[b + r * NB];
  }
}
template <int N, typename T, class At>
__device__ __forceinline__ void get(Cx<T> (&v)[plan_v(N)], int t, At at) {
  constexpr int V = plan_v(N), TT = N / V;
#pragma unroll
  for (int m = 0; m < V; ++m) v[m] = at(t + TT * m);
}

// The register FFT of every line of a block, in place in v (element t + TT
// m in v[m], natural order in and out).  Every thread of the block calls
// it: each exchange begins with a barrier, so the caller's earlier use of
// the slots at() names must be over by then, and ends with one.
template <int N, bool INV, typename T, class At>
__device__ __forceinline__ void line_fft(Cx<T> (&v)[plan_v(N)], int t,
                                         const Cx<T>* __restrict__ tw,
                                         At at) {
  constexpr int R0 = plan_radix(N, 0), R1 = plan_radix(N, 1);
  stage<N, R0, 1, INV>(v, t, tw);
  __syncthreads();
  put<N, R0, 1>(v, t, at);
  __syncthreads();
  get<N>(v, t, at);
  stage<N, R1, R0, INV>(v, t, tw);
  if constexpr (plan_stages(N) == 3) {
    constexpr int R2 = plan_radix(N, 2);
    __syncthreads();
    put<N, R1, R0>(v, t, at);
    __syncthreads();
    get<N>(v, t, at);
    stage<N, R2, R0 * R1, INV>(v, t, tw + (R1 - 1) * R0);
  }
}

// Slot of element p of a tile in shared memory: one slot of padding after
// every 128 bytes, so that the exchanges' power-of-two strides spread over
// the banks.
template <typename T>
__host__ __device__ constexpr int pad_shift() {
  return sizeof(T) == 4 ? 4 : 3;
}
template <typename T>
__device__ __forceinline__ int pad(int p) {
  return p + (p >> pad_shift<T>());
}
template <typename T>
size_t padded_bytes(size_t elems) {
  return (elems + (elems >> pad_shift<T>())) * sizeof(Cx<T>);
}

// The real lines of the z passes: B cases of n lines of length nz each,
// line l of case b at b * rcs + l * nz of the real field (rcs, the case
// stride, may exceed n * nz: K6 reads components 1..5 of a 6-component
// batch) and at spectrum line b * n + l (the spectrum is contiguous).  A
// complex transform carries lines 2m and 2m + 1 of one case, so that a
// case's lines pair as in a single chain (the rounding of a packed
// transform depends on both of its lines): complex line G of the batch is
// pair m = G - b * cpc of case b = G / cpc, cpc = (n + 1) / 2 a case.
struct ZLines {
  int64_t n, cpc, total, rcs;
  int nz;
  // real line 2m + h of complex line G: its offset into the real field and
  // its spectrum line; false where there is none (past the batch, or the
  // odd line of a case's last pair)
  __device__ __forceinline__ bool at(int64_t G, int h, int64_t& r,
                                     int64_t& sl) const {
    if (G >= total) return false;
    const int64_t b = cpc == total ? 0 : G / cpc;
    const int64_t l = 2 * (G - b * cpc) + h;
    if (l >= n) return false;
    r = b * rcs + l * nz;
    sl = b * n + l;
    return true;
  }
};

ZLines z_lines(int64_t n, int B, int64_t rcs, int nz) {
  const int64_t cpc = (n + 1) / 2;
  return {n, cpc, cpc * B, rcs, nz};
}

// Real lines of length nz -> bins 0..nzh-1 of their DFT (spectrum line sl
// at spec + sl * nzh).  Block: 2^log2P complex lines, each holding real
// lines 2m (real part) and 2m+1 (imaginary part) of one case.
template <typename T>
__global__ void z_fwd(const T* __restrict__ f, Cx<T>* __restrict__ spec,
                      const Cx<T>* __restrict__ tw, int nz, int log2nz,
                      int nzh, ZLines zl, int log2P) {
  const int P = 1 << log2P;
  Cx<T>* s = smem_base<T>();
  const int64_t G0 = static_cast<int64_t>(blockIdx.x) * P;
  for (int e = threadIdx.x; e < P * nz; e += blockDim.x) {
    const int m = e / nz, j = e - m * nz;
    int64_t ra, rb, sl;
    const bool a = zl.at(G0 + m, 0, ra, sl), b = zl.at(G0 + m, 1, rb, sl);
    s[e] = {a ? f[ra + j] : T(0), b ? f[rb + j] : T(0)};
  }
  __syncthreads();
  const Tile t{nz, log2nz, log2P, 1, 1, nz, 0};
  line_dft(s, s + P * nz, t, tw, false, true);
  for (int e = threadIdx.x; e < P * nzh; e += blockDim.x) {
    const int m = e / nzh, k = e - m * nzh;
    const Cx<T> z = s[m * nz + rev(k, log2nz)];
    const Cx<T> zc = s[m * nz + rev(k ? nz - k : 0, log2nz)];
    // A = (Z[k] + conj Z[n-k]) / 2,  B = (Z[k] - conj Z[n-k]) / 2i
    int64_t r, sl;
    if (zl.at(G0 + m, 0, r, sl))
      spec[sl * nzh + k] = {T(0.5) * (z.r + zc.r), T(0.5) * (z.i - zc.i)};
    if (zl.at(G0 + m, 1, r, sl))
      spec[sl * nzh + k] = {T(0.5) * (z.i + zc.i), T(0.5) * (zc.r - z.r)};
  }
}

// Bin j of the full spectrum of spectrum line sl (none: sl < 0) from its
// half (bin nz-j = conj(bin j)); the imaginary parts of the DC and Nyquist
// bins are dropped, as a c2r transform drops them.
template <typename T>
__device__ __forceinline__ Cx<T> full_bin(const Cx<T>* __restrict__ spec,
                                          int64_t sl, int j, int nz,
                                          int nzh) {
  if (sl < 0) return {T(0), T(0)};
  Cx<T> v;
  if (j < nzh) {
    v = spec[sl * nzh + j];
  } else {
    v = spec[sl * nzh + (nz - j)];
    v.i = -v.i;
  }
  if (j == 0 || 2 * j == nz) v.i = T(0);
  return v;
}

// Spectrum line of real line 2m + h of complex line G, -1 where none
__device__ __forceinline__ int64_t spec_line(const ZLines& zl, int64_t G,
                                             int h) {
  int64_t r, sl;
  return zl.at(G, h, r, sl) ? sl : -1;
}

// Inverse of z_fwd: the complex line m carries A + i B of real lines 2m
// and 2m+1, whose inverse DFT has them as its real and imaginary parts.
template <typename T>
__global__ void z_inv(const Cx<T>* __restrict__ spec, T* __restrict__ out,
                      const Cx<T>* __restrict__ tw, int nz, int log2nz,
                      int nzh, ZLines zl, int log2P) {
  const int P = 1 << log2P;
  Cx<T>* s = smem_base<T>();
  const int64_t G0 = static_cast<int64_t>(blockIdx.x) * P;
  for (int e = threadIdx.x; e < P * nz; e += blockDim.x) {
    const int m = e / nz, j = e - m * nz;
    const Cx<T> a = full_bin(spec, spec_line(zl, G0 + m, 0), j, nz, nzh);
    const Cx<T> b = full_bin(spec, spec_line(zl, G0 + m, 1), j, nz, nzh);
    s[e] = {a.r - b.i, a.i + b.r};
  }
  __syncthreads();
  const Tile t{nz, log2nz, log2P, 1, 1, nz, 0};
  line_dft(s, s + P * nz, t, tw, true, true);
  for (int e = threadIdx.x; e < P * nz; e += blockDim.x) {
    const int m = e / nz, j = e - m * nz;
    const Cx<T> v = s[m * nz + rev(j, log2nz)];
    int64_t r, sl;
    if (zl.at(G0 + m, 0, r, sl)) out[r + j] = v.r;
    if (zl.at(G0 + m, 1, r, sl)) out[r + j] = v.i;
  }
}

// c2c along y in place: block (kz tile, c * nx + x, case) transforms
// ny-long lines of 2^log2TK consecutive kz bins of rows nzl long (the whole
// half-spectrum, or a kz-slab's columns); tile layout s[j * TK + t].
template <typename T>
__global__ void y_line(Cx<T>* __restrict__ spec, const Cx<T>* __restrict__ tw,
                       int ny, int log2ny, int nzl, int log2TK, bool inv) {
  const int TK = 1 << log2TK;
  Cx<T>* s = smem_base<T>();
  const int kz0 = blockIdx.x * TK;
  Cx<T>* base = spec + row_of() * ny * nzl + kz0;
  for (int e = threadIdx.x; e < ny * TK; e += blockDim.x) {
    const int j = e >> log2TK, q = e & (TK - 1);
    s[e] = kz0 + q < nzl ? base[static_cast<int64_t>(j) * nzl + q]
                         : Cx<T>{T(0), T(0)};
  }
  __syncthreads();
  const Tile t{ny, log2ny, log2TK, 1, TK, 1, 0};
  line_dft(s, s + ny * TK, t, tw, inv, true);
  for (int e = threadIdx.x; e < ny * TK; e += blockDim.x) {
    const int j = e >> log2TK, q = e & (TK - 1);
    if (kz0 + q < nzl)
      base[static_cast<int64_t>(j) * nzl + q] = s[(rev(j, log2ny) << log2TK) + q];
  }
}

// Staggered tables: per axis, rows (Re k+, Im k+, |k+|^2) of n_a bins (the
// z rows nzh = nz/2 + 1 long whatever the columns a block holds; k is the
// global kz bin).
template <typename T>
struct StaggeredK {
  const T *tx, *ty, *tz;
  int nx, ny, nzh;
  struct Row {
    T kr, ki, k2;
    bool dc;
  };
  __device__ __forceinline__ Row row(int y) const {
    return {ty[y], ty[ny + y], ty[2 * ny + y], y == 0};
  }
  // the same for every case of a batch
  __device__ __forceinline__ Row row(int y, int) const { return row(y); }
  // k+ and |k+|^2 at bin (i, row, k); false at the DC bin
  __device__ __forceinline__ bool at(const Row& r, int i, int k, T (&kr)[3],
                                     T (&ki)[3], T& n2) const {
    if (r.dc && i == 0 && k == 0) return false;
    kr[0] = tx[i]; kr[1] = r.kr; kr[2] = tz[k];
    ki[0] = tx[nx + i]; ki[1] = r.ki; ki[2] = tz[nzh + k];
    n2 = tx[2 * nx + i] + r.k2 + tz[2 * nzh + k];
    return true;
  }
};

// The elasticity G0 (K3) on one bin of a 3-component tile; v[c * bs] is
// component c.
template <typename T>
struct G0Vector {
  static constexpr int C = 3;
  using Row = typename StaggeredK<T>::Row;
  StaggeredK<T> tab;
  T c10, c20;
  __device__ __forceinline__ Row row(int y, int) const { return tab.row(y); }
  __device__ __forceinline__ void operator()(Cx<T>* v, int bs, const Row& r,
                                             int i, int k) const {
    T kr[3], ki[3], n2;
    if (!tab.at(r, i, k, kr, ki, n2)) {
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c * bs] = Cx<T>{T(0), T(0)};
      return;
    }
    const T c1 = c10 / n2, c2 = c20 / (n2 * n2);
    T re[3], im[3], fr = T(0), fi = T(0);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      re[c] = v[c * bs].r;
      im[c] = v[c * bs].i;
      fr += re[c] * kr[c] - im[c] * ki[c];
      fi += re[c] * ki[c] + im[c] * kr[c];
    }
    const T cfr = c2 * fr, cfi = c2 * fi;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      v[c * bs] = {c1 * re[c] - (cfr * kr[c] + cfi * ki[c]),
                   c1 * im[c] - (cfi * kr[c] - cfr * ki[c])};
  }
};

// The scalar G0 (K4) on one bin of a 1-component tile.
template <typename T>
struct G0Scalar {
  static constexpr int C = 1;
  using Row = typename StaggeredK<T>::Row;
  StaggeredK<T> tab;
  T c10;
  __device__ __forceinline__ Row row(int y, int) const { return tab.row(y); }
  __device__ __forceinline__ void operator()(Cx<T>* v, int, const Row& r,
                                             int i, int k) const {
    T kr[3], ki[3], n2;
    if (!tab.at(r, i, k, kr, ki, n2)) {
      v[0] = Cx<T>{T(0), T(0)};
      return;
    }
    const T c1 = c10 / n2;
    v[0] = {c1 * v[0].r, c1 * v[0].i};
  }
};

// The collocated Gamma of a symmetric tensor (Voigt order xx yy zz yz xz
// xy) with real coefficients, on one spectrum part p -> q; a = A/|xi|^2,
// b = B/|xi|^4.
template <typename T>
__device__ __forceinline__ void gamma6(const T (&p)[6], T x0, T x1, T x2,
                                       T a, T b, T (&q)[6]) {
  const T t0 = p[0] * x0 + p[5] * x1 + p[4] * x2;
  const T t1 = p[5] * x0 + p[1] * x1 + p[3] * x2;
  const T t2 = p[4] * x0 + p[3] * x1 + p[2] * x2;
  const T s = b * (x0 * t0 + x1 * t1 + x2 * t2);
  q[0] = a * (T(2) * x0 * t0) + s * (x0 * x0);
  q[1] = a * (T(2) * x1 * t1) + s * (x1 * x1);
  q[2] = a * (T(2) * x2 * t2) + s * (x2 * x2);
  q[3] = a * (x1 * t2 + x2 * t1) + s * (x1 * x2);
  q[4] = a * (x0 * t2 + x2 * t0) + s * (x0 * x2);
  q[5] = a * (x0 * t1 + x1 * t0) + s * (x0 * x1);
}

// The collocated Gamma (K5, NC = 6 or 3) and its zero-trace form (K6,
// NC = 5: components 1..5 of a traceless tensor) on one bin of an
// NC-component tile: eta = Gamma tau + beta tau, DC bin = E.  Tables: real
// xi per axis.
template <typename T, int NC>
struct GammaCollocated {
  static constexpr int C = NC;
  static constexpr int ES = NC == 5 ? 6 : NC;   // E values a case
  const T *tx, *ty, *tz;
  const T* E;          // device (B, ES) values: case b's DC bin at E + b ES
  T A, B, beta;        // 1/N folded in
  struct Row {
    T x1;
    bool dc;
    const T* e;        // this case's E
  };
  __device__ __forceinline__ Row row(int y, int b) const {
    return {ty[y], y == 0, E + b * ES};
  }
  __device__ __forceinline__ void part(const T (&p)[NC], T x0, T x1, T x2,
                                       T k2, T (&q)[NC]) const {
    const T a = A / k2;
    if constexpr (NC == 3) {
      const T c = a * (p[0] * x0 + p[1] * x1 + p[2] * x2);
      q[0] = c * x0 + beta * p[0];
      q[1] = c * x1 + beta * p[1];
      q[2] = c * x2 + beta * p[2];
    } else {
      constexpr int o = 6 - NC;    // 1: component 0 is rebuilt
      T p6[6], q6[6];
      if constexpr (o == 1) p6[0] = -(p[0] + p[1]);
#pragma unroll
      for (int c = 0; c < NC; ++c) p6[c + o] = p[c];
      gamma6(p6, x0, x1, x2, a, B / (k2 * k2), q6);
#pragma unroll
      for (int c = 0; c < NC; ++c) q[c] = q6[c + o] + beta * p[c];
    }
  }
  __device__ __forceinline__ void operator()(Cx<T>* v, int bs, const Row& r,
                                             int i, int k) const {
    if (r.dc && i == 0 && k == 0) {
      constexpr int eo = NC == 5 ? 1 : 0;   // K6: E holds component 0 too
#pragma unroll
      for (int c = 0; c < NC; ++c) v[c * bs] = Cx<T>{r.e[c + eo], T(0)};
      return;
    }
    const T x0 = tx[i], x1 = r.x1, x2 = tz[k];
    const T k2 = x0 * x0 + x1 * x1 + x2 * x2;
    T pr[NC], pi[NC], qr[NC], qi[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      pr[c] = v[c * bs].r;
      pi[c] = v[c * bs].i;
    }
    part(pr, x0, x1, x2, k2, qr);
    part(pi, x0, x1, x2, k2, qi);
#pragma unroll
    for (int c = 0; c < NC; ++c) v[c * bs] = Cx<T>{qr[c], qi[c]};
  }
};

// The finite-strain collocated Gamma (K5 at C = 9) on one bin of a
// 9-component tile: eta = Gamma tau + beta tau, DC bin = E (9 values).  The
// real and the imaginary parts go through the part one after the other,
// each written back before the next is read, so nine values of a part are
// in flight at a time.
template <typename T>
struct GammaCollocatedHyper {
  static constexpr int C = 9;
  const T *tx, *ty, *tz;
  const T* E;          // device (B, 9) values: case b's DC bin at E + 9 b
  T A, B, beta;        // 1/N folded in
  struct Row {
    T x1;
    bool dc;
    const T* e;        // this case's E
  };
  __device__ __forceinline__ Row row(int y, int b) const {
    return {ty[y], y == 0, E + 9 * b};
  }
  __device__ __forceinline__ void part(const T (&p)[9], T x0, T x1, T x2, T a,
                                       T b4, T (&q)[9]) const {
    // rows of tau: (xx, xy, xz), (yx, yy, yz), (zx, zy, zz)
    const T t0 = p[0] * x0 + p[5] * x1 + p[4] * x2;
    const T t1 = p[8] * x0 + p[1] * x1 + p[3] * x2;
    const T t2 = p[7] * x0 + p[6] * x1 + p[2] * x2;
    const T b = b4 * (x0 * t0 + x1 * t1 + x2 * t2);
    q[0] = a * x0 * t0 + b * x0 * x0 + beta * p[0];
    q[1] = a * x1 * t1 + b * x1 * x1 + beta * p[1];
    q[2] = a * x2 * t2 + b * x2 * x2 + beta * p[2];
    q[3] = a * x2 * t1 + b * x1 * x2 + beta * p[3];
    q[4] = a * x2 * t0 + b * x0 * x2 + beta * p[4];
    q[5] = a * x1 * t0 + b * x0 * x1 + beta * p[5];
    q[6] = a * x1 * t2 + b * x2 * x1 + beta * p[6];
    q[7] = a * x0 * t2 + b * x2 * x0 + beta * p[7];
    q[8] = a * x0 * t1 + b * x1 * x0 + beta * p[8];
  }
  __device__ __forceinline__ void operator()(Cx<T>* v, int bs, const Row& r,
                                             int i, int k) const {
    if (r.dc && i == 0 && k == 0) {
#pragma unroll
      for (int c = 0; c < 9; ++c) v[c * bs] = Cx<T>{r.e[c], T(0)};
      return;
    }
    const T x0 = tx[i], x1 = r.x1, x2 = tz[k];
    const T k2 = x0 * x0 + x1 * x1 + x2 * x2;
    const T a = A / k2, b4 = B / (k2 * k2);
    T p[9], q[9];
#pragma unroll
    for (int c = 0; c < 9; ++c) p[c] = v[c * bs].r;
    part(p, x0, x1, x2, a, b4, q);
#pragma unroll
    for (int c = 0; c < 9; ++c) v[c * bs].r = q[c];
#pragma unroll
    for (int c = 0; c < 9; ++c) p[c] = v[c * bs].i;
    part(p, x0, x1, x2, a, b4, q);
#pragma unroll
    for (int c = 0; c < 9; ++c) v[c * bs].i = q[c];
  }
};

template <typename T>
using Gamma6 = GammaCollocated<T, 6>;
template <typename T>
using Gamma3 = GammaCollocated<T, 3>;
template <typename T>
using GammaZt = GammaCollocated<T, 5>;

// Forward x transform, apply, inverse x transform, in place: block
// (kz tile, y, case) holds all C components of its case, tile layout
// s[c * nx * TK + i * TK + t].  The forward pass leaves the x bins in
// bit-reversed order and the inverse pass takes them so.  Rows are nzl
// long; column q of the rows is the global kz bin koff + q, which the apply
// reads its z tables and tests the DC bin by.
template <typename T, class A>
__global__ void x_apply(Cx<T>* __restrict__ spec, const Cx<T>* __restrict__ tw,
                        A apply, int nx, int log2nx, int ny, int nzl,
                        int koff, int log2TK) {
  constexpr int C = A::C;
  const int TK = 1 << log2TK;
  const int bs = nx * TK;
  Cx<T>* s = smem_base<T>();
  const int kz0 = blockIdx.x * TK, y = blockIdx.y, b = blockIdx.z;
  const int64_t sc = static_cast<int64_t>(nx) * ny * nzl;  // component
  const int64_t sx = static_cast<int64_t>(ny) * nzl;       // x
  Cx<T>* base = spec + b * C * sc + static_cast<int64_t>(y) * nzl + kz0;
  for (int e = threadIdx.x; e < C * bs; e += blockDim.x) {
    const int c = e / bs, i = (e - c * bs) >> log2TK, q = e & (TK - 1);
    s[e] = kz0 + q < nzl ? base[c * sc + i * sx + q] : Cx<T>{T(0), T(0)};
  }
  __syncthreads();
  const Tile t{nx, log2nx, log2TK, C, TK, 1, bs};
  line_dft(s, s + C * bs, t, tw, false, true);
  const typename A::Row row = apply.row(y, b);
  for (int e = threadIdx.x; e < bs; e += blockDim.x) {
    const int p = e >> log2TK, q = e & (TK - 1);
    if (kz0 + q < nzl) apply(s + e, bs, row, rev(p, log2nx), koff + kz0 + q);
  }
  __syncthreads();
  line_dft(s, s + C * bs, t, tw, true, false);
  for (int e = threadIdx.x; e < C * bs; e += blockDim.x) {
    const int c = e / bs, i = (e - c * bs) >> log2TK, q = e & (TK - 1);
    if (kz0 + q < nzl) base[c * sc + i * sx + q] = s[e];
  }
}

// The register-FFT passes (line length N with reg_route(N)).  Threads that
// hold no live data (past the last column or line) still take part in the
// barriers and store nothing.

// z_fwd with the register FFT: block of P = 256 / TT complex lines, each
// holding real lines 2m and 2m+1 of one case (ZLines); thread (m, t) =
// m TT + t, so a warp's loads run along z.  The Hermitian split reads bins
// k and N - k of a line from the exchange's own slots.
template <typename T, int N>
__global__ void __launch_bounds__(256)
    z_fwd_reg(const T* __restrict__ f, Cx<T>* __restrict__ spec,
              const Cx<T>* __restrict__ tw, ZLines zl) {
  constexpr int V = plan_v(N), TT = N / V, P = 256 / TT, NZH = N / 2 + 1;
  const int t = threadIdx.x & (TT - 1), m = threadIdx.x / TT;
  const int64_t G0 = static_cast<int64_t>(blockIdx.x) * P;
  Cx<T>* s = smem_base<T>();
  int64_t ra, rb, sl;
  const bool a = zl.at(G0 + m, 0, ra, sl), b = zl.at(G0 + m, 1, rb, sl);
  Cx<T> v[V];
#pragma unroll
  for (int r = 0; r < V; ++r) {
    const int j = t + TT * r;
    v[r] = {a ? f[ra + j] : T(0), b ? f[rb + j] : T(0)};
  }
  auto at = [&](int j) -> Cx<T>& { return s[pad<T>(m * N + j)]; };
  line_fft<N, false>(v, t, tw, at);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < V; ++r) at(t + TT * r) = v[r];
  __syncthreads();
  for (int e = threadIdx.x; e < P * NZH; e += blockDim.x) {
    const int mm = e / NZH, k = e - mm * NZH;
    const Cx<T> z = s[pad<T>(mm * N + k)];
    const Cx<T> zc = s[pad<T>(mm * N + (k ? N - k : 0))];
    // A = (Z[k] + conj Z[n-k]) / 2,  B = (Z[k] - conj Z[n-k]) / 2i
    int64_t r, l;
    if (zl.at(G0 + mm, 0, r, l))
      spec[l * NZH + k] = {T(0.5) * (z.r + zc.r), T(0.5) * (z.i - zc.i)};
    if (zl.at(G0 + mm, 1, r, l))
      spec[l * NZH + k] = {T(0.5) * (z.i + zc.i), T(0.5) * (zc.r - z.r)};
  }
}

// z_inv with the register FFT: the packed line A + i B is read straight
// from the half-spectrum (Hermitian completion) into registers.
template <typename T, int N>
__global__ void __launch_bounds__(256)
    z_inv_reg(const Cx<T>* __restrict__ spec, T* __restrict__ out,
              const Cx<T>* __restrict__ tw, ZLines zl) {
  constexpr int V = plan_v(N), TT = N / V, NZH = N / 2 + 1;
  const int t = threadIdx.x & (TT - 1), m = threadIdx.x / TT;
  const int64_t G = static_cast<int64_t>(blockIdx.x) * (256 / TT) + m;
  Cx<T>* s = smem_base<T>();
  int64_t ra = 0, rb = 0, la = -1, lb = -1;
  const bool a = zl.at(G, 0, ra, la), b = zl.at(G, 1, rb, lb);
  Cx<T> v[V];
#pragma unroll
  for (int r = 0; r < V; ++r) {
    const int j = t + TT * r;
    const Cx<T> x = full_bin(spec, a ? la : -1, j, N, NZH);
    const Cx<T> y = full_bin(spec, b ? lb : -1, j, N, NZH);
    v[r] = {x.r - y.i, x.i + y.r};
  }
  line_fft<N, true>(v, t, tw,
                    [&](int j) -> Cx<T>& { return s[pad<T>(m * N + j)]; });
#pragma unroll
  for (int r = 0; r < V; ++r) {
    const int j = t + TT * r;
    if (a) out[ra + j] = v[r].r;
    if (b) out[rb + j] = v[r].i;
  }
}

// y_line with the register FFT (ny = N): block (kz tile, c * nx + x, case) holds
// TK consecutive kz columns of one row, TT threads a column; thread (t, q)
// = t TK + q, so a warp's loads run along kz.
template <typename T, int N, bool INV>
__global__ void __launch_bounds__(256)
    y_line_reg(Cx<T>* __restrict__ spec, const Cx<T>* __restrict__ tw,
               int nzl, int log2TK) {
  constexpr int V = plan_v(N), TT = N / V;
  const int TK = 1 << log2TK;
  const int q = threadIdx.x & (TK - 1), t = threadIdx.x >> log2TK;
  const int kz0 = blockIdx.x * TK;
  const bool live = kz0 + q < nzl;
  Cx<T>* g = spec + row_of() * N * nzl + kz0 + q;
  Cx<T>* s = smem_base<T>();
  Cx<T> v[V];
#pragma unroll
  for (int m = 0; m < V; ++m)
    v[m] = live ? g[static_cast<int64_t>(t + TT * m) * nzl]
                : Cx<T>{T(0), T(0)};
  line_fft<N, INV>(v, t, tw, [&](int j) -> Cx<T>& {
    return s[pad<T>((j << log2TK) + q)];
  });
  if (live) {
#pragma unroll
    for (int m = 0; m < V; ++m)
      g[static_cast<int64_t>(t + TT * m) * nzl] = v[m];
  }
}

// log2 of the kz columns of an x_apply_reg tile: a 128-byte row segment
// (16 float32, 8 float64 complex values), fewer where the C TT threads a
// column would pass 1024 threads.  Wide segments matter here: the rows of
// an x line lie ny * nzl values apart, and 32-byte segments took the pass
// from 0.43 to 0.58 ms at C = 5 (PERF.md).
template <typename T>
__host__ __device__ constexpr int x_log2tk_max(int threads_per_col) {
  int l = sizeof(T) == 4 ? 4 : 3;
  while (l > 0 && (threads_per_col << l) > 1024) --l;
  return l;
}
template <typename T, int C, int N>
__host__ __device__ constexpr int x_threads_max() {
  return (C * (N / plan_v(N))) << x_log2tk_max<T>(C * (N / plan_v(N)));
}

// x_apply with the register FFT (nx = N): block (kz tile, y, case) holds TK
// consecutive kz columns of all C components, TT threads a column and
// component; thread (c, t, q) = (c TT + t) TK + q.  Each thread transforms
// its own component's line in registers (the exchanges through the
// component's slots of the tile), the spectra meet in shared memory for
// the apply (natural x order), and each thread takes its line back for the
// inverse transform and stores it.
template <typename T, class A, int N>
__global__ void __launch_bounds__(x_threads_max<T, A::C, N>())
    x_apply_reg(Cx<T>* __restrict__ spec, const Cx<T>* __restrict__ tw,
                A apply, int ny, int nzl, int koff, int log2TK) {
  constexpr int V = plan_v(N), TT = N / V;
  const int TK = 1 << log2TK;
  const int q = threadIdx.x & (TK - 1), ct = threadIdx.x >> log2TK;
  const int c = ct / TT, t = ct & (TT - 1);
  const int kz0 = blockIdx.x * TK, y = blockIdx.y, b = blockIdx.z;
  const bool live = kz0 + q < nzl;
  const int64_t sx = static_cast<int64_t>(ny) * nzl;
  Cx<T>* g = spec + (b * A::C + c) * (N * sx) +
             static_cast<int64_t>(y) * nzl + kz0 + q;
  Cx<T>* s = smem_base<T>();
  Cx<T> v[V];
#pragma unroll
  for (int m = 0; m < V; ++m)
    v[m] = live ? g[(t + TT * m) * sx] : Cx<T>{T(0), T(0)};
  const int lo = c * N;
  auto at = [&](int j) -> Cx<T>& {
    return s[pad<T>(((lo + j) << log2TK) + q)];
  };
  line_fft<N, false>(v, t, tw, at);
  __syncthreads();
#pragma unroll
  for (int m = 0; m < V; ++m) at(t + TT * m) = v[m];
  __syncthreads();
  const int bins = N << log2TK;
  const int bs = pad<T>(bins);      // a component's padded stride
  const typename A::Row row = apply.row(y, b);
  for (int e = threadIdx.x; e < bins; e += blockDim.x) {
    const int i = e >> log2TK, qq = e & (TK - 1);
    if (kz0 + qq < nzl) apply(s + pad<T>(e), bs, row, i, koff + kz0 + qq);
  }
  __syncthreads();
  get<N>(v, t, at);
  line_fft<N, true>(v, t, tw, at);
  if (live) {
#pragma unroll
    for (int m = 0; m < V; ++m) g[(t + TT * m) * sx] = v[m];
  }
}

constexpr int kThreads = 256;
constexpr size_t kTileBytes = 96 * 1024;   // preferred shared memory per block
constexpr size_t kMaxBytes = 227 * 1024;   // Hopper's opt-in limit

int log2_or_neg(int n) {
  if (n <= 0 || (n & (n - 1))) return -1;
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

// log2 of the largest power of two t <= want with t * unit <= kTileBytes
// (at least 1), no larger than needed to cover `cover` columns.
int pick_log2(size_t unit, int want, int cover) {
  int l = 0;
  while ((2 << l) <= want) ++l;
  while (l > 0 && (1 << (l - 1)) >= cover) --l;
  while (l > 0 && (size_t(1) << l) * unit > kTileBytes) --l;
  return l;
}

// Lets `kernel` take `bytes` of dynamic shared memory; up to the default
// 48 KiB there is nothing to set (no runtime call on the launch path).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > kMaxBytes) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// `return CALL;` with the constant N = n, for a length n with reg_route(n)
#define FG_WITH_N(n, CALL)                                                   \
  switch (n) {                                                               \
    case 16: { constexpr int N = 16; return CALL; }                          \
    case 32: { constexpr int N = 32; return CALL; }                          \
    case 64: { constexpr int N = 64; return CALL; }                          \
    case 128: { constexpr int N = 128; return CALL; }                        \
    case 256: { constexpr int N = 256; return CALL; }                        \
    case 512: { constexpr int N = 512; return CALL; }                        \
  }                                                                          \
  return static_cast<int>(cudaErrorInvalidValue)

// log2 of a tile's kz columns: at most lmax, no more than needed to cover
// nzl columns
int cover_log2(int lmax, int nzl) {
  int l = lmax;
  while (l > 0 && (1 << (l - 1)) >= nzl) --l;
  return l;
}

template <typename T, int N>
int launch_z_reg(const void* in, void* out, const void* twz, const ZLines& zl,
                 bool inv, cudaStream_t st) {
  using Cp = Cx<T>;
  constexpr int P = 256 / (N / plan_v(N));     // complex lines per block
  const unsigned blocks = static_cast<unsigned>((zl.total + P - 1) / P);
  const size_t bytes = padded_bytes<T>(size_t(P) * N);
  cudaError_t err;
  if (inv) {
    if ((err = allow_smem(z_inv_reg<T, N>, bytes))) return int(err);
    z_inv_reg<T, N><<<blocks, 256, bytes, st>>>(
        static_cast<const Cp*>(in), static_cast<T*>(out),
        static_cast<const Cp*>(twz), zl);
  } else {
    if ((err = allow_smem(z_fwd_reg<T, N>, bytes))) return int(err);
    z_fwd_reg<T, N><<<blocks, 256, bytes, st>>>(
        static_cast<const T*>(in), static_cast<Cp*>(out),
        static_cast<const Cp*>(twz), zl);
  }
  return static_cast<int>(cudaGetLastError());
}

// The z pass on the real lines of zl (C * nx * ny a case of a field, or
// of an x-slab): forward (real in -> half-spectrum rows out) or inverse.
template <typename T>
int launch_z(const void* in, void* out, const void* twz, const ZLines& zl,
             bool inv, void* stream) {
  using Cp = Cx<T>;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nz = zl.nz;
  if (reg_route(nz)) {
    FG_WITH_N(nz, (launch_z_reg<T, N>(in, out, twz, zl, inv, st)));
  }
  const int nzh = nz / 2 + 1, lz = log2_or_neg(nz);
  // 2^lP complex lines (twice as many real lines) per block
  const size_t zunit = (lz >= 0 ? 1 : 2) * nz * sizeof(Cp);
  const int lP = pick_log2(zunit, nz >= 2048 ? 1 : 2048 / nz, 1 << 30);
  const unsigned zblocks =
      static_cast<unsigned>((zl.total + (1 << lP) - 1) >> lP);
  const size_t zb = zunit << lP;
  cudaError_t err;
  if (inv) {
    if ((err = allow_smem(z_inv<T>, zb))) return static_cast<int>(err);
    z_inv<T><<<zblocks, kThreads, zb, st>>>(
        static_cast<const Cp*>(in), static_cast<T*>(out),
        static_cast<const Cp*>(twz), nz, lz, nzh, zl, lP);
  } else {
    if ((err = allow_smem(z_fwd<T>, zb))) return static_cast<int>(err);
    z_fwd<T><<<zblocks, kThreads, zb, st>>>(
        static_cast<const T*>(in), static_cast<Cp*>(out),
        static_cast<const Cp*>(twz), nz, lz, nzh, zl, lP);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int launch_y_reg(Cx<T>* sp, const Cx<T>* tw, int rows, int B, int nzl,
                 bool inv, cudaStream_t st) {
  constexpr int TT = N / plan_v(N);
  int lmax = 0;                      // at most 256 threads a block
  while ((TT << (lmax + 1)) <= 256) ++lmax;
  const int l = cover_log2(lmax, nzl);
  const size_t bytes = padded_bytes<T>(size_t(N) << l);
  const dim3 grid((nzl + (1 << l) - 1) >> l, rows, B);
  cudaError_t err;
  if (inv) {
    if ((err = allow_smem(y_line_reg<T, N, true>, bytes))) return int(err);
    y_line_reg<T, N, true><<<grid, TT << l, bytes, st>>>(sp, tw, nzl, l);
  } else {
    if ((err = allow_smem(y_line_reg<T, N, false>, bytes))) return int(err);
    y_line_reg<T, N, false><<<grid, TT << l, bytes, st>>>(sp, tw, nzl, l);
  }
  return static_cast<int>(cudaGetLastError());
}

// c2c along y on every (c, x) row of each of the B cases of a (B, rows,
// ny, nzl) spectrum, in place
template <typename T>
int launch_y(Cx<T>* sp, const void* twy, int rows, int B, int ny, int nzl,
             bool inv, cudaStream_t st) {
  using Cp = Cx<T>;
  const Cp* tw = static_cast<const Cp*>(twy);
  if (reg_route(ny)) {
    FG_WITH_N(ny, (launch_y_reg<T, N>(sp, tw, rows, B, nzl, inv, st)));
  }
  const int ly = log2_or_neg(ny);
  const int want = sizeof(T) == 4 ? 16 : 8;
  const size_t yunit = (ly >= 0 ? 1 : 2) * ny * sizeof(Cp);
  const int lTy = pick_log2(yunit, want, nzl);
  const size_t yb = yunit << lTy;
  cudaError_t err;
  if ((err = allow_smem(y_line<T>, yb))) return static_cast<int>(err);
  const dim3 yg((nzl + (1 << lTy) - 1) >> lTy, rows, B);
  y_line<T><<<yg, kThreads, yb, st>>>(sp, tw, ny, ly, nzl, lTy, inv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, class A, int N>
int launch_x_reg(Cx<T>* sp, const Cx<T>* tw, const A& apply, int ny,
                 int nzl, int koff, int B, cudaStream_t st) {
  constexpr int C = A::C, TT = N / plan_v(N);
  int l = cover_log2(x_log2tk_max<T>(C * TT), nzl);
  while (l > 0 && padded_bytes<T>(size_t(C) * N << l) > kMaxBytes) --l;
  const size_t bytes = padded_bytes<T>(size_t(C) * N << l);
  const dim3 grid((nzl + (1 << l) - 1) >> l, ny, B);
  cudaError_t err;
  if ((err = allow_smem(x_apply_reg<T, A, N>, bytes))) return int(err);
  x_apply_reg<T, A, N><<<grid, (C * TT) << l, bytes, st>>>(
      sp, tw, apply, ny, nzl, koff, l);
  return static_cast<int>(cudaGetLastError());
}

// x forward, the apply, x inverse on each case of a (B, C, nx, ny, nzl)
// spectrum, in place
template <typename T, class A>
int launch_x(Cx<T>* sp, const void* twx, const A& apply, int nx, int ny,
             int nzl, int koff, int B, cudaStream_t st) {
  using Cp = Cx<T>;
  constexpr int C = A::C;
  const Cp* tw = static_cast<const Cp*>(twx);
  if (reg_route(nx)) {
    FG_WITH_N(nx, (launch_x_reg<T, A, N>(sp, tw, apply, ny, nzl, koff, B,
                                         st)));
  }
  const int lx = log2_or_neg(nx);
  const int want = sizeof(T) == 4 ? 16 : 8;
  const size_t xunit = (lx >= 0 ? 1 : 2) * C * nx * sizeof(Cp);
  const int lTx = pick_log2(xunit, want, nzl);
  const size_t xb = xunit << lTx;
  cudaError_t err;
  if ((err = allow_smem(x_apply<T, A>, xb))) return static_cast<int>(err);
  const dim3 xg((nzl + (1 << lTx) - 1) >> lTx, ny, B);
  x_apply<T, A><<<xg, kThreads, xb, st>>>(sp, tw, apply, nx, lx, ny, nzl,
                                          koff, lTx);
  return static_cast<int>(cudaGetLastError());
}

// The middle on a (B, C, nx, ny, nzl) spectrum whose column q is global kz
// bin koff + q: y forward, x forward + apply + x inverse, y inverse, in
// place.  The case is a grid axis of its own (blockIdx.z), so the y rows
// (C * nx, in blockIdx.y) stay within a case's.
template <typename T, class A>
int launch_middle(void* spec, const void* twx, const void* twy,
                  const A& apply, int nx, int ny, int nzl, int koff, int B,
                  void* stream) {
  if (nzl <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Cx<T>* sp = static_cast<Cx<T>*>(spec);
  int err = launch_y<T>(sp, twy, A::C * nx, B, ny, nzl, false, st);
  if (!err) err = launch_x<T, A>(sp, twx, apply, nx, ny, nzl, koff, B, st);
  if (!err) err = launch_y<T>(sp, twy, A::C * nx, B, ny, nzl, true, st);
  return err;
}

// The whole chain on one device for B right-hand sides: z forward, the
// middle on every kz bin, z inverse.  Case b of f and out starts at b * fcs
// and b * ocs (in elements; a case's C * nx * ny lines of length nz are
// contiguous); the spectrum is a contiguous (B, C, nx, ny, nz/2+1).  A
// single right-hand side is the call with B = 1.
template <typename T, class A>
int launch(const void* f, void* spec, void* out, const void* twx,
           const void* twy, const void* twz, const A& apply, int nx, int ny,
           int nz, int B, int64_t fcs, int64_t ocs, void* stream) {
  if (B < 1 || B > 65535 || nx > 65535 || ny > 65535 ||
      static_cast<int64_t>(A::C) * nx > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t lines = static_cast<int64_t>(A::C) * nx * ny;
  int err = launch_z<T>(f, spec, twz, z_lines(lines, B, fcs, nz), false,
                        stream);
  if (!err)
    err = launch_middle<T, A>(spec, twx, twy, apply, nx, ny, nz / 2 + 1, 0,
                              B, stream);
  if (!err)
    err = launch_z<T>(spec, out, twz, z_lines(lines, B, ocs, nz), true,
                      stream);
  return err;
}

// A single right-hand side: the batch of one
template <typename T, class A>
int launch1(const void* f, void* spec, void* out, const void* twx,
            const void* twy, const void* twz, const A& apply, int nx, int ny,
            int nz, void* stream) {
  const int64_t n = static_cast<int64_t>(A::C) * nx * ny * nz;
  return launch<T>(f, spec, out, twx, twy, twz, apply, nx, ny, nz, 1, n, n,
                   stream);
}

template <typename T>
StaggeredK<T> staggered_tables(const void* tx, const void* ty, const void* tz,
                               int nx, int ny, int nz) {
  return {static_cast<const T*>(tx), static_cast<const T*>(ty),
          static_cast<const T*>(tz), nx, ny, nz / 2 + 1};
}

// A collocated apply functor G (GammaCollocated or GammaCollocatedHyper)
// on the xi tables and E, with 1/N folded into A, B and beta.
template <class G, typename T>
G collocated(const void* tx, const void* ty, const void* tz, const void* E,
             double A, double B, double beta, double n) {
  return {static_cast<const T*>(tx), static_cast<const T*>(ty),
          static_cast<const T*>(tz), static_cast<const T*>(E), T(A / n),
          T(B / n), T(beta / n)};
}

}  // namespace

// The 1/N of norm="forward" is folded into the constants here; E is not
// scaled.  tx, ty, tz: the staggered tables (K3, K4) or the xi tables (K5,
// K6).  K6 reads components 1..5 of its input and writes components 1..5 of
// its output: f and out point at component 1.
//
// Each chain has a whole-field entry <chain>_<T> (one right-hand side on
// one device), a batched entry <chain>_batched_<T> for B right-hand sides
// in one launch of each pass (the JAX package's _middle under jax.vmap,
// whose batching rule adds B to the grid): case b of f and out at b * fcs
// and b * ocs elements (K6: a (B, 6, ...) batch's components 1..5, fcs =
// ocs = 6 nx ny nz), E (K5, K6) B rows of C values (6 for K6), spec a
// (B, C, nx, ny, nz/2+1) workspace; the single entry is its B = 1 call.
// For the sharded x-slab solve (the kz-slab chain, replacing
// pallas_chain._run_middle_slab), a middle entry <chain>_middle_<T> on a
// kz-slab (C, nx, ny, nzl) of global offset koff (nx, ny, nz the whole
// grid's), between chain_z_fwd_<T> / chain_z_inv_<T> on the x-slabs'
// nlines = C * nx/D * ny lines; the caller moves the spectrum between the
// two layouts.
#define FG_CHAIN_ARGS                                                        \
  const void *f, void *spec, void *out, const void *tx, const void *ty,      \
      const void *tz, const void *twx, const void *twy, const void *twz
#define FG_CHAIN_PASS f, spec, out, twx, twy, twz
#define FG_BATCH_ARGS                                                        \
  int nx, int ny, int nz, int B, long long fcs, long long ocs, void *stream
#define FG_BATCH_PASS nx, ny, nz, B, fcs, ocs, stream
#define FG_MIDDLE_ARGS                                                       \
  void *spec, const void *tx, const void *ty, const void *tz,                \
      const void *twx, const void *twy
#define FG_COLLOCATED_ENTRY(NAME, SUF, T, G)                                 \
  extern "C" int NAME##_##SUF(FG_CHAIN_ARGS, const void* E, double A,       \
                              double B, double beta, int nx, int ny,         \
                              int nz, void* stream) {                        \
    const double n = static_cast<double>(nx) * ny * nz;                      \
    return launch1<T>(FG_CHAIN_PASS,                                         \
                      collocated<G<T>, T>(tx, ty, tz, E, A, B, beta, n), nx, \
                      ny, nz, stream);                                       \
  }
#define FG_COLLOCATED_BATCHED(NAME, SUF, T, G)                               \
  extern "C" int NAME##_batched_##SUF(FG_CHAIN_ARGS, const void* E,         \
                                      double A, double Bc, double beta,      \
                                      FG_BATCH_ARGS) {                       \
    const double n = static_cast<double>(nx) * ny * nz;                      \
    return launch<T>(FG_CHAIN_PASS,                                          \
                     collocated<G<T>, T>(tx, ty, tz, E, A, Bc, beta, n),     \
                     FG_BATCH_PASS);                                         \
  }
#define FG_COLLOCATED_MIDDLE(NAME, SUF, T, G)                                \
  extern "C" int NAME##_middle_##SUF(FG_MIDDLE_ARGS, const void* E,         \
                                     double A, double B, double beta,        \
                                     int nx, int ny, int nz, int nzl,        \
                                     int koff, void* stream) {               \
    const double n = static_cast<double>(nx) * ny * nz;                      \
    return launch_middle<T>(                                                 \
        spec, twx, twy, collocated<G<T>, T>(tx, ty, tz, E, A, B, beta, n),   \
        nx, ny, nzl, koff, 1, stream);                                       \
  }

#define FG_G0_VECTOR(T)                                                      \
  G0Vector<T> {                                                              \
    staggered_tables<T>(tx, ty, tz, nx, ny, nz), T(c10 / n), T(c20 / n)      \
  }
#define FG_G0_SCALAR(T)                                                      \
  G0Scalar<T> { staggered_tables<T>(tx, ty, tz, nx, ny, nz), T(c10 / n) }

#define FG_CHAIN_ENTRIES(SUF, T)                                             \
  extern "C" int g0_staggered_chain_##SUF(FG_CHAIN_ARGS, double c10,        \
                                          double c20, int nx, int ny,        \
                                          int nz, void* stream) {            \
    const double n = static_cast<double>(nx) * ny * nz;                      \
    return launch1<T>(FG_CHAIN_PASS, FG_G0_VECTOR(T), nx, ny, nz, stream);   \
  }                                                                          \
  extern "C" int g0_staggered_chain_batched_##SUF(                          \
      FG_CHAIN_ARGS, double c10, double c20, FG_BATCH_ARGS) {                \
    const double n = static_cast<double>(nx) * ny * nz;                      \
    return launch<T>(FG_CHAIN_PASS, FG_G0_VECTOR(T), FG_BATCH_PASS);         \
  }                                                                          \
  extern "C" int g0_staggered_heat_chain_##SUF(FG_CHAIN_ARGS, double c10,   \
                                               int nx, int ny, int nz,       \
                                               void* stream) {               \
    const double n = static_cast<double>(nx) * ny * nz;                      \
    return launch1<T>(FG_CHAIN_PASS, FG_G0_SCALAR(T), nx, ny, nz, stream);   \
  }                                                                          \
  extern "C" int g0_staggered_heat_chain_batched_##SUF(                     \
      FG_CHAIN_ARGS, double c10, FG_BATCH_ARGS) {                            \
    const double n = static_cast<double>(nx) * ny * nz;                      \
    return launch<T>(FG_CHAIN_PASS, FG_G0_SCALAR(T), FG_BATCH_PASS);         \
  }                                                                          \
  extern "C" int g0_staggered_chain_middle_##SUF(                           \
      FG_MIDDLE_ARGS, double c10, double c20, int nx, int ny, int nz,        \
      int nzl, int koff, void* stream) {                                     \
    const double n = static_cast<double>(nx) * ny * nz;                      \
    return launch_middle<T>(spec, twx, twy, FG_G0_VECTOR(T), nx, ny, nzl,    \
                            koff, 1, stream);                                \
  }                                                                          \
  extern "C" int g0_staggered_heat_chain_middle_##SUF(                      \
      FG_MIDDLE_ARGS, double c10, int nx, int ny, int nz, int nzl, int koff, \
      void* stream) {                                                        \
    const double n = static_cast<double>(nx) * ny * nz;                      \
    return launch_middle<T>(spec, twx, twy, FG_G0_SCALAR(T), nx, ny, nzl,    \
                            koff, 1, stream);                                \
  }                                                                          \
  extern "C" int chain_z_fwd_##SUF(const void* f, void* spec,               \
                                   const void* twz, long long nlines, int nz,\
                                   void* stream) {                           \
    return launch_z<T>(f, spec, twz, z_lines(nlines, 1, nlines * nz, nz),    \
                       false, stream);                                       \
  }                                                                          \
  extern "C" int chain_z_inv_##SUF(const void* spec, void* out,             \
                                   const void* twz, long long nlines, int nz,\
                                   void* stream) {                           \
    return launch_z<T>(spec, out, twz, z_lines(nlines, 1, nlines * nz, nz),  \
                       true, stream);                                        \
  }                                                                          \
  FG_COLLOCATED_ENTRY(gamma_collocated_chain, SUF, T, Gamma6)                \
  FG_COLLOCATED_ENTRY(gamma_collocated_heat_chain, SUF, T, Gamma3)           \
  FG_COLLOCATED_ENTRY(gamma_collocated_zt_chain, SUF, T, GammaZt)            \
  FG_COLLOCATED_ENTRY(gamma_collocated_hyper_chain, SUF, T,                  \
                      GammaCollocatedHyper)                                  \
  FG_COLLOCATED_BATCHED(gamma_collocated_chain, SUF, T, Gamma6)              \
  FG_COLLOCATED_BATCHED(gamma_collocated_heat_chain, SUF, T, Gamma3)         \
  FG_COLLOCATED_BATCHED(gamma_collocated_zt_chain, SUF, T, GammaZt)          \
  FG_COLLOCATED_MIDDLE(gamma_collocated_chain, SUF, T, Gamma6)               \
  FG_COLLOCATED_MIDDLE(gamma_collocated_heat_chain, SUF, T, Gamma3)          \
  FG_COLLOCATED_MIDDLE(gamma_collocated_zt_chain, SUF, T, GammaZt)           \
  FG_COLLOCATED_MIDDLE(gamma_collocated_hyper_chain, SUF, T,                 \
                       GammaCollocatedHyper)

FG_CHAIN_ENTRIES(f32, float)
FG_CHAIN_ENTRIES(f64, double)
