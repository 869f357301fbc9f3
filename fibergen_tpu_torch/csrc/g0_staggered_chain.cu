// K3 g0_staggered_chain and K4 g0_staggered_heat_chain: u = irfftn(G0
// rfftn(f)), the staggered-grid Green operator between hand-written
// transforms, on a 3-component force field (K3, elasticity and the viscosity
// Delta scheme) or a 1-component source field (K4, heat and porous flow).
//
// Replaces the TPU kernel fibergen_tpu/ops/pallas_chain.py _middle with
// _g0_apply (K3, via g0_staggered_middle) and with _g0_heat_apply (K4, via
// g0_staggered_heat_middle).  _middle runs four matmul-DFT c2c stages (y, x
// forward; x, y inverse) with the G0 apply between the x stages; the JAX
// package puts the z r2c/c2r stages around it.  Here the whole chain is five
// kernels, launched one after another on one stream:
//
//   z_fwd    real lines along z -> half-spectrum (C, nx, ny, nz/2+1)
//   y_line   c2c forward along y, in place
//   x_apply  c2c forward along x, the G0 apply, c2c inverse along x, in place
//   y_line   c2c inverse along y, in place
//   z_inv    half-spectrum -> real lines along z (Hermitian completion)
//
// The five passes are templates on the apply step, which fixes the
// component count C; K3 and K4 are two instantiations of one chain.
// G0 (green.py:457-496 and :890-899, pallas_chain.py:288-331):
//   K3 (C = 3): eta = c1 f - c2 (f . k+) conj(k+), c1 = c10/|k|^2, c2 = c20/|k|^4
//   K4 (C = 1): eta = c10 f / |k|^2
//   k+_a = sin(xi_a) / h_a * exp(i xi_a)  per axis; the DC bin is zeroed.
// k+ comes from three 1-D tables in natural rfft bin order (rows Re k+,
// Im k+, |k+|^2); the 1/N of norm="forward" is folded into the constants.
//
// Each block loads a tile of whole lines into shared memory and transforms
// it there.  A power-of-two length runs radix-4 passes (radix 2 for an odd
// power): decimation in frequency takes natural order to bit-reversed
// order, decimation in time takes it back, so no pass only permutes; the
// kernels read bit-reversed bins where they store or apply.  Any other
// length runs a direct O(n^2) DFT.  Twiddles exp(-2 pi i t / n) come from
// a per-axis table built in double.  The z kernels pack two real lines into
// one complex transform (a + i b) and split or join their spectra by
// Hermitian symmetry; with C = 1 the pairs are neighbouring y lines.
//
// Bound on the card: device-memory bytes.  The function reads f and writes
// u once (2C values per voxel); the chain moves the spectrum five times, so
// it runs at about five times that bound at best.  Design: y and x tiles
// take TK consecutive kz bins of every line (coalesced along kz); the x
// kernel holds all C components of its tile, so the G0 apply, which mixes
// components, happens between the forward and inverse x transforms without
// a trip through device memory, as in the TPU kernel.

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

// Real lines of length nz (line g at f + g * nz) -> bins 0..nzh-1 of their
// DFT (line g at spec + g * nzh).  Block: 2^log2P complex lines, each
// holding real lines 2m (real part) and 2m+1 (imaginary part).
template <typename T>
__global__ void z_fwd(const T* __restrict__ f, Cx<T>* __restrict__ spec,
                      const Cx<T>* __restrict__ tw, int nz, int log2nz,
                      int nzh, int64_t nlines, int log2P) {
  const int P = 1 << log2P;
  Cx<T>* s = smem_base<T>();
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * 2 * P;
  for (int e = threadIdx.x; e < P * nz; e += blockDim.x) {
    const int m = e / nz, j = e - m * nz;
    const int64_t ga = g0 + 2 * m;
    s[e] = {ga < nlines ? f[ga * nz + j] : T(0),
            ga + 1 < nlines ? f[(ga + 1) * nz + j] : T(0)};
  }
  __syncthreads();
  const Tile t{nz, log2nz, log2P, 1, 1, nz, 0};
  line_dft(s, s + P * nz, t, tw, false, true);
  for (int e = threadIdx.x; e < P * nzh; e += blockDim.x) {
    const int m = e / nzh, k = e - m * nzh;
    const int64_t ga = g0 + 2 * m;
    const Cx<T> z = s[m * nz + rev(k, log2nz)];
    const Cx<T> zc = s[m * nz + rev(k ? nz - k : 0, log2nz)];
    // A = (Z[k] + conj Z[n-k]) / 2,  B = (Z[k] - conj Z[n-k]) / 2i
    if (ga < nlines)
      spec[ga * nzh + k] = {T(0.5) * (z.r + zc.r), T(0.5) * (z.i - zc.i)};
    if (ga + 1 < nlines)
      spec[(ga + 1) * nzh + k] = {T(0.5) * (z.i + zc.i),
                                  T(0.5) * (zc.r - z.r)};
  }
}

// Bin j of the full spectrum of line g from its half (bin nz-j =
// conj(bin j)); the imaginary parts of the DC and Nyquist bins are dropped,
// as a c2r transform drops them.
template <typename T>
__device__ __forceinline__ Cx<T> full_bin(const Cx<T>* __restrict__ spec,
                                          int64_t g, int64_t nlines, int j,
                                          int nz, int nzh) {
  if (g >= nlines) return {T(0), T(0)};
  Cx<T> v;
  if (j < nzh) {
    v = spec[g * nzh + j];
  } else {
    v = spec[g * nzh + (nz - j)];
    v.i = -v.i;
  }
  if (j == 0 || 2 * j == nz) v.i = T(0);
  return v;
}

// Inverse of z_fwd: the complex line m carries A + i B of real lines 2m
// and 2m+1, whose inverse DFT has them as its real and imaginary parts.
template <typename T>
__global__ void z_inv(const Cx<T>* __restrict__ spec, T* __restrict__ out,
                      const Cx<T>* __restrict__ tw, int nz, int log2nz,
                      int nzh, int64_t nlines, int log2P) {
  const int P = 1 << log2P;
  Cx<T>* s = smem_base<T>();
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * 2 * P;
  for (int e = threadIdx.x; e < P * nz; e += blockDim.x) {
    const int m = e / nz, j = e - m * nz;
    const int64_t ga = g0 + 2 * m;
    const Cx<T> a = full_bin(spec, ga, nlines, j, nz, nzh);
    const Cx<T> b = full_bin(spec, ga + 1, nlines, j, nz, nzh);
    s[e] = {a.r - b.i, a.i + b.r};
  }
  __syncthreads();
  const Tile t{nz, log2nz, log2P, 1, 1, nz, 0};
  line_dft(s, s + P * nz, t, tw, true, true);
  for (int e = threadIdx.x; e < P * nz; e += blockDim.x) {
    const int m = e / nz, j = e - m * nz;
    const int64_t ga = g0 + 2 * m;
    const Cx<T> v = s[m * nz + rev(j, log2nz)];
    if (ga < nlines) out[ga * nz + j] = v.r;
    if (ga + 1 < nlines) out[(ga + 1) * nz + j] = v.i;
  }
}

// c2c along y in place: block (kz tile, c * nx + x) transforms ny-long lines
// of 2^log2TK consecutive kz bins; tile layout s[j * TK + t].
template <typename T>
__global__ void y_line(Cx<T>* __restrict__ spec, const Cx<T>* __restrict__ tw,
                       int ny, int log2ny, int nzh, int log2TK, bool inv) {
  const int TK = 1 << log2TK;
  Cx<T>* s = smem_base<T>();
  const int kz0 = blockIdx.x * TK;
  Cx<T>* base = spec + static_cast<int64_t>(blockIdx.y) * ny * nzh + kz0;
  for (int e = threadIdx.x; e < ny * TK; e += blockDim.x) {
    const int j = e >> log2TK, q = e & (TK - 1);
    s[e] = kz0 + q < nzh ? base[static_cast<int64_t>(j) * nzh + q]
                         : Cx<T>{T(0), T(0)};
  }
  __syncthreads();
  const Tile t{ny, log2ny, log2TK, 1, TK, 1, 0};
  line_dft(s, s + ny * TK, t, tw, inv, true);
  for (int e = threadIdx.x; e < ny * TK; e += blockDim.x) {
    const int j = e >> log2TK, q = e & (TK - 1);
    if (kz0 + q < nzh)
      base[static_cast<int64_t>(j) * nzh + q] = s[(rev(j, log2ny) << log2TK) + q];
  }
}

// The elasticity G0 (K3) on one bin of a 3-component tile; v[c * bs] is
// component c.
template <typename T>
struct G0Vector {
  static constexpr int C = 3;
  T c10, c20;
  __device__ __forceinline__ void operator()(Cx<T>* v, int bs, const T* kr,
                                             const T* ki, T n2) const {
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
  T c10;
  __device__ __forceinline__ void operator()(Cx<T>* v, int, const T*,
                                             const T*, T n2) const {
    const T c1 = c10 / n2;
    v[0] = {c1 * v[0].r, c1 * v[0].i};
  }
};

// Forward x transform, G0 apply, inverse x transform, in place: block
// (kz tile, y) holds all C components, tile layout
// s[c * nx * TK + i * TK + t].  The forward pass leaves the x bins in
// bit-reversed order and the inverse pass takes them so.
template <typename T, class A>
__global__ void x_apply(Cx<T>* __restrict__ spec, const Cx<T>* __restrict__ tw,
                        const T* __restrict__ tx, const T* __restrict__ ty,
                        const T* __restrict__ tz, A apply, int nx,
                        int log2nx, int ny, int nzh, int log2TK) {
  constexpr int C = A::C;
  const int TK = 1 << log2TK;
  const int bs = nx * TK;
  Cx<T>* s = smem_base<T>();
  const int kz0 = blockIdx.x * TK, y = blockIdx.y;
  const int64_t sc = static_cast<int64_t>(nx) * ny * nzh;  // component
  const int64_t sx = static_cast<int64_t>(ny) * nzh;       // x
  Cx<T>* base = spec + static_cast<int64_t>(y) * nzh + kz0;
  for (int e = threadIdx.x; e < C * bs; e += blockDim.x) {
    const int c = e / bs, i = (e - c * bs) >> log2TK, q = e & (TK - 1);
    s[e] = kz0 + q < nzh ? base[c * sc + i * sx + q] : Cx<T>{T(0), T(0)};
  }
  __syncthreads();
  const Tile t{nx, log2nx, log2TK, C, TK, 1, bs};
  line_dft(s, s + C * bs, t, tw, false, true);
  const T kyr = ty[y], kyi = ty[ny + y], ky2 = ty[2 * ny + y];
  for (int e = threadIdx.x; e < bs; e += blockDim.x) {
    const int p = e >> log2TK, q = e & (TK - 1), k = kz0 + q;
    const int i = rev(p, log2nx);
    if (k >= nzh) continue;
    Cx<T>* v = s + e;
    if (i == 0 && y == 0 && k == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) v[c * bs] = Cx<T>{T(0), T(0)};
      continue;
    }
    const T kr[3] = {tx[i], kyr, tz[k]};
    const T ki[3] = {tx[nx + i], kyi, tz[nzh + k]};
    apply(v, bs, kr, ki, tx[2 * nx + i] + ky2 + tz[2 * nzh + k]);
  }
  __syncthreads();
  line_dft(s, s + C * bs, t, tw, true, false);
  for (int e = threadIdx.x; e < C * bs; e += blockDim.x) {
    const int c = e / bs, i = (e - c * bs) >> log2TK, q = e & (TK - 1);
    if (kz0 + q < nzh) base[c * sc + i * sx + q] = s[e];
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

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > kMaxBytes) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, class A>
int launch(const void* f, void* spec, void* out, const void* tx,
           const void* ty, const void* tz, const void* twx, const void* twy,
           const void* twz, const A& apply, int nx, int ny, int nz,
           void* stream) {
  using Cp = Cx<T>;
  constexpr int C = A::C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nzh = nz / 2 + 1;
  const int lx = log2_or_neg(nx), ly = log2_or_neg(ny), lz = log2_or_neg(nz);
  const size_t cs = sizeof(Cp);
  Cp* sp = static_cast<Cp*>(spec);
  cudaError_t err;

  // z: 2^lP complex lines (twice as many real lines) per block
  const int64_t zlines = static_cast<int64_t>(C) * nx * ny;
  const size_t zunit = (lz >= 0 ? 1 : 2) * nz * cs;
  const int lP = pick_log2(zunit, nz >= 2048 ? 1 : 2048 / nz, 1 << 30);
  const int64_t zper = 2LL << lP;
  const unsigned zblocks = static_cast<unsigned>((zlines + zper - 1) / zper);
  // y: TK kz columns of all ny rows; x: TK columns of C components x nx rows
  const int want = sizeof(T) == 4 ? 16 : 8;
  const size_t yunit = (ly >= 0 ? 1 : 2) * ny * cs;
  const int lTy = pick_log2(yunit, want, nzh);
  const size_t xunit = (lx >= 0 ? 1 : 2) * C * nx * cs;
  const int lTx = pick_log2(xunit, want, nzh);
  const size_t zb = zunit << lP, yb = yunit << lTy, xb = xunit << lTx;

  if ((err = allow_smem(z_fwd<T>, zb)) || (err = allow_smem(z_inv<T>, zb)) ||
      (err = allow_smem(y_line<T>, yb)) ||
      (err = allow_smem(x_apply<T, A>, xb)))
    return static_cast<int>(err);

  z_fwd<T><<<zblocks, kThreads, zb, st>>>(
      static_cast<const T*>(f), sp, static_cast<const Cp*>(twz), nz, lz, nzh,
      zlines, lP);
  const dim3 yg((nzh + (1 << lTy) - 1) >> lTy, C * nx);
  y_line<T><<<yg, kThreads, yb, st>>>(sp, static_cast<const Cp*>(twy), ny,
                                      ly, nzh, lTy, false);
  const dim3 xg((nzh + (1 << lTx) - 1) >> lTx, ny);
  x_apply<T, A><<<xg, kThreads, xb, st>>>(
      sp, static_cast<const Cp*>(twx), static_cast<const T*>(tx),
      static_cast<const T*>(ty), static_cast<const T*>(tz), apply, nx, lx,
      ny, nzh, lTx);
  y_line<T><<<yg, kThreads, yb, st>>>(sp, static_cast<const Cp*>(twy), ny,
                                      ly, nzh, lTy, true);
  z_inv<T><<<zblocks, kThreads, zb, st>>>(
      sp, static_cast<T*>(out), static_cast<const Cp*>(twz), nz, lz, nzh,
      zlines, lP);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The 1/N of norm="forward" is folded into the constants here.
#define FG_CHAIN_ARGS                                                        \
  const void *f, void *spec, void *out, const void *tx, const void *ty,      \
      const void *tz, const void *twx, const void *twy, const void *twz
#define FG_CHAIN_PASS f, spec, out, tx, ty, tz, twx, twy, twz

#define FG_CHAIN_ENTRIES(SUF, T)                                             \
  extern "C" int g0_staggered_chain_##SUF(FG_CHAIN_ARGS, double c10,        \
                                          double c20, int nx, int ny,        \
                                          int nz, void* stream) {            \
    const double n = static_cast<double>(nx) * ny * nz;                      \
    return launch<T>(FG_CHAIN_PASS, G0Vector<T>{T(c10 / n), T(c20 / n)},     \
                     nx, ny, nz, stream);                                    \
  }                                                                          \
  extern "C" int g0_staggered_heat_chain_##SUF(FG_CHAIN_ARGS, double c10,   \
                                               int nx, int ny, int nz,       \
                                               void* stream) {               \
    const double n = static_cast<double>(nx) * ny * nz;                      \
    return launch<T>(FG_CHAIN_PASS, G0Scalar<T>{T(c10 / n)}, nx, ny, nz,     \
                     stream);                                                \
  }

FG_CHAIN_ENTRIES(f32, float)
FG_CHAIN_ENTRIES(f64, double)
