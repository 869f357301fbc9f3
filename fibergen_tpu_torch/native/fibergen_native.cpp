// Native host-side geometry kernels for fibergen_tpu_torch (a copy of
// fibergen_tpu/native/fibergen_native.cpp).
//
// The card owns the field math; what remains on the host is the sequential
// RSA generation loop, whose collision queries the reference serves with its
// C++ FiberCluster (fibergen.cpp:3157-3646).  These kernels provide the
// equivalent: batched capsule-capsule clearance with early exit,
// point-triangle distances for mesh collision, and the exact halfspace/box
// cut volume used as an oracle for the voxelizer.
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency).  Built with
// g++ at first use into fibergen_tpu_torch/_build/ (native/__init__.py).

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <algorithm>

namespace {

inline double dot3(const double* a, const double* b) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

inline void sub3(const double* a, const double* b, double* out) {
    out[0] = a[0] - b[0];
    out[1] = a[1] - b[1];
    out[2] = a[2] - b[2];
}

inline double clamp01(double x) {
    return x < 0.0 ? 0.0 : (x > 1.0 ? 1.0 : x);
}

// closest-distance between segments (p1,q1) and (p2,q2)
double segseg(const double* p1, const double* q1,
              const double* p2, const double* q2) {
    double d1[3], d2[3], r[3];
    sub3(q1, p1, d1);
    sub3(q2, p2, d2);
    sub3(p1, p2, r);
    const double a = dot3(d1, d1);
    const double e = dot3(d2, d2);
    const double f = dot3(d2, r);
    const double eps = 1e-30;
    double s = 0.0, t = 0.0;

    if (a <= eps && e <= eps) {
        // both degenerate: point-point
    } else if (a <= eps) {
        t = clamp01(f / e);
    } else {
        const double c = dot3(d1, r);
        if (e <= eps) {
            s = clamp01(-c / a);
        } else {
            const double b = dot3(d1, d2);
            const double denom = a * e - b * b;
            if (denom > eps) {
                s = clamp01((b * f - c * e) / denom);
            }
            t = (b * s + f) / e;
            if (t < 0.0) {
                t = 0.0;
                s = clamp01(-c / a);
            } else if (t > 1.0) {
                t = 1.0;
                s = clamp01((b - c) / a);
            }
        }
    }
    double c1[3], c2[3], d[3];
    for (int k = 0; k < 3; k++) {
        c1[k] = p1[k] + s * d1[k];
        c2[k] = p2[k] + t * d2[k];
        d[k] = c1[k] - c2[k];
    }
    return std::sqrt(dot3(d, d));
}

}  // namespace

extern "C" {

// Batched segment-segment distances: segment (p1,q1) against n segments.
void segseg_distance_batch(const double* p1, const double* q1,
                           const double* P2, const double* Q2,
                           int64_t n, double* out) {
    for (int64_t i = 0; i < n; i++) {
        out[i] = segseg(p1, q1, P2 + 3 * i, Q2 + 3 * i);
    }
}

// Minimum capsule-capsule clearance of (p1,q1,r1) against n capsules with
// early exit below `cutoff` (the RSA rejection test: any clearance < dmin
// rejects the candidate, so the full minimum is not needed).
double capsule_clearance_min(const double* p1, const double* q1, double r1,
                             const double* P2, const double* Q2,
                             const double* R2, int64_t n, double cutoff) {
    double best = 1e300;
    for (int64_t i = 0; i < n; i++) {
        const double d = segseg(p1, q1, P2 + 3 * i, Q2 + 3 * i) - r1 - R2[i];
        if (d < best) {
            best = d;
            if (best < cutoff) return best;
        }
    }
    return best;
}

// Exact volume fraction of the axis-aligned box [-h0/2,h0/2]x...x[-h2/2,h2/2]
// on the side n.x <= -d of a plane at signed distance d from the box center
// (reference: halfspace_box_cut_volume, fibergen.cpp:1377-1578; evaluated as
// the CDF of a sum of three uniforms in long double for oracle accuracy).
double halfspace_box_cut_fraction(double nx, double ny, double nz, double d,
                                  double h0, double h1, double h2) {
    long double a[3] = {std::fabs((long double)nx) * h0 / 2,
                        std::fabs((long double)ny) * h1 / 2,
                        std::fabs((long double)nz) * h2 / 2};
    std::sort(a, a + 3);  // ascending: a[2] = max
    const long double t = -(long double)d;
    const long double A = a[0] + a[1] + a[2];
    if (t >= A) return 1.0;
    if (t <= -A) return 0.0;

    // f = Delta_{a2} Delta_{a1} Delta_{a0} relu(t)^3 / (48 a0 a1 a2)
    auto r3 = [](long double x) -> long double {
        return x > 0 ? x * x * x : 0.0L;
    };
    const long double eps = 1e-300L;
    long double a0 = std::max(a[0], (long double)1e-14L * (a[2] + eps));
    long double a1 = std::max(a[1], (long double)1e-14L * (a[2] + eps));
    long double a2 = a[2];

    auto k = [&](long double y) -> long double {  // Delta_{a0} relu^3
        if (y >= a0) return 2.0L * a0 * (3.0L * y * y + a0 * a0);
        if (y <= -a0) return 0.0L;
        return r3(y + a0);
    };
    auto h = [&](long double x) -> long double {
        if (x >= a0 + a1) return x;
        if (x <= -(a0 + a1)) return 0.0L;
        return (k(x + a1) - k(x - a1)) / (24.0L * a0 * a1);
    };
    long double f = (h(t + a2) - h(t - a2)) / (2.0L * a2);
    if (f < 0) f = 0;
    if (f > 1) f = 1;
    return (double)f;
}

// Batched point-triangle distances: n points against one triangle.
void point_triangle_distance_batch(const double* pts, int64_t n,
                                   const double* v0, const double* v1,
                                   const double* v2, double* out) {
    double ab[3], ac[3], bc[3];
    sub3(v1, v0, ab);
    sub3(v2, v0, ac);
    sub3(v2, v1, bc);
    for (int64_t i = 0; i < n; i++) {
        const double* p = pts + 3 * i;
        double ap[3], bp[3], cp[3];
        sub3(p, v0, ap);
        sub3(p, v1, bp);
        sub3(p, v2, cp);
        const double d1 = dot3(ab, ap), d2 = dot3(ac, ap);
        const double d3 = dot3(ab, bp), d4 = dot3(ac, bp);
        const double d5 = dot3(ab, cp), d6 = dot3(ac, cp);
        double c[3];
        if (d1 <= 0 && d2 <= 0) {
            c[0] = v0[0]; c[1] = v0[1]; c[2] = v0[2];
        } else if (d3 >= 0 && d4 <= d3) {
            c[0] = v1[0]; c[1] = v1[1]; c[2] = v1[2];
        } else if (d6 >= 0 && d5 <= d6) {
            c[0] = v2[0]; c[1] = v2[1]; c[2] = v2[2];
        } else {
            const double vc = d1 * d4 - d3 * d2;
            const double vb = d5 * d2 - d1 * d6;
            const double va = d3 * d6 - d5 * d4;
            if (vc <= 0 && d1 >= 0 && d3 <= 0) {
                const double t = d1 / (d1 - d3);
                for (int k2 = 0; k2 < 3; k2++) c[k2] = v0[k2] + t * ab[k2];
            } else if (vb <= 0 && d2 >= 0 && d6 <= 0) {
                const double t = d2 / (d2 - d6);
                for (int k2 = 0; k2 < 3; k2++) c[k2] = v0[k2] + t * ac[k2];
            } else if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
                const double t = (d4 - d3) / ((d4 - d3) + (d5 - d6));
                for (int k2 = 0; k2 < 3; k2++) c[k2] = v1[k2] + t * bc[k2];
            } else {
                const double denom = 1.0 / (va + vb + vc);
                const double v = vb * denom, w = vc * denom;
                for (int k2 = 0; k2 < 3; k2++)
                    c[k2] = v0[k2] + v * ab[k2] + w * ac[k2];
            }
        }
        double dd[3];
        sub3(p, c, dd);
        out[i] = std::sqrt(dot3(dd, dd));
    }
}

}  // extern "C"
