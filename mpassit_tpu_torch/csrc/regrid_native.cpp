// Native kernels for host-side weight generation.
//
// The reference delegates its geometric core to ESMF's C++ (RegridStore's
// mesh search and overlap clipping; SURVEY §2.3). This file is the
// equivalent native layer for the rebuilt framework: tight scalar loops for
// the operations that are allocation-bound in NumPy.
//
//   clip_pairs: Sutherland–Hodgman clip of N (source polygon, target quad)
//   pairs on a plane + shoelace area of the intersection — the inner loop of
//   conservative weight generation (weights/conservative.py).
//
// Built on demand by mpassit_tpu/native.py:
//   g++ -O3 -march=native -fopenmp -shared -fPIC regrid_native.cpp
//
// ABI: plain C, called through ctypes.

#include <cstdint>
#include <cmath>

namespace {

struct Pt { double x, y; };

inline double cross(const Pt& o, const Pt& a, const Pt& b) {
    return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// Clip polygon `poly[0..n)` by the half-plane left of a->b, into `out`.
// Returns the output vertex count. Caller guarantees capacity.
inline int clip_edge(const Pt* poly, int n, Pt a, Pt b, Pt* out) {
    int m = 0;
    for (int i = 0; i < n; ++i) {
        const Pt& cur = poly[i];
        const Pt& nxt = poly[(i + 1 == n) ? 0 : i + 1];
        double dc = cross(a, b, cur);
        double dn = cross(a, b, nxt);
        if (dc >= 0.0) out[m++] = cur;
        if ((dc >= 0.0) != (dn >= 0.0)) {
            double t = dc / (dc - dn);
            out[m++] = {cur.x + t * (nxt.x - cur.x),
                        cur.y + t * (nxt.y - cur.y)};
        }
    }
    return m;
}

inline double shoelace(const Pt* poly, int n) {
    double s = 0.0;
    for (int i = 0; i < n; ++i) {
        const Pt& a = poly[i];
        const Pt& b = poly[(i + 1 == n) ? 0 : i + 1];
        s += a.x * b.y - a.y * b.x;
    }
    return 0.5 * s;
}

}  // namespace

extern "C" {

// quad:  (n, 4, 2) doubles, CCW
// spoly: (n, vmax, 2) doubles, CCW, first scnt[i] vertices valid
// area_out: (n,) intersection areas (>= 0)
void clip_pairs(int64_t n, int64_t vmax, const double* quad,
                const double* spoly, const int32_t* scnt, double* area_out) {
    constexpr int CAP = 64;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        int sn = scnt[i];
        if (sn < 3) { area_out[i] = 0.0; continue; }
        Pt bufA[CAP], bufB[CAP];
        const double* sp = spoly + i * vmax * 2;
        for (int v = 0; v < sn && v < CAP; ++v)
            bufA[v] = {sp[2 * v], sp[2 * v + 1]};
        const double* q = quad + i * 8;
        Pt* cur = bufA;
        Pt* nxt = bufB;
        int cn = sn;
        for (int e = 0; e < 4 && cn >= 3; ++e) {
            Pt a = {q[2 * e], q[2 * e + 1]};
            int e2 = (e + 1) & 3;
            Pt b = {q[2 * e2], q[2 * e2 + 1]};
            cn = clip_edge(cur, cn, a, b, nxt);
            Pt* t = cur; cur = nxt; nxt = t;
        }
        area_out[i] = (cn >= 3) ? shoelace(cur, cn) : 0.0;
    }
}

// Full conservative pair pipeline: gnomonic projection of the target quad
// and the source Voronoi polygon onto the plane tangent at the target
// center, CCW orientation, 4-edge Sutherland–Hodgman clip, and the overlap
// fraction area(clip)/area(quad). One OpenMP loop replaces five chained
// NumPy passes over the (npairs, vmax) arrays (the allocation-bound part
// of weights/conservative.py; semantics identical to its fallback).
//
// pt, ps:   (n,) pair target / source ids
// ctr,e1,e2:(T, 3) tangent frames at target centers (unit vectors)
// corners:  (T, 4, 3) target cell corner unit vectors
// voc:      (S, me) vertex ids per source cell, -1 padded (valid prefix)
// vxyz:     (nverts, 3) vertex unit vectors
// frac_out: (n,) overlap fraction of the target cell area
void conservative_pairs(int64_t n, int64_t me,
                        const int64_t* pt, const int64_t* ps,
                        const double* ctr, const double* e1,
                        const double* e2, const double* corners,
                        const int64_t* voc, const double* vxyz,
                        double* frac_out) {
    constexpr int CAP = 64;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const int64_t t = pt[i], s = ps[i];
        const double* N = ctr + 3 * t;
        const double* E1 = e1 + 3 * t;
        const double* E2 = e2 + 3 * t;
        auto project = [&](const double* p) -> Pt {
            double dn = p[0] * N[0] + p[1] * N[1] + p[2] * N[2];
            return {(p[0] * E1[0] + p[1] * E1[1] + p[2] * E1[2]) / dn,
                    (p[0] * E2[0] + p[1] * E2[1] + p[2] * E2[2]) / dn};
        };
        Pt quad[4];
        for (int c = 0; c < 4; ++c)
            quad[c] = project(corners + (t * 4 + c) * 3);
        double qa = shoelace(quad, 4);
        if (qa < 0.0) {                       // enforce CCW clip quad
            Pt tmp = quad[0]; quad[0] = quad[3]; quad[3] = tmp;
            tmp = quad[1]; quad[1] = quad[2]; quad[2] = tmp;
            qa = -qa;
        }
        if (!(qa > 0.0)) { frac_out[i] = 0.0; continue; }

        Pt bufA[CAP], bufB[CAP];
        int sn = 0;
        const int64_t* vs = voc + s * me;
        for (int v = 0; v < me && vs[v] >= 0 && sn < CAP; ++v)
            bufA[sn++] = project(vxyz + 3 * vs[v]);
        if (sn < 3) { frac_out[i] = 0.0; continue; }
        if (shoelace(bufA, sn) < 0.0) {       // orient source CCW
            for (int v = 0; v < sn / 2; ++v) {
                Pt tmp = bufA[v];
                bufA[v] = bufA[sn - 1 - v];
                bufA[sn - 1 - v] = tmp;
            }
        }
        Pt* cur = bufA;
        Pt* nxt = bufB;
        int cn = sn;
        for (int e = 0; e < 4 && cn >= 3; ++e) {
            cn = clip_edge(cur, cn, quad[e], quad[(e + 1) & 3], nxt);
            Pt* tmp = cur; cur = nxt; nxt = tmp;
        }
        frac_out[i] = (cn >= 3) ? shoelace(cur, cn) / qa : 0.0;
    }
}

// Barycentric locate: for each point, test `ntri` candidate triangles and
// report the best (max of min barycentric coord) — the inner loop of
// bilinear weight generation. All coordinates are 3-D unit vectors.
//
// points:  (n, 3)
// cand:    (n, ntri) triangle ids into tri_verts, -1 padded
// tri_verts: (ntris, 3, 3) corner position vectors (row per triangle)
// best_out: (n,) best candidate slot (or -1)
// w_out:   (n, 3) barycentric weights of the best candidate
void bary_locate(int64_t n, int64_t ntri, const double* points,
                 const int64_t* cand, const double* tri_verts,
                 int64_t* best_out, double* w_out) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        const double* p = points + 3 * i;
        double best_minw = -1e300;
        int64_t best_slot = -1;
        double bw[3] = {0, 0, 0};
        for (int64_t s = 0; s < ntri; ++s) {
            int64_t t = cand[i * ntri + s];
            if (t < 0) continue;
            const double* A = tri_verts + 9 * t;
            const double* B = A + 3;
            const double* C = A + 6;
            // triple products det[p b c], det[a p c], det[a b p]
            auto det3 = [](const double* a, const double* b, const double* c) {
                return a[0] * (b[1] * c[2] - b[2] * c[1])
                     - a[1] * (b[0] * c[2] - b[2] * c[0])
                     + a[2] * (b[0] * c[1] - b[1] * c[0]);
            };
            double xa = det3(p, B, C);
            double xb = det3(A, p, C);
            double xc = det3(A, B, p);
            double ssum = xa + xb + xc;
            if (ssum == 0.0) continue;
            double wa = xa / ssum, wb = xb / ssum, wc = xc / ssum;
            double minw = wa < wb ? (wa < wc ? wa : wc) : (wb < wc ? wb : wc);
            if (minw > best_minw) {
                best_minw = minw;
                best_slot = s;
                bw[0] = wa; bw[1] = wb; bw[2] = wc;
            }
        }
        best_out[i] = best_slot;
        w_out[3 * i] = bw[0];
        w_out[3 * i + 1] = bw[1];
        w_out[3 * i + 2] = bw[2];
    }
}

}  // extern "C"
