// Native helpers: mesh voxelization, exact point-triangle distances, and
// sequential fast-sweeping eikonal redistancing.
//
// Host code, the same source as the JAX package's native/voxelize.cpp: the
// exact 8-sweep Gauss-Seidel fast-sweeping solver (a cross-check of the
// Jacobi-Godunov redistancing), and the mesh -> SDF pipeline's ray-parity
// occupancy on the voxel lattice with a 2-D triangle binning accelerator,
// and exact closest-point-on-triangle distances for the near-surface band.
//
// Built by native/__init__.py at first use:
//   g++ -O3 -march=native -fopenmp -shared -fPIC voxelize.cpp -o build/libsdfnative.so
// and bound with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Fast sweeping method: exact sequential Gauss-Seidel eikonal solver.
// phi: res^3 level set (z-major: phi[z*res*res + y*res + x]); out: signed
// distance with the same zero crossing. h = 1/res grid spacing.
// ---------------------------------------------------------------------------

static inline double solve_eikonal(double a, double b, double c, double h) {
    // sort a<=b<=c
    if (a > b) std::swap(a, b);
    if (b > c) std::swap(b, c);
    if (a > b) std::swap(a, b);
    double u = a + h;
    if (u <= b) return u;
    // two-term quadratic
    double sum = a + b, diff2 = 2.0 * h * h - (a - b) * (a - b);
    u = 0.5 * (sum + std::sqrt(diff2 > 0 ? diff2 : 0));
    if (u <= c) return u;
    double s3 = a + b + c;
    double q = s3 * s3 - 3.0 * (a * a + b * b + c * c - h * h);
    return (s3 + std::sqrt(q > 0 ? q : 0)) / 3.0;
}

void fsm_redistance(const float* phi, float* out, int64_t res, int n_passes) {
    const int64_t n = res * res * res;
    const double h = 1.0 / (double)res;
    const double BIG = 1e9;
    std::vector<double> d(n, BIG);
    std::vector<int8_t> sign(n), frozen(n, 0);

    auto idx = [res](int64_t z, int64_t y, int64_t x) {
        return (z * res + y) * res + x;
    };

    // interface initialization: first-order sub-cell distances
    for (int64_t z = 0; z < res; z++)
        for (int64_t y = 0; y < res; y++)
            for (int64_t x = 0; x < res; x++) {
                int64_t i = idx(z, y, x);
                double p = phi[i];
                sign[i] = p >= 0 ? 1 : -1;
                double inv_d2 = 0.0;
                bool cross = false;
                const int64_t zo[6] = {-1, 1, 0, 0, 0, 0};
                const int64_t yo[6] = {0, 0, -1, 1, 0, 0};
                const int64_t xo[6] = {0, 0, 0, 0, -1, 1};
                for (int k = 0; k < 6; k++) {
                    int64_t zz = z + zo[k], yy = y + yo[k], xx = x + xo[k];
                    if (zz < 0 || zz >= res || yy < 0 || yy >= res || xx < 0 || xx >= res)
                        continue;
                    double q = phi[idx(zz, yy, xx)];
                    if ((p >= 0) != (q >= 0)) {
                        double denom = std::fabs(p - q);
                        double dd = denom > 1e-12 ? h * std::fabs(p) / denom : 0.0;
                        dd = std::max(dd, 1e-2 * h);
                        inv_d2 += 1.0 / (dd * dd);
                        cross = true;
                    }
                }
                if (cross) {
                    d[i] = 1.0 / std::sqrt(inv_d2);
                    frozen[i] = 1;
                }
            }

    // 8 directional sweeps x n_passes
    for (int pass = 0; pass < n_passes; pass++) {
        for (int sweep = 0; sweep < 8; sweep++) {
            int64_t z0 = (sweep & 1) ? res - 1 : 0, dz = (sweep & 1) ? -1 : 1;
            int64_t y0 = (sweep & 2) ? res - 1 : 0, dy = (sweep & 2) ? -1 : 1;
            int64_t x0 = (sweep & 4) ? res - 1 : 0, dx = (sweep & 4) ? -1 : 1;
            for (int64_t z = z0; z >= 0 && z < res; z += dz)
                for (int64_t y = y0; y >= 0 && y < res; y += dy)
                    for (int64_t x = x0; x >= 0 && x < res; x += dx) {
                        int64_t i = idx(z, y, x);
                        if (frozen[i]) continue;
                        double az = std::min(z > 0 ? d[idx(z - 1, y, x)] : BIG,
                                             z < res - 1 ? d[idx(z + 1, y, x)] : BIG);
                        double ay = std::min(y > 0 ? d[idx(z, y - 1, x)] : BIG,
                                             y < res - 1 ? d[idx(z, y + 1, x)] : BIG);
                        double ax = std::min(x > 0 ? d[idx(z, y, x - 1)] : BIG,
                                             x < res - 1 ? d[idx(z, y, x + 1)] : BIG);
                        double u = solve_eikonal(az, ay, ax, h);
                        if (u < d[i]) d[i] = u;
                    }
        }
    }
    for (int64_t i = 0; i < n; i++) out[i] = (float)(sign[i] * d[i]);
}

// ---------------------------------------------------------------------------
// Mesh voxelization: ray-parity occupancy on voxel centers of the unit cube.
// verts: (nv,3) float32 xyz; tris: (nt,3) int32. Rays along +y from each
// (x, z) column (mesh_to_sdf.py:20-26). out: res^3 floats, +1 outside, -1
// inside (z-major, data[z][y][x]).
// ---------------------------------------------------------------------------

void mesh_occupancy(const float* verts, int64_t nv, const int32_t* tris,
                    int64_t nt, int64_t res, float* out) {
    const int64_t n2 = res * res;
    // bin triangles into the (x,z) grid
    std::vector<std::vector<int32_t>> bins(n2);
    for (int64_t t = 0; t < nt; t++) {
        const float* a = verts + 3 * tris[3 * t];
        const float* b = verts + 3 * tris[3 * t + 1];
        const float* c = verts + 3 * tris[3 * t + 2];
        float xmin = std::min({a[0], b[0], c[0]}), xmax = std::max({a[0], b[0], c[0]});
        float zmin = std::min({a[2], b[2], c[2]}), zmax = std::max({a[2], b[2], c[2]});
        int64_t ix0 = std::max<int64_t>(0, (int64_t)std::floor(xmin * res - 0.5));
        int64_t ix1 = std::min<int64_t>(res - 1, (int64_t)std::ceil(xmax * res - 0.5));
        int64_t iz0 = std::max<int64_t>(0, (int64_t)std::floor(zmin * res - 0.5));
        int64_t iz1 = std::min<int64_t>(res - 1, (int64_t)std::ceil(zmax * res - 0.5));
        for (int64_t iz = iz0; iz <= iz1; iz++)
            for (int64_t ix = ix0; ix <= ix1; ix++)
                bins[iz * res + ix].push_back((int32_t)t);
    }

#pragma omp parallel for schedule(dynamic, 4)
    for (int64_t col = 0; col < n2; col++) {
        int64_t iz = col / res, ix = col % res;
        double px = (ix + 0.5) / res, pz = (iz + 0.5) / res;
        // collect crossing heights along +y
        std::vector<double> hits;
        for (int32_t t : bins[col]) {
            const float* A = verts + 3 * tris[3 * t];
            const float* B = verts + 3 * tris[3 * t + 1];
            const float* C = verts + 3 * tris[3 * t + 2];
            // 2D point-in-triangle in the (x,z) plane + y interpolation
            double ax = A[0] - px, az = A[2] - pz;
            double bx = B[0] - px, bz = B[2] - pz;
            double cx = C[0] - px, cz = C[2] - pz;
            double d1 = ax * bz - az * bx;
            double d2 = bx * cz - bz * cx;
            double d3 = cx * az - cz * ax;
            bool neg = (d1 < 0) || (d2 < 0) || (d3 < 0);
            bool pos = (d1 > 0) || (d2 > 0) || (d3 > 0);
            if (neg && pos) continue;  // outside
            double area = d1 + d2 + d3;
            if (std::fabs(area) < 1e-18) continue;  // degenerate in projection
            double w0 = d2 / area, w1 = d3 / area, w2 = d1 / area;
            hits.push_back(w0 * A[1] + w1 * B[1] + w2 * C[1]);
        }
        std::sort(hits.begin(), hits.end());
        for (int64_t iy = 0; iy < res; iy++) {
            double py = (iy + 0.5) / res;
            int64_t crossings = hits.end() - std::upper_bound(hits.begin(), hits.end(), py);
            out[(iz * res + iy) * res + ix] = (crossings % 2 == 1) ? -1.0f : 1.0f;
        }
    }
}

// ---------------------------------------------------------------------------
// Exact unsigned point-triangle distances for near-surface refinement
// (replaces the reference's 256-direction min-hit fans, mesh_to_sdf.py:31-55).
// points: (np,3); out: (np,) min distance over all triangles.
// ---------------------------------------------------------------------------

static inline double tri_dist2(const double p[3], const float* A, const float* B, const float* C) {
    double ab[3] = {B[0] - A[0], B[1] - A[1], B[2] - A[2]};
    double ac[3] = {C[0] - A[0], C[1] - A[1], C[2] - A[2]};
    double ap[3] = {p[0] - A[0], p[1] - A[1], p[2] - A[2]};
    double d1 = ab[0] * ap[0] + ab[1] * ap[1] + ab[2] * ap[2];
    double d2 = ac[0] * ap[0] + ac[1] * ap[1] + ac[2] * ap[2];
    double best[3];
    if (d1 <= 0 && d2 <= 0) { best[0] = A[0]; best[1] = A[1]; best[2] = A[2]; goto done; }
    {
        double bp[3] = {p[0] - B[0], p[1] - B[1], p[2] - B[2]};
        double d3 = ab[0] * bp[0] + ab[1] * bp[1] + ab[2] * bp[2];
        double d4 = ac[0] * bp[0] + ac[1] * bp[1] + ac[2] * bp[2];
        if (d3 >= 0 && d4 <= d3) { best[0] = B[0]; best[1] = B[1]; best[2] = B[2]; goto done; }
        double vc = d1 * d4 - d3 * d2;
        if (vc <= 0 && d1 >= 0 && d3 <= 0) {
            double v = d1 / (d1 - d3);
            for (int k = 0; k < 3; k++) best[k] = A[k] + v * ab[k];
            goto done;
        }
        double cp[3] = {p[0] - C[0], p[1] - C[1], p[2] - C[2]};
        double d5 = ab[0] * cp[0] + ab[1] * cp[1] + ab[2] * cp[2];
        double d6 = ac[0] * cp[0] + ac[1] * cp[1] + ac[2] * cp[2];
        if (d6 >= 0 && d5 <= d6) { best[0] = C[0]; best[1] = C[1]; best[2] = C[2]; goto done; }
        double vb = d5 * d2 - d1 * d6;
        if (vb <= 0 && d2 >= 0 && d6 <= 0) {
            double w = d2 / (d2 - d6);
            for (int k = 0; k < 3; k++) best[k] = A[k] + w * ac[k];
            goto done;
        }
        double va = d3 * d6 - d5 * d4;
        if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
            double w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
            for (int k = 0; k < 3; k++) best[k] = B[k] + w * (C[k] - B[k]);
            goto done;
        }
        {
            double denom = 1.0 / (va + vb + vc);
            double v = vb * denom, w = vc * denom;
            for (int k = 0; k < 3; k++) best[k] = A[k] + ab[k] * v + ac[k] * w;
        }
    }
done:
    double dx = p[0] - best[0], dy = p[1] - best[1], dz = p[2] - best[2];
    return dx * dx + dy * dy + dz * dz;
}

void mesh_min_distance(const float* verts, int64_t nv, const int32_t* tris,
                       int64_t nt, const float* points, int64_t np_, float* out) {
#pragma omp parallel for schedule(dynamic, 16)
    for (int64_t i = 0; i < np_; i++) {
        double p[3] = {points[3 * i], points[3 * i + 1], points[3 * i + 2]};
        double best = 1e30;
        for (int64_t t = 0; t < nt; t++) {
            double d2 = tri_dist2(p, verts + 3 * tris[3 * t],
                                  verts + 3 * tris[3 * t + 1],
                                  verts + 3 * tris[3 * t + 2]);
            if (d2 < best) best = d2;
        }
        out[i] = (float)std::sqrt(best);
    }
}

}  // extern "C"
