// Cubic B-spline evaluation of a dense (Z, Y, X) float32 grid at one point,
// shared by csrc/sphere_trace.cu and csrc/grid_eval.cu.
//
// Device counterpart of ops/grid.py::_tap_setup + _jet_contract (and of the
// tap gather that the JAX package's Pallas probes scripts/trace_probe_r3.py
// and scripts/gather_probe.py were written for).  Conventions:
//   * a point p = (x, y, z) in the unit cube indexes data[z][y][x];
//   * c = p * res - 0.5 per axis, base = floor(c), f = c - base;
//   * taps at base + {-1, 0, 1, 2}, each index clamped to [0, res - 1] per
//     axis (Mitsuba's "clamp" wrap);
//   * gradients are w.r.t. the normalised point: scaled by res per axis.
//
// The 64 taps are read straight from the grid through the read-only data
// cache; there is no stencil table.  A 64^3 grid is 1 MiB and a 128^3 grid
// 8 MiB, so the grid stays in the 50 MB L2.
//
// Loads.  The taps of one (z, y) row are the four x-neighbours.  row_taps
// <true> (the grid evaluation, K2) reads a row that is not clamped at the
// grid's x-edge with one or two aligned 16-byte loads when the grid's rows
// are 16-byte aligned (xres % 4 == 0 and an aligned base pointer, chosen
// per launch), other rows with four scalar loads: a point's load
// instructions drop from 64 to at most 32.  value_cached (the sphere trace,
// K1) keeps the last window's 64 taps in registers and reads them again
// only when the base voxel moves, with scalar loads, which measured faster
// there than wide ones (PERF.md).
//
// Order.  The contraction is separable: 16 independent 4-tap dot products
// along x, then 4 along y, then 1 along z, each a two-level tree.  A value
// is 147 flops of contraction with a dependent chain of about a dozen
// operations, where a sequential 64-term sum is a chain of 64 additions.
// The basis weights keep the plain version's operation order
// (ops/grid.py::bspline_weights; bit-equal where a source is compiled
// without FMA contraction, kernels.FMAD); the sums differ from the plain
// version's (torch.sum over the 64 products (wz * wy) * wx * tap) by
// rounding only.

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tricubic {

struct Grid {
    const float* __restrict__ data;  // (zres, yres, xres), contiguous
    int xres, yres, zres;
};

// True when rows can be read with aligned 16-byte loads.
inline bool rows_aligned(const void* data, int xres) {
    return xres % 4 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0;
}

// Base voxel of one axis, and its fraction f: c = p * res - 0.5, base =
// floor(c), f = c - base.  The base is clamped to [-4, res + 4] to keep the
// float -> int conversion in range (NaN maps to the low edge); the clamped
// tap indices are the same for any base outside the grid.
__device__ __forceinline__ int axis_base(float p, int res, float& f) {
    const float c = p * (float)res - 0.5f;
    const float base = floorf(c);
    f = c - base;
    return (int)fminf(fmaxf(base, -4.0f), (float)res + 4.0f);
}

// Index of tap k (offset k - 1 from the base), clamped to the grid.
__device__ __forceinline__ int tap_index(int base, int k, int res) {
    return min(max(base - 1 + k, 0), res - 1);
}

// Fraction f and the four clamped tap indices of one axis.
__device__ __forceinline__ float axis_taps(float p, int res, int idx[4]) {
    float f;
    const int base = axis_base(p, res, f);
#pragma unroll
    for (int k = 0; k < 4; ++k) idx[k] = tap_index(base, k, res);
    return f;
}

// Uniform cubic B-spline basis at taps {-1, 0, 1, 2}.
__device__ __forceinline__ void weights(float f, float w[4]) {
    const float sixth = 1.0f / 6.0f;
    const float f2 = f * f;
    const float f3 = f2 * f;
    const float one_m = 1.0f - f;
    w[0] = one_m * one_m * one_m * sixth;
    w[1] = (3.0f * f3 - 6.0f * f2 + 4.0f) * sixth;
    w[2] = (-3.0f * f3 + 3.0f * f2 + 3.0f * f + 1.0f) * sixth;
    w[3] = f3 * sixth;
}

// First derivative of the basis w.r.t. f.
__device__ __forceinline__ void dweights(float f, float dw[4]) {
    const float f2 = f * f;
    const float one_m = 1.0f - f;
    dw[0] = -0.5f * one_m * one_m;
    dw[1] = (3.0f * f2 - 4.0f * f) * 0.5f;
    dw[2] = (-3.0f * f2 + 2.0f * f + 1.0f) * 0.5f;
    dw[3] = 0.5f * f2;
}

__device__ __forceinline__ float dot4(const float a[4], const float w[4]) {
    return (a[0] * w[0] + a[1] * w[1]) + (a[2] * w[2] + a[3] * w[3]);
}

// The four x-taps of the row at (iz, iy).
template <bool kAligned>
__device__ __forceinline__ void row_taps(const Grid& g, int iz, int iy, const int ix[4], float t[4]) {
    // int64: a grid may exceed 2^31 voxels
    const float* row = g.data + ((long long)iz * g.yres + iy) * (long long)g.xres;
    if (kAligned && ix[3] == ix[0] + 3) {  // not clamped: four consecutive taps
        const int r = ix[0] & 3;
        const float4* q = reinterpret_cast<const float4*>(row + (ix[0] - r));
        const float4 a = __ldg(q);
        // the second float4 only when the taps cross into it (r > 0); then
        // it lies inside the row, since xres % 4 == 0 and ix[0] + 3 < xres
        const float4 b = r ? __ldg(q + 1) : a;
        const bool r1 = r & 1, r2 = r & 2;
        t[0] = r2 ? (r1 ? a.w : a.z) : (r1 ? a.y : a.x);
        t[1] = r2 ? (r1 ? b.x : a.w) : (r1 ? a.z : a.y);
        t[2] = r2 ? (r1 ? b.y : b.x) : (r1 ? a.w : a.z);
        t[3] = r2 ? (r1 ? b.z : b.y) : (r1 ? b.x : a.w);
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) t[k] = __ldg(row + ix[k]);
    }
}

// The 64 taps of the last window a thread read, kept in registers.  A ray's
// next step often stays in the same base voxel (every step near the
// surface is shorter than |f|), and then reads no memory at all.
struct TapCache {
    float t[64];  // [z][y][x]
    int bx, by, bz;  // base voxel of the window; bx = INT_MIN: empty
};

__device__ __forceinline__ void clear(TapCache& c) { c.bx = INT_MIN; }

// Makes the thread's tap cache hold the window of base voxel (bx, by, bz).
// A reload issues all 64 tap loads together, scalar: when no tap is
// clamped, at fixed strides from the window's first voxel, which saves the
// per-tap index arithmetic (measured 0.03-0.05 ms faster on the path's
// rays, PERF.md); otherwise at the clamped indices.
__device__ __forceinline__ void load_window(const Grid& g, int bx, int by, int bz, TapCache& c) {
    if (bx == c.bx && by == c.by && bz == c.bz) return;
    c.bx = bx;
    c.by = by;
    c.bz = bz;
    if (bx >= 1 && bx + 2 < g.xres && by >= 1 && by + 2 < g.yres && bz >= 1 && bz + 2 < g.zres) {
        // no tap clamped: the window is 4 x 4 rows of 4 at fixed strides
        // from its first voxel, and each load takes an immediate offset
        const long long sy = g.xres, sz = (long long)g.yres * g.xres;
        const float* p0 = g.data + (bz - 1) * sz + (by - 1) * sy + (bx - 1);
#pragma unroll
        for (int z = 0; z < 4; ++z) {
#pragma unroll
            for (int y = 0; y < 4; ++y) {
                const float* row = p0 + z * sz + y * sy;
#pragma unroll
                for (int x = 0; x < 4; ++x) c.t[(z * 4 + y) * 4 + x] = __ldg(row + x);
            }
        }
    } else {
        int ix[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) ix[k] = tap_index(bx, k, g.xres);
#pragma unroll
        for (int z = 0; z < 4; ++z) {
            const long long iz = tap_index(bz, z, g.zres);
#pragma unroll
            for (int y = 0; y < 4; ++y) {
                // int64: a grid may exceed 2^31 voxels
                const float* row = g.data + (iz * g.yres + tap_index(by, y, g.yres)) * (long long)g.xres;
#pragma unroll
                for (int x = 0; x < 4; ++x) c.t[(z * 4 + y) * 4 + x] = __ldg(row + ix[x]);
            }
        }
    }
}

// Value at the point (px, py, pz), already relative to the grid's origin,
// through the thread's tap cache.
__device__ __forceinline__ float value_cached(const Grid& g, float px, float py, float pz, TapCache& c) {
    float fx, fy, fz;
    const int bx = axis_base(px, g.xres, fx);
    const int by = axis_base(py, g.yres, fy);
    const int bz = axis_base(pz, g.zres, fz);
    load_window(g, bx, by, bz, c);
    float wx[4], wy[4], wz[4];
    weights(fx, wx);
    weights(fy, wy);
    weights(fz, wz);
    float sz[4];
#pragma unroll
    for (int z = 0; z < 4; ++z) {
        float sy[4];
#pragma unroll
        for (int y = 0; y < 4; ++y) sy[y] = dot4(&c.t[(z * 4 + y) * 4], wx);
        sz[z] = dot4(sy, wy);
    }
    return dot4(sz, wz);
}

// Value and gradient (w.r.t. the normalised point) at (px, py, pz), already
// relative to the grid's origin, through the thread's tap cache: the
// contraction of value_grad on the cached window (the Newton refinement of
// the sphere trace).
__device__ __forceinline__ float value_grad_cached(const Grid& g, float px, float py, float pz, TapCache& c,
                                                  float grad[3]) {
    float fx, fy, fz;
    const int bx = axis_base(px, g.xres, fx);
    const int by = axis_base(py, g.yres, fy);
    const int bz = axis_base(pz, g.zres, fz);
    load_window(g, bx, by, bz, c);
    float wx[4], wy[4], wz[4], dwx[4], dwy[4], dwz[4];
    weights(fx, wx);
    weights(fy, wy);
    weights(fz, wz);
    dweights(fx, dwx);
    dweights(fy, dwy);
    dweights(fz, dwz);
    float a[4], b[4], cc[4];
#pragma unroll
    for (int z = 0; z < 4; ++z) {
        float sx[4], sdx[4];
#pragma unroll
        for (int y = 0; y < 4; ++y) {
            sx[y] = dot4(&c.t[(z * 4 + y) * 4], wx);
            sdx[y] = dot4(&c.t[(z * 4 + y) * 4], dwx);
        }
        a[z] = dot4(sx, wy);
        b[z] = dot4(sx, dwy);
        cc[z] = dot4(sdx, wy);
    }
    grad[0] = dot4(cc, wz) * (float)g.xres;
    grad[1] = dot4(b, wz) * (float)g.yres;
    grad[2] = dot4(a, dwz) * (float)g.zres;
    return dot4(a, wz);
}

// Value and gradient (w.r.t. the normalised point) at (px, py, pz).
template <bool kAligned>
__device__ __forceinline__ float value_grad(const Grid& g, float px, float py, float pz, float grad[3]) {
    int ix[4], iy[4], iz[4];
    float wx[4], wy[4], wz[4], dwx[4], dwy[4], dwz[4];
    const float fx = axis_taps(px, g.xres, ix);
    const float fy = axis_taps(py, g.yres, iy);
    const float fz = axis_taps(pz, g.zres, iz);
    weights(fx, wx);
    weights(fy, wy);
    weights(fz, wz);
    dweights(fx, dwx);
    dweights(fy, dwy);
    dweights(fz, dwz);
    // per z: a = sum_y wy (sum_x wx t), b = sum_y dwy (sum_x wx t),
    // c = sum_y wy (sum_x dwx t)
    float a[4], b[4], c[4];
#pragma unroll
    for (int z = 0; z < 4; ++z) {
        float sx[4], sdx[4];
#pragma unroll
        for (int y = 0; y < 4; ++y) {
            float t[4];
            row_taps<kAligned>(g, iz[z], iy[y], ix, t);
            sx[y] = dot4(t, wx);
            sdx[y] = dot4(t, dwx);
        }
        a[z] = dot4(sx, wy);
        b[z] = dot4(sx, dwy);
        c[z] = dot4(sdx, wy);
    }
    grad[0] = dot4(c, wz) * (float)g.xres;
    grad[1] = dot4(b, wz) * (float)g.yres;
    grad[2] = dot4(a, dwz) * (float)g.zres;
    return dot4(a, wz);
}

}  // namespace tricubic
