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
// cache (__ldg); there is no stencil table.  A 64^3 grid is 1 MiB and a
// 128^3 grid 8 MiB, so the grid stays in the 50 MB L2 and a tap read is an
// L2 hit, not an HBM transfer.
//
// Rounding: every source that includes this file is compiled with
// -fmad=false, and each expression below is written in the operation order
// of the plain PyTorch version (ops/grid.py::bspline_weights, the weight
// product (wz * wy) * wx), so the basis weights are bit-equal to the plain
// version's.  The 64-term sum is taken sequentially here and as a tree
// reduction by torch.sum, so the results differ by rounding only.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tricubic {

struct Grid {
    const float* __restrict__ data;  // (zres, yres, xres), contiguous
    int xres, yres, zres;
};

// Fraction f and the four clamped tap indices of one axis.
__device__ __forceinline__ float axis_taps(float p, int res, int idx[4]) {
    const float c = p * (float)res - 0.5f;
    const float base = floorf(c);
    const float f = c - base;
    // keep the float -> int conversion in range (NaN maps to the low edge);
    // the clamp below gives the same indices for any base outside the grid
    const int ib = (int)fminf(fmaxf(base, -4.0f), (float)res + 4.0f);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        idx[k] = min(max(ib - 1 + k, 0), res - 1);
    }
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

__device__ __forceinline__ const float* row_ptr(const Grid& g, int iz, int iy) {
    // int64: a grid may exceed 2^31 voxels
    return g.data + ((long long)iz * g.yres + iy) * (long long)g.xres;
}

// Value at the point (px, py, pz), already relative to the grid's origin.
__device__ __forceinline__ float value(const Grid& g, float px, float py, float pz) {
    int ix[4], iy[4], iz[4];
    float wx[4], wy[4], wz[4];
    weights(axis_taps(px, g.xres, ix), wx);
    weights(axis_taps(py, g.yres, iy), wy);
    weights(axis_taps(pz, g.zres, iz), wz);
    float acc = 0.0f;
#pragma unroll
    for (int z = 0; z < 4; ++z) {
#pragma unroll
        for (int y = 0; y < 4; ++y) {
            const float* row = row_ptr(g, iz[z], iy[y]);
            const float wzy = wz[z] * wy[y];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                acc = acc + __ldg(row + ix[x]) * (wzy * wx[x]);
            }
        }
    }
    return acc;
}

// Value and gradient (w.r.t. the normalised point) at (px, py, pz).
__device__ __forceinline__ float value_grad(const Grid& g, float px, float py, float pz,
                                            float grad[3]) {
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
    float v = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
#pragma unroll
    for (int z = 0; z < 4; ++z) {
#pragma unroll
        for (int y = 0; y < 4; ++y) {
            const float* row = row_ptr(g, iz[z], iy[y]);
            const float w_zy = wz[z] * wy[y];    // value and d/dx
            const float w_zdy = wz[z] * dwy[y];  // d/dy
            const float w_dzy = dwz[z] * wy[y];  // d/dz
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                const float tap = __ldg(row + ix[x]);
                v = v + tap * (w_zy * wx[x]);
                gx = gx + tap * (w_zy * dwx[x]);
                gy = gy + tap * (w_zdy * wx[x]);
                gz = gz + tap * (w_dzy * wx[x]);
            }
        }
    }
    grad[0] = gx * (float)g.xres;
    grad[1] = gy * (float)g.yres;
    grad[2] = gz * (float)g.zres;
    return v;
}

}  // namespace tricubic
