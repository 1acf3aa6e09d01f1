// Eikonal redistancing of a cubic level-set grid: Jacobi passes of the
// monotone Godunov upwind update.
//
// Replaces the TPU kernel ops/pallas_redistance.py::redistance_pallas of the
// JAX package (body _kernel, pass _godunov_iteration, neighbour op
// _shift_min).  That kernel keeps the whole grid resident in on-chip memory
// and loops over the passes inside one call.  A Hopper block has at most
// 227 KB of shared memory (a 64^3 fp32 grid is 1 MiB) and every pass needs
// every voxel of the previous pass, i.e. a grid-wide barrier between passes.
// Here the barrier is the kernel boundary: one launch per pass, two `u`
// buffers used in turn, one thread per voxel with x fastest so that the
// loads and the store of a warp are coalesced.  The six neighbour loads come
// from global memory; the boundary is handled by index tests, not by a
// padded copy.
//
// What bounds it: at 64^3 a call is 64 pass launches plus one finishing
// launch over a working set of about 4 MiB (two u buffers, dist0, frozen)
// that stays in the 50 MB L2.  Each pass moves R^3 * (4 + 4 + 1 + 4) bytes
// (u in, dist0, frozen, u out) and does a few dozen flops per voxel, both
// far below what the card can sustain, so the call is bound by launch
// latency (R + 1 back-to-back launches), not by bandwidth or arithmetic.
// Measured by chip_smoke.py on an H100 80GB HBM3 at a 700 W power limit: a
// call at 64^3 makes 65 launches (counted by redistance_run) and takes 0.34
// to 0.42 ms over five runs, i.e. 5.2 to 6.4 us a launch; 4.4 to 10.8 us a
// launch at 16^3 and 32^3, following the host's launch rate; only at 128^3
// (21 to 23 us a pass) does memory traffic show.  PERF.md keeps the
// table.  One persistent cooperative launch with grid.sync(), or
// a captured CUDA graph, would remove that latency.
//
// Rounding: this file is compiled with -fmad=false and without
// -use_fast_math, so a*b+c is not contracted into an FMA and sqrtf and '/'
// are IEEE-rounded.  The plain PyTorch version (ops/redistance.py::
// redistance_plain) performs the same operations in the same order, one
// rounding each, so the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e5f;
constexpr float kFar = 2.0f;
constexpr int kThreads = 256;

__device__ __forceinline__ float neighbour_min(const float* __restrict__ u, long long idx,
                                               int i, int R, long long stride) {
    // min(u[i-1], u[i+1]) along one axis with kBig beyond the boundary
    const float fwd = (i + 1 < R) ? u[idx + stride] : kBig;
    const float bwd = (i > 0) ? u[idx - stride] : kBig;
    return fminf(fwd, bwd);
}

__global__ void godunov_pass_kernel(const float* __restrict__ u_in,
                                    const float* __restrict__ dist0,
                                    const uint8_t* __restrict__ frozen,
                                    float* __restrict__ u_out, int R, float h) {
    const long long n = (long long)R * R * R;
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    if (frozen[idx]) {
        u_out[idx] = dist0[idx];
        return;
    }
    const int x = (int)(idx % R);
    const int y = (int)((idx / R) % R);
    const int z = (int)(idx / ((long long)R * R));

    const float a = neighbour_min(u_in, idx, z, R, (long long)R * R);
    const float b = neighbour_min(u_in, idx, y, R, R);
    const float c = neighbour_min(u_in, idx, x, R, 1);

    // three-element sorting network a1 <= a2 <= a3
    const float lo = fminf(a, b);
    const float hi = fmaxf(a, b);
    const float a1 = fminf(lo, c);
    const float a3 = fmaxf(hi, c);
    const float a2 = a + b + c - a1 - a3;

    // solve sum_i max((u - a_i)/h, 0)^2 = 1 over the first 1, 2, 3 axes
    const float u1 = a1 + h;
    const float w = 1.0f / (h * h);
    const float s12 = 2.0f * w;
    const float m12 = (a1 + a2) * 0.5f;
    const float q12 = (w * (a1 * a1 + a2 * a2) - 1.0f) / s12;
    const float u2 = m12 + sqrtf(fmaxf(m12 * m12 - q12, 0.0f));
    const float s123 = 3.0f * w;
    const float m123 = (a1 + a2 + a3) / 3.0f;
    const float q123 = (w * (a1 * a1 + a2 * a2 + a3 * a3) - 1.0f) / s123;
    const float u3 = m123 + sqrtf(fmaxf(m123 * m123 - q123, 0.0f));

    const float unew = (u1 <= a2) ? u1 : ((u2 <= a3) ? u2 : u3);
    u_out[idx] = fminf(u_in[idx], unew);
}

__global__ void finish_kernel(const float* __restrict__ u, const float* __restrict__ sign,
                              float* __restrict__ out, long long n) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    out[idx] = sign[idx] * fminf(u[idx], kFar);
}

}  // namespace

// Runs `iterations` Jacobi passes from dist0 and writes sign * min(u, 2) to
// `out`.  u_a and u_b are caller-provided scratch grids of R^3 floats.  All
// launches go to `stream`; nothing is allocated and nothing synchronises.
// Every kernel launch made here adds one to *launched (a host counter of the
// caller).  Returns cudaGetLastError() after the launches (0 = success).
extern "C" int redistance_run(const void* dist0, const void* frozen, const void* sign,
                              void* u_a, void* u_b, void* out, int R, int iterations,
                              void* stream, int* launched) {
    const long long n = (long long)R * R * R;
    if (n == 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    const float h = 1.0f / (float)R;

    const float* src = (const float*)dist0;
    float* bufs[2] = {(float*)u_a, (float*)u_b};
    for (int it = 0; it < iterations; ++it) {
        float* dst = bufs[it & 1];
        godunov_pass_kernel<<<blocks, kThreads, 0, st>>>(
            src, (const float*)dist0, (const uint8_t*)frozen, dst, R, h);
        ++*launched;
        src = dst;
    }
    finish_kernel<<<blocks, kThreads, 0, st>>>(src, (const float*)sign, (float*)out, n);
    ++*launched;
    return (int)cudaGetLastError();
}
