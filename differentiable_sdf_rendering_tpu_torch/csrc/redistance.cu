// Eikonal redistancing of a level-set grid in one persistent launch: the
// interface setup, the Jacobi passes of the monotone Godunov upwind update,
// and the finishing sign * min(u, 2).
//
// Replaces the TPU kernel ops/pallas_redistance.py::redistance_pallas of the
// JAX package (body _kernel, pass _godunov_iteration, neighbour op
// _shift_min), and also the interface setup (ops/redistance.py::
// _interface_init) that the JAX package runs before it.  The TPU kernel keeps
// the whole grid in on-chip memory and loops over the passes inside one call.
// A Hopper block holds at most 227 KB of shared memory (a 64^3 fp32 grid is
// 1 MiB), and every pass reads every voxel of the previous one, so here the
// grid lives in two device buffers used in turn (at 64^3 and 128^3 they stay
// in the 50 MB L2) and the passes are separated by grid-wide barriers
// (cooperative_groups grid.sync()) inside one cooperative launch: a call is
// one CUDA launch whatever the size and pass count.
//
// Work: one thread per segment of a (y, x) column, x fastest so that a
// warp's loads are coalesced; the thread walks z and keeps u[z-1], u[z],
// u[z+1] in registers, so a voxel loads its four lateral neighbours and
// u[z+2].  The thread's coordinates are fixed for the whole call and computed
// once: no integer division in a pass.  Phase 0 writes -dist0 (frozen) or
// kBig into both buffers and kBig into their one-voxel halo; a frozen voxel
// is never written again, which is the plain version's where(frozen, dist0,
// .).  The last pass writes sign * min(u, 2) to the output instead of a
// buffer, with the sign read from phi.
//
// What bounds it (chip_smoke.py on an H100 80GB HBM3 at 700 W; PERF.md keeps
// the numbers): up to 64^3 the grid-wide barrier, about 1 us a pass at the
// launch's 128 blocks, plus the latency of a pass's loads and update; the
// host's part of a call (about 30-50 us of Python and launch) is as long as
// the kernel at 16^3.  At 128^3 and 256^3 the instructions of the update: the
// loop that updates a voxel is about 160 static SASS instructions, about 70 of
// them float (IEEE '/' and sqrtf expand to about 9 each, against the 47
// operations the bound counts); at 256^3 the two 68 MB buffers also stream
// from HBM every pass.  What the design does about it: one launch a call, no
// division in a pass, a halo instead of boundary tests, loads two voxels
// ahead, small grids spread over all SMs, and unreached voxels skipped.
//
// Rounding: this file is compiled with -fmad=false and without
// -use_fast_math, so a*b+c is not contracted into an FMA and sqrtf and '/'
// are IEEE-rounded.  The plain PyTorch version (ops/redistance.py::
// _interface_init and redistance_plain) performs the same operations in the
// same order, one rounding each, so the two agree bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e5f;
constexpr float kFar = 2.0f;
// At most one block of 1024 threads on each SM: a grid-wide barrier costs
// about 1 us with one block an SM and twice that with eight (PERF.md).
constexpr int kThreads = 1024;

// The pass buffers u0, u1 hold the grid with a one-voxel halo of kBig on
// every side, so that a neighbour beyond the grid reads kBig without a test.
// A frozen voxel holds -dist0 in both and is never written again (u is
// positive everywhere, and |x| is a free operand modifier of FMNMX).
struct Params {
    const float* phi;
    float* u0;
    float* u1;
    float* out;
    int nz, ny, nx;
    int iterations;
    int seg_len;        // z voxels of one work item
    unsigned items;     // work items: ceil(nz / seg_len) * ny * nx
    float h[3];         // spacing per axis (z, y, x), float32 1/n
    float d_min[3];     // float32(0.01 * h), the guard of exact-zero voxels
};

// One axis neighbour of the interface setup: adds 1/d^2 to inv_d2 and sets
// frozen where phi changes sign towards it (plain: _interface_init).
__device__ __forceinline__ void interface_term(float c, bool pos, bool valid, float nb, float h, float d_min,
                                               float& inv_d2, bool& frozen) {
    if (!valid || (nb >= 0.0f) == pos) return;
    const float denom = fabsf(c - nb);
    float d = h * fabsf(c) / fmaxf(denom, 1e-12f);
    d = fmaxf(d, d_min);
    inv_d2 = inv_d2 + 1.0f / (d * d);
    frozen = true;
}

// sqrtf(fmaxf(x, 0)), with the clamped case selected: sqrtf sends an argument
// of 0 to its slow-path subroutine, and a clamped discriminant is common.
__device__ __forceinline__ float sqrt_clamped(float x) { return x > 0.0f ? sqrtf(x) : 0.0f; }

// New value of one voxel from its axis-neighbour minima a (z), b (y), c (x):
// solve sum_i max((u - a_i)/h_i, 0)^2 = 1 over the first 1, 2, 3 sorted axes.
template <bool kUniform>
__device__ __forceinline__ float godunov_solve(float a, float b, float c, const Params& p) {
    if (kUniform) {
        // three-element sorting network a1 <= a2 <= a3
        const float lo = fminf(a, b);
        const float hi = fmaxf(a, b);
        const float a1 = fminf(lo, c);
        const float a3 = fmaxf(hi, c);
        const float a2 = a + b + c - a1 - a3;
        const float h = p.h[2];
        const float u1 = a1 + h;
        const float w = 1.0f / (h * h);
        const float s12 = 2.0f * w;
        const float m12 = (a1 + a2) * 0.5f;
        const float q12 = (w * (a1 * a1 + a2 * a2) - 1.0f) / s12;
        const float u2 = m12 + sqrt_clamped(m12 * m12 - q12);
        const float s123 = 3.0f * w;
        const float m123 = (a1 + a2 + a3) / 3.0f;
        const float q123 = (w * (a1 * a1 + a2 * a2 + a3 * a3) - 1.0f) / s123;
        const float u3 = m123 + sqrt_clamped(m123 * m123 - q123);
        return (u1 <= a2) ? u1 : ((u2 <= a3) ? u2 : u3);
    }
    // per-axis spacing: sort (value, spacing) pairs as argsort(stable=True)
    // does, so that ties keep the z, y, x order
    float v0 = a, v1 = b, v2 = c;
    float h0 = p.h[0], h1 = p.h[1], h2 = p.h[2];
    float t;
    if (v1 < v0) { t = v0; v0 = v1; v1 = t; t = h0; h0 = h1; h1 = t; }
    if (v2 < v1) { t = v1; v1 = v2; v2 = t; t = h1; h1 = h2; h2 = t; }
    if (v1 < v0) { t = v0; v0 = v1; v1 = t; t = h0; h0 = h1; h1 = t; }
    const float u1 = v0 + h0;
    const float w1 = 1.0f / (h0 * h0);
    const float w2 = 1.0f / (h1 * h1);
    const float s12 = w1 + w2;
    const float m12 = (w1 * v0 + w2 * v1) / s12;
    const float q12 = (w1 * v0 * v0 + w2 * v1 * v1 - 1.0f) / s12;
    const float u2 = m12 + sqrt_clamped(m12 * m12 - q12);
    const float w3 = 1.0f / (h2 * h2);
    const float s123 = s12 + w3;
    const float m123 = (w1 * v0 + w2 * v1 + w3 * v2) / s123;
    const float q123 = (w1 * v0 * v0 + w2 * v1 * v1 + w3 * v2 * v2 - 1.0f) / s123;
    const float u3 = m123 + sqrt_clamped(m123 * m123 - q123);
    return (u1 <= v1) ? u1 : ((u2 <= v2) ? u2 : u3);
}

__device__ __forceinline__ void decode(unsigned item, const Params& p, int& x, int& y, int& z0) {
    x = (int)(item % (unsigned)p.nx);
    const unsigned t = item / (unsigned)p.nx;
    y = (int)(t % (unsigned)p.ny);
    z0 = (int)(t / (unsigned)p.ny) * p.seg_len;
}

// Phase 0 on one column segment: -dist0 (frozen) or kBig into both pass
// buffers, kBig into the halo cells next to the segment, and the output
// directly when there are no passes.
__device__ void interface_segment(const Params& p, int x, int y, int z0) {
    const long long sy = p.nx, sz = (long long)p.nx * p.ny;
    const long long psy = p.nx + 2, psz = (long long)(p.ny + 2) * (p.nx + 2);
    const int z1 = min(z0 + p.seg_len, p.nz);
    auto set = [&](long long j, float v) { p.u0[j] = p.u1[j] = v; };
    long long i = z0 * sz + y * sy + x;
    long long pi = (z0 + 1) * psz + (y + 1) * psy + x + 1;
    if (z0 == 0) set(pi - psz, kBig);
    if (z1 == p.nz) set(pi + (z1 - z0) * psz, kBig);
    float below = z0 > 0 ? p.phi[i - sz] : 0.0f;
    float c = p.phi[i];
    for (int z = z0; z < z1; ++z, i += sz, pi += psz) {
        const float above = z + 1 < p.nz ? p.phi[i + sz] : 0.0f;
        const bool pos = c >= 0.0f;
        float inv_d2 = 0.0f;
        bool frozen = false;
        // axes z, y, x; in each the neighbour i + 1 before i - 1
        interface_term(c, pos, z + 1 < p.nz, above, p.h[0], p.d_min[0], inv_d2, frozen);
        interface_term(c, pos, z > 0, below, p.h[0], p.d_min[0], inv_d2, frozen);
        interface_term(c, pos, y + 1 < p.ny, y + 1 < p.ny ? p.phi[i + sy] : 0.0f, p.h[1], p.d_min[1], inv_d2,
                       frozen);
        interface_term(c, pos, y > 0, y > 0 ? p.phi[i - sy] : 0.0f, p.h[1], p.d_min[1], inv_d2, frozen);
        interface_term(c, pos, x + 1 < p.nx, x + 1 < p.nx ? p.phi[i + 1] : 0.0f, p.h[2], p.d_min[2], inv_d2,
                       frozen);
        interface_term(c, pos, x > 0, x > 0 ? p.phi[i - 1] : 0.0f, p.h[2], p.d_min[2], inv_d2, frozen);
        const float dist0 = frozen ? 1.0f / sqrtf(fmaxf(inv_d2, 1e-20f)) : kBig;
        set(pi, frozen ? -dist0 : dist0);
        if (y == 0) set(pi - psy, kBig);
        if (y == p.ny - 1) set(pi + psy, kBig);
        if (x == 0) set(pi - 1, kBig);
        if (x == p.nx - 1) set(pi + 1, kBig);
        if (p.iterations == 0) p.out[i] = (pos ? 1.0f : -1.0f) * fminf(dist0, kFar);
        below = c;
        c = above;
    }
}

// One Jacobi pass on one column segment, reading src and writing dst (in
// the last pass: sign * min(u, 2) to the output).  A thread walks many
// voxels in turn, so it loads two voxels ahead: the loads of voxel z + 2 are
// issued before the update of voxel z, and their latency overlaps two
// updates.  Strides are 32-bit (a padded (y, x) slice holds fewer than 2^31
// voxels), so an address is one IMAD.WIDE.
template <bool kUniform, bool kLast>
__device__ __forceinline__ void pass_segment(const Params& p, const float* src, float* dst, int x, int y, int z0) {
    const int sy = p.nx + 2, sz = (p.ny + 2) * (p.nx + 2);
    const int z1 = min(z0 + p.seg_len, p.nz);
    const long long pi0 = (long long)(z0 + 1) * sz + (long long)(y + 1) * sy + x + 1;
    const float* q = src + pi0;
    float* d = dst + pi0;
    const int osz = p.nx * p.ny;
    long long i = ((long long)z0 * p.ny + y) * p.nx + x;
    // raw values (negative: frozen) of voxels z - 1 .. z + 2 of the column,
    // and the minima of the y and x neighbours of voxels z and z + 1
    float below = q[-sz], cur = q[0], above = q[sz], above2 = 0.0f;
    float b0 = fminf(fabsf(q[sy]), fabsf(q[-sy])), cx0 = fminf(fabsf(q[1]), fabsf(q[-1]));
    float b1 = 0.0f, cx1 = 0.0f;
    if (z0 + 1 < z1) {
        const float* q1 = q + sz;
        above2 = q1[sz];
        b1 = fminf(fabsf(q1[sy]), fabsf(q1[-sy]));
        cx1 = fminf(fabsf(q1[1]), fabsf(q1[-1]));
    }
    const float* q2 = q + 2 * sz;  // voxel z + 2, one plane up each step
    for (int z = z0;; ++z) {
        float above3 = 0.0f, b2 = 0.0f, cx2 = 0.0f;
        if (z + 2 < z1) {
            above3 = q2[sz];
            b2 = fminf(fabsf(q2[sy]), fabsf(q2[-sy]));
            cx2 = fminf(fabsf(q2[1]), fabsf(q2[-1]));
        }
        // min(u[i+1], u[i-1]) along z (b0 and cx0: along y and x)
        const float a = fminf(fabsf(above), fabsf(below));
        // An unreached voxel whose neighbours are all unreached stays kBig: on
        // a uniform grid every candidate is >= kBig after rounding (u1 = kBig
        // + h, m12 = m123 = kBig exactly), and the buffer it would be written
        // to holds kBig already (u only decreases).
        const bool unreached = kUniform && cur == kBig && a == kBig && b0 == kBig && cx0 == kBig;
        if (unreached) {
            if (kLast) p.out[i] = (p.phi[i] >= 0.0f ? 1.0f : -1.0f) * kFar;
        } else if (cur >= 0.0f) {
            const float v = fminf(cur, godunov_solve<kUniform>(a, b0, cx0, p));
            if (kLast) {
                p.out[i] = (p.phi[i] >= 0.0f ? 1.0f : -1.0f) * fminf(v, kFar);
            } else {
                *d = v;
            }
        } else if (kLast) {
            p.out[i] = (p.phi[i] >= 0.0f ? 1.0f : -1.0f) * fminf(-cur, kFar);
        }
        if (z + 1 >= z1) break;
        below = cur;
        cur = above;
        above = above2;
        above2 = above3;
        b0 = b1;
        cx0 = cx1;
        b1 = b2;
        cx1 = cx2;
        q2 += sz;
        d += sz;
        i += osz;
    }
}

template <bool kUniform, bool kLast>
__device__ __forceinline__ void pass(const Params& p, int k, unsigned first, unsigned stride, int x0, int y0,
                                     int z00) {
    const float* src = (k & 1) ? p.u1 : p.u0;
    float* dst = (k & 1) ? p.u0 : p.u1;
    for (unsigned item = first; item < p.items; item += stride) {
        int x = x0, y = y0, z0 = z00;
        if (item != first) decode(item, p, x, y, z0);
        pass_segment<kUniform, kLast>(p, src, dst, x, y, z0);
    }
}

template <bool kUniform>
__global__ void __launch_bounds__(kThreads, 1) redistance_kernel(Params p) {
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    const unsigned stride = gridDim.x * blockDim.x;
    const unsigned first = blockIdx.x * blockDim.x + threadIdx.x;
    int x0 = 0, y0 = 0, z00 = 0;
    if (first < p.items) decode(first, p, x0, y0, z00);

    for (unsigned item = first; item < p.items; item += stride) {
        int x = x0, y = y0, z0 = z00;
        if (item != first) decode(item, p, x, y, z0);
        interface_segment(p, x, y, z0);
    }
    for (int k = 0; k < p.iterations; ++k) {
        grid.sync();
        if (k + 1 < p.iterations) {
            pass<kUniform, false>(p, k, first, stride, x0, y0, z00);
        } else {
            pass<kUniform, true>(p, k, first, stride, x0, y0, z00);
        }
    }
}

__global__ void barrier_probe_kernel(int syncs) {
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    for (int i = 0; i < syncs; ++i) grid.sync();
}

// The launch of a (nz, ny, nx) grid: blocks of at most kThreads threads, no
// more than fit on the card at once (a cooperative launch needs them all
// resident), and the z length of a work item, the shortest that gives every
// thread at most one item where the columns allow it.
cudaError_t launch_shape(int nz, int ny, int nx, int* blocks, int* threads, int* seg_len, unsigned* items) {
    // SM count and blocks an SM of each instantiation, per device, queried once
    constexpr int kMaxDevices = 64;
    static int sms_of[kMaxDevices], per_sm_of[kMaxDevices][2];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    const bool uniform = nz == ny && ny == nx;
    int& per_sm = per_sm_of[dev][uniform];
    if (sms_of[dev] == 0) err = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess && per_sm == 0)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, uniform ? redistance_kernel<true> : redistance_kernel<false>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    const long long slots = (long long)sms_of[dev] * per_sm;
    const long long cols = (long long)ny * nx;
    if ((long long)(ny + 2) * (nx + 2) > 0x7fffffffLL) return cudaErrorInvalidValue;
    const long long fit = slots * kThreads / cols;
    const long long segs = fit < 1 ? 1 : (fit < nz ? fit : nz);
    *seg_len = (int)((nz + segs - 1) / segs);
    const long long n_items = (long long)((nz + *seg_len - 1) / *seg_len) * cols;
    if (n_items > 0xffffffffLL) return cudaErrorInvalidValue;
    *items = (unsigned)n_items;
    // a grid that fills fewer than all SMs at kThreads a block is spread over
    // all of them in smaller blocks (a multiple of a warp)
    const long long sms = sms_of[dev];
    *threads = n_items >= sms * kThreads ? kThreads : (int)(((n_items + sms - 1) / sms + 31) / 32 * 32);
    *blocks = (int)((n_items + *threads - 1) / *threads < slots ? (n_items + *threads - 1) / *threads : slots);
    return cudaSuccess;
}

}  // namespace

// Redistances phi (nz, ny, nx, contiguous fp32) with `iterations` passes
// into out.  scratch is caller-provided, 2 * (nz+2)*(ny+2)*(nx+2) floats:
// the two padded pass buffers.  One cooperative launch on
// `stream`; nothing is allocated and nothing synchronises.  Adds the
// launches it makes (1, or 0 for an empty grid) to *launched.  Returns the
// CUDA error of the launch (0 = success); a launch the card refuses returns
// its error.
extern "C" int redistance_run(const void* phi, void* scratch, void* out, int nz, int ny, int nx, int iterations,
                              void* stream, int* launched) {
    if ((long long)nz * ny * nx == 0) return (int)cudaSuccess;
    Params p;
    p.phi = (const float*)phi;
    const long long padded = (long long)(nz + 2) * (ny + 2) * (nx + 2);
    p.u0 = (float*)scratch;
    p.u1 = p.u0 + padded;
    p.out = (float*)out;
    p.nz = nz;
    p.ny = ny;
    p.nx = nx;
    p.iterations = iterations < 0 ? 0 : iterations;
    const int dims[3] = {nz, ny, nx};
    for (int k = 0; k < 3; ++k) {
        p.h[k] = 1.0f / (float)dims[k];
        p.d_min[k] = (float)(1e-2 * (double)p.h[k]);
    }
    int blocks = 0, threads = 0;
    cudaError_t err = launch_shape(nz, ny, nx, &blocks, &threads, &p.seg_len, &p.items);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&p};
    const bool uniform = nz == ny && ny == nx;
    err = cudaLaunchCooperativeKernel(uniform ? (const void*)redistance_kernel<true>
                                              : (const void*)redistance_kernel<false>,
                                      dim3(blocks), dim3(threads), args, 0, (cudaStream_t)stream);
    ++*launched;
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The launch redistance_run makes for a (nz, ny, nx) grid: *blocks blocks of
// *threads threads, work items of *seg_len z voxels.  Returns a CUDA error.
extern "C" int redistance_launch_shape(int nz, int ny, int nx, int* blocks, int* threads, int* seg_len) {
    unsigned items = 0;
    return (int)launch_shape(nz, ny, nx, blocks, threads, seg_len, &items);
}

// Diagnostic: one cooperative launch of `blocks` blocks of `threads` threads
// that runs `syncs` grid-wide barriers and nothing else.  Returns the
// launch's CUDA error (0 = success).
extern "C" int redistance_barrier_probe(int blocks, int threads, int syncs, void* stream) {
    void* args[] = {&syncs};
    const cudaError_t err = cudaLaunchCooperativeKernel((const void*)barrier_probe_kernel, dim3(blocks),
                                                        dim3(threads), args, 0, (cudaStream_t)stream);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
