// Sphere tracing of rays against a cubic B-spline SDF grid, with the
// decreasing-rate intersection refinement: one thread per ray, the whole
// loop inside the kernel.
//
// Replaces, for the port, the in-kernel trace loop that the JAX package
// explored in the Pallas probe scripts/trace_probe_r3.py::probe_pallas.run
// (the whole sphere-trace loop in one program) together with the per-lane
// tap gathers of probe_pgather, probe_pdma.run and
// scripts/gather_probe.py::dyn_gather / dma_rows.  The JAX package itself
// traces with an XLA while-loop (ops/trace.py::sphere_trace + _refine); the
// port's plain version of this kernel is ops/trace.py::sphere_trace_plain,
// a masked Python loop that costs dozens of launches a step.
//
// Per ray (already normalised and clipped to the grid's expanded bounding
// box by the wrapper, which passes t0, maxt and trace_eps per lane):
//   loop up to max_steps: f = value(o + t d - origin) * step_scale;
//     hit when f < trace_eps (its_t = t); else t += |f|; stop when t > maxt;
//   then, for hit lanes with refine_active, up to refine_steps:
//     t += f * (10 / (10 + i)) until 0 < f <= trace_eps.
//
// What bounds it: each step is one 64-tap evaluation, 230 flops in the
// fewest-operation (separable) order (counted in chip_smoke.py), and 64 tap
// reads that hit L1/L2 (the grid is 1 MiB at 64^3, 8 MiB at 128^3); per ray
// the kernel reads 38 bytes and writes 8.  On the path's camera chunk (1.1 M
// rays of a bunny view at 128^2, 256 spp; most rays miss the box or leave it
// in a few steps: 4.4 evaluations a ray on average, refinement included, 192
// at most) the bound is 0.017 ms (operations, about tied with 0.016 ms of
// bytes) and the kernel takes 0.45-0.53 ms on an H100 80GB HBM3 at 700 W
// (chip_smoke.py, PERF.md), 27-32x the bound: a warp runs as long as its
// longest ray, and a few grazing rays that creep along the surface for all
// 192 steps hold their warps (the shadow rays of the same chunk: 1.1
// evaluations a ray on average, 0.62-0.69 ms against a bytes bound of 0.016
// ms).  One thread per ray is enough for a first version: the plain version
// takes 250-500 ms on the same rays, because it is bound by the host's launch
// rate.  Persistent threads with ray compaction, ray sorting and
// shared-memory bricks are later work.
//
// Rounding: compiled with -fmad=false; x = o + t*d, the weights and the step
// updates use the plain version's operation order (the refinement rate is
// (1 / (10 + i)) * 10, as PyTorch evaluates 10.0 / tensor).  Only the order
// of the 64-term sum differs, so a lane whose f lands within rounding of
// trace_eps may stop one step earlier or later than the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tricubic.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void sphere_trace_kernel(tricubic::Grid g, const float* __restrict__ origin,
                                    const float* __restrict__ o, const float* __restrict__ d,
                                    const float* __restrict__ t0, const float* __restrict__ maxt,
                                    const float* __restrict__ trace_eps,
                                    const uint8_t* __restrict__ active,
                                    const uint8_t* __restrict__ refine_active, float step_scale,
                                    int max_steps, int refine_steps, float* __restrict__ its_t,
                                    int* __restrict__ num_steps, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float gx = __ldg(origin + 0), gy = __ldg(origin + 1), gz = __ldg(origin + 2);
    const float ox = o[3 * i + 0], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i + 0], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float eps = trace_eps[i];
    const float tmax = maxt[i];

    float t = t0[i];
    float its = INFINITY;
    int steps = 0;
    if (active[i]) {
        for (int s = 0; s < max_steps; ++s) {
            const float px = (ox + t * dx) - gx;
            const float py = (oy + t * dy) - gy;
            const float pz = (oz + t * dz) - gz;
            const float f = tricubic::value(g, px, py, pz) * step_scale;
            steps = s + 1;
            if (f < eps) {
                its = t;
                break;
            }
            t = t + fabsf(f);
            if (!(t <= tmax)) break;
        }
    }

    int refined = 0;
    if (isfinite(its) && refine_steps > 0 && refine_active[i]) {
        float tr = its;
        for (int s = 0; s < refine_steps; ++s) {
            const float px = (ox + tr * dx) - gx;
            const float py = (oy + tr * dy) - gy;
            const float pz = (oz + tr * dz) - gz;
            const float f = tricubic::value(g, px, py, pz) * step_scale;
            const float rate = (1.0f / (10.0f + (float)s)) * 10.0f;
            tr = tr + f * rate;
            refined = s + 1;
            if (!(f <= 0.0f || f > eps)) break;  // converged into (0, eps]
        }
        its = tr;
    }
    its_t[i] = its;
    num_steps[i] = steps + refined;
}

}  // namespace

// Traces n rays.  o, d: (n, 3) float32 (d normalised); t0, maxt, trace_eps:
// (n,) float32; active, refine_active: (n,) uint8; grid: (zres, yres, xres)
// float32 contiguous; origin: 3 floats on the device (the grid's
// translation).  refine_steps = 0 skips the refinement.  Writes its_t (inf =
// miss) and num_steps (grid evaluations of the trace loop and the
// refinement together).  One launch on `stream`; nothing is allocated and nothing
// synchronises.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int sphere_trace_run(const void* grid, int xres, int yres, int zres,
                                const void* origin, const void* o, const void* d,
                                const void* t0, const void* maxt, const void* trace_eps,
                                const void* active, const void* refine_active, float step_scale,
                                int max_steps, int refine_steps, void* its_t, void* num_steps,
                                long long n, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    const tricubic::Grid g{(const float*)grid, xres, yres, zres};
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    sphere_trace_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        g, (const float*)origin, (const float*)o, (const float*)d, (const float*)t0,
        (const float*)maxt, (const float*)trace_eps, (const uint8_t*)active,
        (const uint8_t*)refine_active, step_scale, max_steps, refine_steps, (float*)its_t,
        (int*)num_steps, n);
    return (int)cudaGetLastError();
}
