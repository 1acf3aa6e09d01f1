// Detached cubic B-spline value and gradient of a dense (Z, Y, X) float32
// grid at N points: one thread per point.
//
// Replaces, for the port, the in-kernel tricubic tap gather that the JAX
// package explored in its Pallas probes: per-lane gathers from a table in
// fast memory (scripts/trace_probe_r3.py::probe_pgather,
// scripts/gather_probe.py::dyn_gather) and row gathers from device memory
// (scripts/trace_probe_r3.py::probe_pdma.run,
// scripts/gather_probe.py::dma_rows).  Those exist because a TPU core cannot
// gather per lane from HBM; a Hopper thread can, and the 64 taps of a point
// are read straight from the grid (L2-resident) through the read-only cache.
// The function computed is ops/grid.py::grid_eval_grad (= _tap_setup +
// _jet_contract for the value and the three first-order terms), without a
// graph; its plain version is ops/grid.py::grid_eval_grad_detached_plain.
// The caller is the shading normal of ops/interaction.py::
// compute_surface_interaction on the detached (primal) path.
//
// What bounds it: per point 64 tap reads (L1/L2 hits) and 453 flops in the
// fewest-operation (separable) order (counted in chip_smoke.py), against 12
// bytes in and 16 bytes out.  At 2^21 points that is 0.95 GFLOP (0.014 ms at
// 67 TFLOP/s fp32) and 60 MB with the grid (0.018 ms at 3.35 TB/s): the
// bound is the bytes.  Measured on an H100 80GB HBM3 at 700 W: 0.21-0.26 ms
// (chip_smoke.py, PERF.md), 12-15x the bound; the plain version 10 ms.
// One thread per point with no shared memory is enough here because every
// point costs the same (no trip-count skew) and neighbouring points of a ray
// wavefront share taps in L1.
//
// Rounding: see tricubic.cuh (-fmad=false, the plain version's weight
// products; only the order of the 64-term sums differs).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tricubic.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void grid_eval_grad_kernel(tricubic::Grid g, const float* __restrict__ origin,
                                      const float* __restrict__ p, float* __restrict__ value,
                                      float* __restrict__ grad, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float px = p[3 * i + 0] - __ldg(origin + 0);
    const float py = p[3 * i + 1] - __ldg(origin + 1);
    const float pz = p[3 * i + 2] - __ldg(origin + 2);
    float gr[3];
    value[i] = tricubic::value_grad(g, px, py, pz, gr);
    grad[3 * i + 0] = gr[0];
    grad[3 * i + 1] = gr[1];
    grad[3 * i + 2] = gr[2];
}

}  // namespace

// Evaluates n points p: (n, 3) float32, relative to origin (3 floats on the
// device), on the grid (zres, yres, xres) float32 contiguous.  Writes value
// (n,) and grad (n, 3).  One launch on `stream`; nothing is allocated and
// nothing synchronises.  Returns cudaGetLastError() after the launch.
extern "C" int grid_eval_grad_run(const void* grid, int xres, int yres, int zres,
                                  const void* origin, const void* p, void* value, void* grad,
                                  long long n, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    const tricubic::Grid g{(const float*)grid, xres, yres, zres};
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    grid_eval_grad_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        g, (const float*)origin, (const float*)p, (float*)value, (float*)grad, n);
    return (int)cudaGetLastError();
}
