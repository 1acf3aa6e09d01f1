// Detached cubic B-spline value and gradient of a dense (Z, Y, X) float32
// grid at N points: one thread per point.
//
// Replaces, for the port, the in-kernel tricubic tap gather that the JAX
// package explored in its Pallas probes: per-lane gathers from a table in
// fast memory (scripts/trace_probe_r3.py::probe_pgather, :421;
// scripts/gather_probe.py::dyn_gather, :206) and row gathers from device
// memory (scripts/trace_probe_r3.py::probe_pdma.run, :482;
// scripts/gather_probe.py::dma_rows, :262).  Those exist because a TPU core
// cannot gather per lane from HBM; a Hopper thread can, and the 64 taps of a
// point are read straight from the grid (L2-resident) through the read-only
// cache.  The function computed is ops/grid.py::grid_eval_grad (= _tap_setup
// + _jet_contract for the value and the three first-order terms), without a
// graph; its plain version is ops/grid.py::grid_eval_grad_detached_plain.
// The caller is the shading normal of ops/interaction.py::
// compute_surface_interaction on the detached (primal) path.
//
// What bounds it on an H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md
// has every number): per point 12 bytes in, 16 out
// and 453 flops in the separable order; at 2^21 points 0.018 ms of bytes
// (with the 1 MiB grid) against 0.014 ms of operations.  The first version
// (64 scalar loads and four sequential 64-term sums a point) took 0.225 ms
// on 2^21 points in random order, 0.169 ms on the same points in Morton
// order and 0.102 ms on the main path's own 1.1 M points in lane order
// (bound 0.0096 ms): sorting gained only a quarter, so the order of the
// benchmark's input was not what held it.  This version contracts
// separably (per row the x sums with wx and dwx, per z three y sums, then
// four z sums: value, d/dx, d/dy, d/dz) and reads each x-row with one or
// two aligned 16-byte loads (tricubic.cuh, row_taps<true>: when xres % 4 ==
// 0 and the grid pointer is 16-byte aligned, chosen per launch; rows
// clamped at the x-edge take four scalar loads).  The wide loads pay on
// scattered points (random order: 0.18 against 0.21-0.25 ms with scalar
// rows) and tie on the path's own points; what still holds it back is that
// a point's 16 rows are 16 lines of the grid, about 22 sectors of L2
// traffic a point when neighbours share none.
//
// Rounding: the basis weights are the plain version's; the sums are taken in
// the separable order, the plain version's as one 64-term torch.sum per
// output, so the two differ by rounding only (chip_smoke.py holds them to
// 1e-5 of the output's scale).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tricubic.cuh"

namespace {

constexpr int kThreads = 128;
// Resident blocks an SM must fit, which sets the register budget (128
// registers); 1 and 8 blocks measured no faster (PERF.md, PR 4).
constexpr int kMinBlocks = 4;

template <bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
grid_eval_grad_kernel(tricubic::Grid g, const float* __restrict__ origin, const float* __restrict__ p,
                      float* __restrict__ value, float* __restrict__ grad, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float px = p[3 * i + 0] - __ldg(origin + 0);
    const float py = p[3 * i + 1] - __ldg(origin + 1);
    const float pz = p[3 * i + 2] - __ldg(origin + 2);
    float gr[3];
    value[i] = tricubic::value_grad<kAligned>(g, px, py, pz, gr);
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
    const cudaStream_t s = (cudaStream_t)stream;
    if (tricubic::rows_aligned(grid, xres)) {
        grid_eval_grad_kernel<true><<<blocks, kThreads, 0, s>>>(
            g, (const float*)origin, (const float*)p, (float*)value, (float*)grad, n);
    } else {
        grid_eval_grad_kernel<false><<<blocks, kThreads, 0, s>>>(
            g, (const float*)origin, (const float*)p, (float*)value, (float*)grad, n);
    }
    return (int)cudaGetLastError();
}
