// Sphere tracing of rays against an SDF (a cubic B-spline grid, the
// analytic sphere or the smooth box), with the decreasing-rate or the
// guarded Newton intersection refinement and optional over-relaxed steps:
// the ray setup, the whole loop and the refinement inside one kernel of
// persistent blocks whose lanes take a new ray whenever theirs ends.
//
// Replaces, for the port, the in-kernel trace loop that the JAX package
// explored in the Pallas probe scripts/trace_probe_r3.py::probe_pallas.run
// (:360; the whole sphere-trace loop in one program, on an analytic sphere:
// sdf_kind 1 below traces the same sphere) together with the per-lane tap
// gathers of probe_pgather, probe_pdma.run and scripts/gather_probe.py::
// dyn_gather / dma_rows.  The JAX package itself traces with an XLA
// while-loop (ops/trace.py::sphere_trace + _refine); the port's plain
// version of this kernel is ops/trace.py::sphere_trace_plain, a masked
// Python loop that costs dozens of launches a step.
//
// Per ray i, as ops/trace.py::_ray_setup and the plain loops compute it:
//   d = normalize(d); clip to the SDF's bbox expanded by bbox_expand (the
//   box computed here from the SDF's device parameters, as SDF.bbox does);
//   t0 = 0 inside the box, else entry + 1e-5; maxt = min(exit, maxt);
//   eps = trace_eps * max(maxt, 1); traced only when active & hit;
//   loop up to max_steps: f = sdf(o + t d) * step_scale;
//     hit when f < eps (its_t = t); else t += |f|; stop when t > maxt;
//   then, for hit rays with refine_active, up to refine_steps:
//     t += f * (10 / (10 + s)) until 0 < f <= eps.
// The trace options of ops/trace.py, switched on by launch-wide
// parameters (every lane takes the same branch):
//   over_relax w in (1, 2): step w |f|; when the unbounding spheres of two
//     steps stop overlapping (|f| + previous |f| < previous step) the lane
//     steps back by (1 - w) * step and goes on at w = 1; a retreat is never
//     a hit, and the lane stops on the conservative t + |f| > maxt;
//   refine 'newton': t += (f - eps / 2) * min(-1 / (d . grad f), 4) where
//     d . grad f < -0.25, else at the fixed rate; the same stopping band.
//   The gradient comes from the same tap window as the value (grid), or in
//   closed form (sphere, box).
//
// What bounds it, on an H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md
// has every number, with those of PR 4's tuning builds).  The work is
// small: on the path's camera chunk (1.1 M rays of a bunny view at 128^2,
// 256 spp; 92 % miss the box) 4.9 M evaluations, 230 flops each in the
// separable order, 0.017 ms at 67 TFLOP/s; the bytes (rays in, its_t out)
// are less.  On the shadow rays (a quarter of the evaluations: 0.010 ms at
// 64^3, 0.012 ms at 128^3) and the analytic sphere (0.0022 ms) the bytes
// bound it.  The first version (one thread a ray, the setup in ~15 PyTorch
// launches around it) took 0.47 ms there and 0.64 ms on the shadow rays of
// the same lanes, which do a quarter of the evaluations: a block held its
// SM slot until its slowest ray ended.  This version:
//   * persistent blocks, refilled per lane: as many blocks as are resident;
//     a warp claims rays 32 at a time from a global counter (lane 0 claims
//     one chunk ahead, so the atomic's latency is spent tracing), and once
//     kRefillMin of its lanes are idle it refills them in rounds in which
//     all 32 lanes set up one candidate each and the idle lanes take the
//     traced ones through shuffles (92 % of camera rays miss the box: a
//     round sets up 32 of them at once);
//   * a short step: the separable contraction of tricubic.cuh, the 64 taps
//     of the last window kept in registers (a step that stays in its base
//     voxel reads no memory), a reload's 64 loads issued together, at fixed
//     strides from the window's first voxel when no tap is clamped;
//   * the ray setup in the kernel: scalar maxt / active / refine_active come
//     as values, per-lane ones with a stride, so a call is this launch and
//     the 4-byte fill of the counter.
// Measured: 0.31-0.39 ms on the camera sets and 0.22-0.33 ms on the shadow
// sets, still 18-27x the bound.  What holds it back is the tap gather, not
// divergence: 85 % of a warp's lanes are busy on the camera rays, but 81 %
// of their steps leave their base voxel and reload 64 taps that lanes on
// other rays do not share, and a step costs about 2,000 cycles.  Wider row
// loads were slower here (PERF.md); a bricked copy of the grid or
// warp-cooperative evaluation are the next candidates.
//
// Scheduling does not change results: a ray's outputs depend on its own
// inputs only, so two launches on the same rays are bit-identical
// (chip_smoke.py checks it).
//
// Rounding: compiled with FMA contraction (kernels.FMAD), measured 5-15 %
// faster than -fmad=false (PERF.md, PR 4), with hit bits still equal to
// the plain version's and its_t within 6e-6 on the path's rays.  The setup
// and the step updates follow the plain version's operation order (the
// refinement rate is (1 / (10 + s)) * 10, as PyTorch evaluates 10.0 /
// tensor), but products and sums are contracted and the SDF value is summed
// in the separable order, so a ray whose f lands within rounding of eps may
// stop one step earlier or later than in the plain version.  The box (whose
// flat faces make many grazing rays) and the steps of the trace options are
// written with explicitly rounded products and sums (mul / add below), so
// that they round as the plain version: on the bunny camera chunk at a box,
// 6 of 1.1 M hit bits differed from the plain version with contraction, 1
// without (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tricubic.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kAllLanes = 0xffffffffu;
// Idle lanes of a warp that start a refill.  Measured on the path's camera
// and shadow rays at 64^3 (PERF.md, PR 4): 4 was slower on both, 16 no
// faster, 32 faster on the camera rays but half again slower on the shadow
// rays; 8 is the best on both together.
constexpr int kRefillMin = 8;
// Rays a warp claims with one atomicAdd: one per lane.  Claims of 64 and 128
// rays were slower on the camera rays (PERF.md, PR 4).
constexpr unsigned kChunk = 32;
// Resident blocks an SM must fit, which sets the register budget (168
// registers).  2 blocks were slower on the camera rays, 4 on the shadow
// rays (PERF.md, PR 4).
constexpr int kMinBlocks = 3;
static_assert(kRefillMin >= 1 && kRefillMin <= 32, "a refill threshold is within a warp");
static_assert(kChunk >= 32, "a claim must cover a warp's candidates");

// Products and sums that are never contracted into a fused multiply-add, so
// that they round as the plain version's separate operations: the box
// (whose flat faces make grazing rays that a last-bit difference in a ray's
// position or direction can move across the hit threshold) and the steps
// of the trace options use them; the grid's default path keeps contraction
// (kernels.FMAD).
template <bool kExact>
__device__ __forceinline__ float mul(float a, float b) {
    return kExact ? __fmul_rn(a, b) : a * b;
}
template <bool kExact>
__device__ __forceinline__ float add(float a, float b) {
    return kExact ? __fadd_rn(a, b) : a + b;
}

// Cubic B-spline grid translated by origin; the box is [origin, origin + 1].
// kExact: whether the ray setup and the ray's points round as the plain
// version (see mul / add).
struct GridSdf {
    static constexpr bool kExact = false;
    using Cache = tricubic::TapCache;
    tricubic::Grid g;
    const float* origin;
    float ox, oy, oz;

    __device__ void load() {
        ox = __ldg(origin + 0);
        oy = __ldg(origin + 1);
        oz = __ldg(origin + 2);
    }
    __device__ void bbox(float expand, float lo[3], float hi[3]) const {
        const float p[3] = {ox, oy, oz};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            lo[k] = p[k] - expand;
            hi[k] = (p[k] + 1.0f) + expand;
        }
    }
    __device__ void clear(Cache& c) const { tricubic::clear(c); }
    __device__ float eval(float x, float y, float z, Cache& c) const {
        return tricubic::value_cached(g, x - ox, y - oy, z - oz, c);
    }
    __device__ float eval_grad(float x, float y, float z, Cache& c, float grad[3]) const {
        return tricubic::value_grad_cached(g, x - ox, y - oy, z - oz, c, grad);
    }
};

// Analytic sphere |x - center| - radius; the box is center -+ 0.5.
struct SphereSdf {
    static constexpr bool kExact = false;
    struct Cache {};
    const float* center;
    const float* radius;
    float cx, cy, cz, r;

    __device__ void load() {
        cx = __ldg(center + 0);
        cy = __ldg(center + 1);
        cz = __ldg(center + 2);
        r = __ldg(radius);
    }
    __device__ void bbox(float expand, float lo[3], float hi[3]) const {
        const float p[3] = {cx, cy, cz};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            lo[k] = (p[k] - 0.5f) - expand;
            hi[k] = (p[k] + 0.5f) + expand;
        }
    }
    __device__ void clear(Cache&) const {}
    __device__ float eval(float x, float y, float z, Cache&) const {
        const float dx = x - cx, dy = y - cy, dz = z - cz;
        return sqrtf((dx * dx + dy * dy) + dz * dz) - r;
    }
    // gradient (x - c) / max(|x - c|, 1e-20), as SphereSDF.eval_and_grad
    __device__ float eval_grad(float x, float y, float z, Cache&, float grad[3]) const {
        const float dx = x - cx, dy = y - cy, dz = z - cz;
        const float n = sqrtf((dx * dx + dy * dy) + dz * dz);
        const float m = fmaxf(n, 1e-20f);
        grad[0] = dx / m;
        grad[1] = dy / m;
        grad[2] = dz / m;
        return n - r;
    }
};

// Smooth box |max(q, 0)| + min(max_k q_k, 0) - smoothing with q = |x - p| -
// extents (ops/sdf.py::BoxSDF); the box of the trace is p -+ 0.5.  Its
// gradient is sign(x - p) * (max(q, 0) / |max(q, 0)| outside the sharp
// box, the one-hot axis of the largest q_k inside), as BoxSDF.eval_and_grad.
struct BoxSdf {
    static constexpr bool kExact = true;
    struct Cache {};
    const float* center;
    const float* shape;  // extents (3) and smoothing
    float cx, cy, cz, ex, ey, ez, smooth;

    __device__ void load() {
        cx = __ldg(center + 0);
        cy = __ldg(center + 1);
        cz = __ldg(center + 2);
        ex = __ldg(shape + 0);
        ey = __ldg(shape + 1);
        ez = __ldg(shape + 2);
        smooth = __ldg(shape + 3);
    }
    __device__ void bbox(float expand, float lo[3], float hi[3]) const {
        const float p[3] = {cx, cy, cz};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            lo[k] = (p[k] - 0.5f) - expand;
            hi[k] = (p[k] + 0.5f) + expand;
        }
    }
    __device__ void clear(Cache&) const {}
    __device__ float eval(float x, float y, float z, Cache&) const {
        const float qx = fabsf(x - cx) - ex, qy = fabsf(y - cy) - ey, qz = fabsf(z - cz) - ez;
        const float px = fmaxf(qx, 0.0f), py = fmaxf(qy, 0.0f), pz = fmaxf(qz, 0.0f);
        const float outside = sqrtf(add<true>(add<true>(mul<true>(px, px), mul<true>(py, py)), mul<true>(pz, pz)));
        return (outside + fminf(fmaxf(fmaxf(qx, qy), qz), 0.0f)) - smooth;
    }
    __device__ float eval_grad(float x, float y, float z, Cache&, float grad[3]) const {
        const float rel[3] = {x - cx, y - cy, z - cz};
        const float ext[3] = {ex, ey, ez};
        float q[3], qp[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            q[k] = fabsf(rel[k]) - ext[k];
            qp[k] = fmaxf(q[k], 0.0f);
        }
        const float n = sqrtf(add<true>(add<true>(mul<true>(qp[0], qp[0]), mul<true>(qp[1], qp[1])),
                                        mul<true>(qp[2], qp[2])));
        int axis = 0;  // the first axis of the largest q_k
        if (q[1] > q[axis]) axis = 1;
        if (q[2] > q[axis]) axis = 2;
        const float qmax = q[axis];
        const float m = fmaxf(n, 1e-30f);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float s = rel[k] > 0.0f ? 1.0f : (rel[k] < 0.0f ? -1.0f : 0.0f);
            const float inside = (k == axis && qmax < 0.0f) ? 1.0f : 0.0f;
            grad[k] = s * (qp[k] / m + inside);
        }
        return (n + fminf(qmax, 0.0f)) - smooth;
    }
};

// The rays' operands.  Lane i of a per-lane operand is at ptr[i * stride];
// a stride of 0 broadcasts one value.  A null maxt / active / refine
// pointer means the scalar beside it holds for every lane.
struct Rays {
    const float* o;
    long long o_stride;
    const float* d;
    long long d_stride;
    const float* maxt;
    long long maxt_stride;
    float maxt_value;
    const uint8_t* active;
    long long active_stride;
    int active_value;
    const uint8_t* refine;
    long long refine_stride;
    int refine_value;
};

struct Params {
    float bbox_expand, trace_eps, step_scale;
    // over_relax > 1 turns over-relaxation on; relax_retreat = 1 - over_relax
    // as the caller rounds it to float32
    float over_relax, relax_retreat;
    int newton;  // refine with the guarded Newton step
    int max_steps, refine_steps;
};

// A ray's inputs as the caller passed them.
struct RayInput {
    float ox, oy, oz, dx, dy, dz, maxt;
    bool active, refine;
};

// A ray being traced: what _ray_setup gives it, and where its loop stands.
struct Ray {
    float ox, oy, oz, dx, dy, dz;
    float t, maxt, eps;
    int steps;   // evaluations of the trace loop
    int refine;  // -1 while tracing, else refinement steps taken
    int refine_ok;
    // over-relaxation: the lane's w, its previous |f| and its previous
    // step's length
    float omega, prev_radius, step_len;
};

// An inactive ray is not traced, so nothing else of it is read.
__device__ __forceinline__ void load_ray(const Rays& rays, long long i, RayInput& in) {
    in.active = rays.active ? rays.active[i * rays.active_stride] != 0 : rays.active_value != 0;
    if (!in.active) return;
    const float* o = rays.o + i * rays.o_stride;
    const float* d = rays.d + i * rays.d_stride;
    in.ox = o[0];
    in.oy = o[1];
    in.oz = o[2];
    in.dx = d[0];
    in.dy = d[1];
    in.dz = d[2];
    in.maxt = rays.maxt ? rays.maxt[i * rays.maxt_stride] : rays.maxt_value;
    in.refine = rays.refine ? rays.refine[i * rays.refine_stride] != 0 : rays.refine_value != 0;
}

// The setup of ops/trace.py::_ray_setup, in its operation order.  Returns
// false when the ray is not traced (inactive, or it misses the box within
// its extent).
template <class Sdf>
__device__ bool setup_ray(const Sdf& sdf, const Params& prm, const RayInput& in, Ray& ray) {
    if (!in.active) return false;
    const float o3[3] = {in.ox, in.oy, in.oz};
    float d3[3] = {in.dx, in.dy, in.dz};
    constexpr bool e = Sdf::kExact;
    const float norm =
        sqrtf(fmaxf(add<e>(add<e>(mul<e>(d3[0], d3[0]), mul<e>(d3[1], d3[1])), mul<e>(d3[2], d3[2])), 1e-30f));
    float lo[3], hi[3];
    sdf.bbox(prm.bbox_expand, lo, hi);
    float mint = -INFINITY, tmax = INFINITY;
    bool inside = true;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        d3[k] = d3[k] / norm;
        const float tiny = d3[k] >= 0.0f ? 1e-12f : -1e-12f;
        const float safe = fabsf(d3[k]) < 1e-12f ? tiny : d3[k];
        const float inv = 1.0f / safe;
        const float t0 = (lo[k] - o3[k]) * inv;
        const float t1 = (hi[k] - o3[k]) * inv;
        mint = fmaxf(mint, fminf(t0, t1));
        tmax = fminf(tmax, fmaxf(t0, t1));
        inside = inside && o3[k] >= lo[k] && o3[k] <= hi[k];
    }
    const bool hit = tmax >= mint && tmax > 0.0f && (mint > 0.0f || inside) && mint <= in.maxt;
    if (!hit) return false;
    ray.ox = o3[0];
    ray.oy = o3[1];
    ray.oz = o3[2];
    ray.dx = d3[0];
    ray.dy = d3[1];
    ray.dz = d3[2];
    ray.maxt = fminf(tmax, in.maxt);
    ray.eps = prm.trace_eps * fmaxf(ray.maxt, 1.0f);
    ray.t = inside ? 0.0f : mint + 1e-5f;
    ray.steps = 0;
    ray.refine = -1;
    ray.refine_ok = prm.refine_steps > 0 && in.refine;
    return true;
}

// One evaluation of the ray's trace or refinement.  Returns 0 while the ray
// goes on, 1 when it has ended on the surface (its_t = ray.t), 2 when it has
// missed (its_t = inf).  Over-relaxation and the Newton refinement are each
// switched on by their parameter.
template <class Sdf>
__device__ int advance(const Sdf& sdf, const Params& prm, Ray& ray, typename Sdf::Cache& cache) {
    constexpr bool e = Sdf::kExact;
    const float x = add<e>(ray.ox, mul<e>(ray.t, ray.dx)), y = add<e>(ray.oy, mul<e>(ray.t, ray.dy)),
                z = add<e>(ray.oz, mul<e>(ray.t, ray.dz));
    if (ray.refine >= 0 && prm.newton) {
        float g[3];
        const float f = sdf.eval_grad(x, y, z, cache, g) * prm.step_scale;
        const float slope =
            add<true>(add<true>(mul<true>(g[0], ray.dx), mul<true>(g[1], ray.dy)), mul<true>(g[2], ray.dz)) *
            prm.step_scale;
        const float rate_fb = (1.0f / (10.0f + (float)ray.refine)) * 10.0f;
        // -1 / slope as PyTorch evaluates -1.0 / tensor: (1 / slope) * -1
        const float rate = slope < -0.25f ? fminf(-(1.0f / slope), 4.0f) : rate_fb;
        ray.t = add<true>(ray.t, mul<true>(__fsub_rn(f, mul<true>(0.5f, ray.eps)), rate));
        ray.refine += 1;
        return (!(f <= 0.0f || f > ray.eps) || ray.refine >= prm.refine_steps) ? 1 : 0;
    }
    const float f = sdf.eval(x, y, z, cache) * prm.step_scale;
    if (ray.refine < 0) {
        ray.steps += 1;
        if (prm.over_relax > 1.0f) {
            const float radius = fabsf(f);
            const bool fail = ray.omega > 1.0f && radius + ray.prev_radius < ray.step_len;
            if (!fail && f < ray.eps) {
                if (!ray.refine_ok) return 1;
                ray.refine = 0;  // refine from this t
                return 0;
            }
            const float step = fail ? mul<true>(prm.relax_retreat, ray.step_len) : mul<true>(radius, ray.omega);
            // a retreat never ends the ray; otherwise the conservative reach
            // t + |f| decides, not the w-inflated step
            const bool go = fail || ray.t + radius <= ray.maxt;
            ray.t = add<true>(ray.t, step);
            ray.omega = fail ? 1.0f : ray.omega;
            ray.prev_radius = fail ? 0.0f : radius;
            ray.step_len = fabsf(step);
            return (!go || ray.steps >= prm.max_steps) ? 2 : 0;
        }
        if (f < ray.eps) {
            if (!ray.refine_ok) return 1;
            ray.refine = 0;  // refine from this t
            return 0;
        }
        ray.t = ray.t + fabsf(f);
        return (!(ray.t <= ray.maxt) || ray.steps >= prm.max_steps) ? 2 : 0;
    }
    const float rate = (1.0f / (10.0f + (float)ray.refine)) * 10.0f;
    ray.t = add<e>(ray.t, mul<e>(f, rate));
    ray.refine += 1;
    return (!(f <= 0.0f || f > ray.eps) || ray.refine >= prm.refine_steps) ? 1 : 0;
}

// Position of the k-th (from 0) set bit of m; m has more than k bits set.
__device__ __forceinline__ int nth_set_bit(unsigned m, unsigned k) {
    int pos = 0;
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) {
        const unsigned low = __popc(m & ((1u << w) - 1u));
        if (k >= low) {
            k -= low;
            m >>= w;
            pos += w;
        }
    }
    return pos;
}

__device__ __forceinline__ float shfl(float v, int src) { return __shfl_sync(kAllLanes, v, src); }
__device__ __forceinline__ int shfl(int v, int src) { return __shfl_sync(kAllLanes, v, src); }

template <class Sdf>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sphere_trace_kernel(Sdf sdf, Rays rays, Params prm, float* __restrict__ its_t, int* __restrict__ num_steps,
                    unsigned* __restrict__ next_ray, unsigned n) {
    sdf.load();
    const unsigned lane = threadIdx.x & 31u;
    const unsigned lanes_below = (1u << lane) - 1u;
    typename Sdf::Cache cache;
    sdf.clear(cache);
    Ray ray;
    int id = -1;              // this lane's ray, -1 = idle
    unsigned lo = 0, hi = 0;  // warp-uniform: the claimed rays [lo, hi) not yet examined
    bool drained = false;     // warp-uniform: a claim came back empty
    // lane 0 claims each chunk one chunk ahead, so that the atomic's
    // latency is spent while the warp traces
    unsigned ahead = 0;
    if (lane == 0) ahead = atomicAdd(next_ray, kChunk);
    for (;;) {
        unsigned idle = __ballot_sync(kAllLanes, id < 0);
        if (drained && idle == kAllLanes) break;
        if (!drained && __popc(idle) >= kRefillMin) {
            // Refill rounds until every lane has a ray or the rays run out.
            // In a round all 32 lanes set up one candidate each (the next 32
            // claimed rays), the idle lanes take the traced ones in order
            // through shuffles, and the candidates up to the last one taken
            // are consumed: those not traced are written at once; traced
            // ones beyond it stay claimed for the next round.
            do {
                if (lo == hi) {
                    const unsigned base = __shfl_sync(kAllLanes, ahead, 0);
                    if (lane == 0) ahead = atomicAdd(next_ray, kChunk);
                    lo = min(base, n);
                    hi = min(base + kChunk, n);
                    if (lo == hi) {
                        drained = true;
                        break;
                    }
                }
                const unsigned cand = lo + lane;
                RayInput in;
                Ray c{};  // what an idle lane takes from the lane that set it up
                bool traced = false;
                if (cand < hi) {
                    load_ray(rays, cand, in);
                    traced = setup_ray(sdf, prm, in, c);
                }
                const unsigned traced_lanes = __ballot_sync(kAllLanes, traced);
                const unsigned need = __popc(idle), found = __popc(traced_lanes);
                const unsigned consumed =
                    found > need ? nth_set_bit(traced_lanes, need - 1) + 1 : min(32u, hi - lo);
                if (lane < consumed && !traced) {
                    its_t[cand] = INFINITY;
                    num_steps[cand] = 0;
                }
                // the idle lane of rank k takes the k-th traced candidate
                const unsigned rank = __popc(idle & lanes_below);
                const bool take = id < 0 && rank < found;
                const int src = take ? nth_set_bit(traced_lanes, rank) : (int)lane;
                const float ox = shfl(c.ox, src), oy = shfl(c.oy, src), oz = shfl(c.oz, src);
                const float dx = shfl(c.dx, src), dy = shfl(c.dy, src), dz = shfl(c.dz, src);
                const float t = shfl(c.t, src), maxt = shfl(c.maxt, src), eps = shfl(c.eps, src);
                const int refine_ok = shfl(c.refine_ok, src);
                if (take) {
                    ray = Ray{ox, oy, oz, dx, dy, dz, t, maxt, eps, 0, -1, refine_ok, prm.over_relax, 0.0f, 0.0f};
                    id = (int)(lo + src);
                }
                lo += consumed;
                idle = __ballot_sync(kAllLanes, id < 0);
            } while (idle != 0);
        }
        // one evaluation for every lane that has a ray; a ray that ends is
        // written
        if (id >= 0) {
            const int ended = advance(sdf, prm, ray, cache);
            if (ended) {
                its_t[id] = ended == 1 ? ray.t : INFINITY;
                num_steps[id] = ray.steps + (ray.refine > 0 ? ray.refine : 0);
                id = -1;
            }
        }
    }
}

constexpr int kMaxDevices = 64;

// Blocks of this kernel that are resident on the whole card at once,
// computed once per device.
template <class Sdf>
int resident_blocks() {
    static int cached[kMaxDevices] = {0};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= kMaxDevices) return 0;
    if (cached[dev] == 0) {
        int sms = 0, per_sm = 0;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sphere_trace_kernel<Sdf>, kThreads, 0);
        cached[dev] = sms * per_sm;
    }
    return cached[dev];
}

template <class Sdf>
int launch(const Sdf& sdf, const Rays& rays, const Params& prm, void* its_t, void* num_steps, void* next_ray,
           unsigned n, cudaStream_t stream) {
    const int resident = resident_blocks<Sdf>();
    if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
    const long long needed = ((long long)n + kThreads - 1) / kThreads;
    const unsigned blocks = (unsigned)(needed < resident ? needed : resident);
    sphere_trace_kernel<Sdf><<<blocks, kThreads, 0, stream>>>(sdf, rays, prm, (float*)its_t, (int*)num_steps,
                                                             (unsigned*)next_ray, n);
    return (int)cudaGetLastError();
}

}  // namespace

// Traces n rays (n < 2^31).  sdf_kind 0: the grid (zres, yres, xres) float32
// contiguous, translated by p (3 floats on the device); sdf_kind 1: the
// sphere of centre p (3 floats) and radius r (1 float), both on the device;
// sdf_kind 2: the box of centre p (3 floats) with r = its half-extents and
// smoothing (4 floats), on the device.
// o, d: float32 rows of 3 with lane strides o_stride, d_stride (elements;
// 0 broadcasts); maxt (float32), active and refine (uint8 or bool): per-lane
// with the given stride, or null for the scalar beside them.  over_relax in
// [1, 2) (1 = off) with relax_retreat = 1 - over_relax rounded to float32;
// newton != 0 refines with the Newton step.  next_ray: one unsigned int on
// the device, zero before the launch.  refine_steps = 0 skips the
// refinement.  Writes its_t (inf = miss) and num_steps (evaluations of the
// trace loop and the refinement together).  One launch on `stream`; nothing
// is allocated and nothing synchronises.  Returns cudaGetLastError() after
// the launch (0 = success).
extern "C" int sphere_trace_run(int sdf_kind, const void* grid, int xres, int yres, int zres, const void* p,
                                const void* r, const void* o, long long o_stride, const void* d,
                                long long d_stride, const void* maxt, long long maxt_stride, float maxt_value,
                                const void* active, long long active_stride, int active_value,
                                const void* refine, long long refine_stride, int refine_value,
                                float bbox_expand, float trace_eps, float step_scale, float over_relax,
                                float relax_retreat, int newton, int max_steps, int refine_steps, void* its_t,
                                void* num_steps, void* next_ray, long long n, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    if (n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    if (!(over_relax >= 1.0f && over_relax < 2.0f)) return (int)cudaErrorInvalidValue;
    const Rays rays{(const float*)o, o_stride, (const float*)d, d_stride,
                    (const float*)maxt, maxt_stride, maxt_value,
                    (const uint8_t*)active, active_stride, active_value,
                    (const uint8_t*)refine, refine_stride, refine_value};
    const Params prm{bbox_expand, trace_eps, step_scale, over_relax, relax_retreat, newton, max_steps, refine_steps};
    const cudaStream_t s = (cudaStream_t)stream;
    if (sdf_kind == 1) {
        const SphereSdf sdf{(const float*)p, (const float*)r, 0.0f, 0.0f, 0.0f, 0.0f};
        return launch(sdf, rays, prm, its_t, num_steps, next_ray, (unsigned)n, s);
    }
    if (sdf_kind == 2) {
        const BoxSdf sdf{(const float*)p, (const float*)r, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        return launch(sdf, rays, prm, its_t, num_steps, next_ray, (unsigned)n, s);
    }
    if (sdf_kind != 0) return (int)cudaErrorInvalidValue;
    const GridSdf sdf{{(const float*)grid, xres, yres, zres}, (const float*)p, 0.0f, 0.0f, 0.0f};
    return launch(sdf, rays, prm, its_t, num_steps, next_ray, (unsigned)n, s);
}
