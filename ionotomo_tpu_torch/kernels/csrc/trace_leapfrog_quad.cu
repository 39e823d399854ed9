// K1q: the bent-ray Fermat tracer, leapfrog (velocity Verlet) over the
// triquadratic field model, with the Hermite TEC quadrature, all n_steps
// in one launch.
//
// Replaces: ionotomo_tpu/geometry/fermat.py, _trace_impl's leapfrog branch
// (:204-227) fused with _rhs (:61) and the triquadratic evaluator
// (core/triquadratic.py:173, interp_rows_with_grad; the "quadratic"
// branch of field_evaluator, :121-124) that trace_rays(method="leapfrog",
// interp="quadratic") runs under lax.scan. The table holds the field's
// B-spline coefficients (triquadratic.prefilter).
//
// K1r on quadratic (ionotomo_trace_rk4_quad): the rk4 branch of _trace_impl
// (:182-202) on the same evaluators, packs, ray order and call as K1q
// (trace_rays(method="rk4", interp="quadratic")), four evaluations a step
// in one launch where the reference's rk4 scan makes four gathers a step.
//
// Bound on the H100: its instructions and their latency. A step runs ~350
// SASS instructions (chip_smoke.py --k1zq-study: ten IEEE divisions, two
// square roots and an exp, the three axes' weights, 9 one-sector loads),
// so the bench's 262,144 rays x 64 steps take at least ~0.18 ms at one warp
// instruction a clock on each of the card's 528 schedulers; the tracer
// runs at ~0.30 ms, latency in the way: successive steps of one ray depend
// on each other, so only other rays in flight hide a step's loads.
//
// Design (chip_smoke.py --k1zq-study):
// - the leapfrog over the packed table takes a register budget of 4
//   blocks of 256 an SM (K1_BUDGET(4): 64 registers, the most rays in
//   flight): of the budgets 0-4 the fastest, 256 rays a block; the table
//   as it is (a small batch) keeps the compiler's 71 registers, which a
//   budget would cut at the cost of each ray's latency;
// - the wrapper (kernels.trace_leapfrog_quad) packs the table with K1's
//   pack_zp_taps (quadratic's z stencil is the zp one: a step makes 9
//   one-sector loads) and sorts the rays (kernels.ray_order) from its own
//   threshold of rays an SM, at its own block (kernels.SORT_AND_PACK); a
//   smaller batch reads the table as it is, in ray order, 32 rays a block;
// - one thread per ray, the integrator of trace_leapfrog.cuh (two rays a
//   thread, interleaved, was slower: PERF.md). The packed
//   and the unpacked evaluator weigh and sum alike, so every ray's output
//   is bitwise what the unpacked kernel gives in ray order.
//
// Determinism: no atomics and a fixed order of operations per thread, so
// the output is bitwise identical from run to run.
#include "quad_eval.cuh"
#include "trace_leapfrog.cuh"

// Types of this file alone (global scope: a __global__ template takes them).
struct QuadValueGrad {
  __device__ __forceinline__ void operator()(const TableGrid& g, float x,
                                             float y, float z, float& m,
                                             float& gx, float& gy,
                                             float& gz) const {
    quad_value_grad_at(g, x, y, z, m, gx, gy, gz);
  }
};

struct QuadValueGradPacked {
  const float4* __restrict__ packed;
  __device__ __forceinline__ void operator()(const TableGrid& g, float x,
                                             float y, float z, float& m,
                                             float& gx, float& gy,
                                             float& gz) const {
    quad_value_grad_packed_at(g, packed, x, y, z, m, gx, gy, gz);
  }
};

// packed: K1's packed table of `coef` (ionotomo_pack_zp_taps), which the
// tracer reads in its place; null: the unpacked evaluator. order: (n_rays,)
// ray of each thread, or null. threads: the block size
// (launch_trace_ordered). path may be null (keep_path=False).
extern "C" int ionotomo_trace_leapfrog_quad(
    const float* coef, const float* packed, const float* origin,
    const float* spacing, int nx, int ny, int nz, const float* origins,
    const float* directions, const int* order, int n_rays, int n_steps,
    float h, float hh12, float w_n, float w_rhs, float k_ne, float tec_unit,
    int threads, float* x_end, float* tau, float* path, void* stream) {
  if (nx < 3 || ny < 3 || nz < 3) return (int)cudaErrorInvalidValue;
  return trace_log_density<false, K1_BUDGET(4), QuadValueGrad,
                           QuadValueGradPacked>(
      coef, packed, origin, spacing, nx, ny, nz, origins, directions,
      order, n_rays, n_steps, h, hh12, w_n, w_rhs, k_ne, tec_unit, threads,
      x_end, tau, path, stream);
}

// K1r on this model: the rk4 integrator (trace_leapfrog.cuh, trace_rk4_ray)
// over the same evaluators in its own launch, 256 rays a block at a sorted
// batch (kernels.TRACE_RK4_THREADS) with a register budget of 4 blocks of 256
// an SM (64 registers, no spill): of the budgets 1-4 the fastest on this model
// (chip_smoke.py --rk4-study). Arguments as above.
extern "C" int ionotomo_trace_rk4_quad(
    const float* coef, const float* packed, const float* origin,
    const float* spacing, int nx, int ny, int nz, const float* origins,
    const float* directions, const int* order, int n_rays, int n_steps,
    float h, float hh12, float w_n, float w_rhs, float k_ne, float tec_unit,
    int threads, float* x_end, float* tau, float* path, void* stream) {
  if (nx < 3 || ny < 3 || nz < 3) return (int)cudaErrorInvalidValue;
  return trace_log_density<true, K1R_BUDGET(4), QuadValueGrad,
                           QuadValueGradPacked>(
      coef, packed, origin, spacing, nx, ny, nz, origins, directions,
      order, n_rays, n_steps, h, hh12, w_n, w_rhs, k_ne, tec_unit, threads,
      x_end, tau, path, stream);
}
