// K1z: the bent-ray Fermat tracer, leapfrog (velocity Verlet) over the zpc
// field model (ZP box spline in x, y; Catmull-Rom cubic in z), with the
// Hermite TEC quadrature, all n_steps in one launch.
//
// Replaces: ionotomo_tpu/geometry/fermat.py, _trace_impl's leapfrog branch
// (:204-227) fused with _rhs (:61) and the zpc evaluator
// (core/zpcubic.py:108, interp_rows_with_grad; the "zpc*" branch of
// field_evaluator, :113-116) that trace_rays(method="leapfrog",
// interp="zpc") runs under lax.scan.
//
// K1r on zpc (ionotomo_trace_rk4_zpc): the rk4 branch of _trace_impl
// (:182-202) on the same evaluators, packs, ray order and call as K1z
// (trace_rays(method="rk4", interp="zpc")), four evaluations a step
// in one launch where the reference's rk4 scan makes four gathers a step.
//
// Bound on the H100: its instructions, not its gather. A step runs ~500
// SASS instructions (chip_smoke.py --k1zq-study counts the loop: ten IEEE
// divisions and two square roots, each a MUFU with its refinement and
// slow-path check, an exp, the zp weights of 7 translates, 7 one-sector
// loads of the packed table), so the bench's 262,144 rays x 64 steps take
// at least ~0.25 ms at one warp instruction a clock on each of the card's
// 528 schedulers; the tracer runs at ~0.35 ms. Successive steps of one ray
// depend on each other, so only other rays in flight hide a step's
// latency.
//
// Design (chip_smoke.py --k1zq-study):
// - the evaluator of zpc_eval.cuh forms the zp translates' weights from
//   the tables as constants of the code (zp_eval.cuh:
//   zp_translate_unrolled: no term of a zero coefficient, no constant-bank
//   loads, integer lattice offsets) and addresses the packed rows with
//   unsigned offsets: 612 -> 496 instructions a step (519 at
//   the budget below, its spills), bitwise;
// - the leapfrog over the packed table takes a register budget of 4
//   blocks of 256 an SM (K1_BUDGET(4): 64 registers): of the budgets 0-4
//   (0: the compiler's 77) the fastest at the bench's batch; the table as
//   it is (a small batch) keeps the compiler's registers;
// - the wrapper (kernels.trace_leapfrog_zpc) packs the table with K1c's
//   pack_z_taps (zpc's z stencil is the tricubic one: a step makes 7
//   one-sector loads) and sorts the rays (kernels.ray_order) from its own
//   threshold of rays an SM, at its own block (kernels.SORT_AND_PACK); a
//   smaller batch reads the table as it is, in ray order, 32 rays a block;
// - one thread per ray, the integrator of trace_leapfrog.cuh (two rays a
//   thread, interleaved, was no faster: PERF.md). The packed
//   and the unpacked evaluator weigh and sum alike, so every ray's output
//   is bitwise what the unpacked kernel gives in ray order.
//
// Determinism: no atomics and a fixed order of operations per thread, so
// the output is bitwise identical from run to run.
#include "trace_leapfrog.cuh"
#include "zpc_eval.cuh"

// Types of this file alone (global scope: a __global__ template takes them).
struct ZpcValueGrad {
  __device__ __forceinline__ void operator()(const TableGrid& g, float x,
                                             float y, float z, float& m,
                                             float& gx, float& gy,
                                             float& gz) const {
    zpc_value_grad_at(g, x, y, z, m, gx, gy, gz);
  }
};

struct ZpcValueGradPacked {
  const float4* __restrict__ packed;
  __device__ __forceinline__ void operator()(const TableGrid& g, float x,
                                             float y, float z, float& m,
                                             float& gx, float& gy,
                                             float& gz) const {
    zpc_value_grad_packed_at(g, packed, x, y, z, m, gx, gy, gz);
  }
};

// packed: K1c's packed table of `coef` (ionotomo_pack_z_taps), which the
// tracer reads in its place; null: the unpacked evaluator. order: (n_rays,)
// ray of each thread, or null. threads: the block size
// (launch_trace_ordered). path may be null (keep_path=False).
extern "C" int ionotomo_trace_leapfrog_zpc(
    const float* coef, const float* packed, const float* origin,
    const float* spacing, int nx, int ny, int nz, const float* origins,
    const float* directions, const int* order, int n_rays, int n_steps,
    float h, float hh12, float w_n, float w_rhs, float k_ne, float tec_unit,
    int threads, float* x_end, float* tau, float* path, void* stream) {
  if (nx < 3 || ny < 3 || nz < 3) return (int)cudaErrorInvalidValue;
  return trace_log_density<false, K1_BUDGET(4), ZpcValueGrad,
                           ZpcValueGradPacked>(
      coef, packed, origin, spacing, nx, ny, nz, origins, directions,
      order, n_rays, n_steps, h, hh12, w_n, w_rhs, k_ne, tec_unit, threads,
      x_end, tau, path, stream);
}

// K1r on this model: the rk4 integrator (trace_leapfrog.cuh, trace_rk4_ray)
// over the same evaluators in its own launch, 256 rays a block at a sorted
// batch (kernels.TRACE_RK4_THREADS) with a register budget of 2 blocks of 256
// an SM (125 registers): of the budgets 1-4 the fastest on this model
// (chip_smoke.py --rk4-study). Arguments as above.
extern "C" int ionotomo_trace_rk4_zpc(
    const float* coef, const float* packed, const float* origin,
    const float* spacing, int nx, int ny, int nz, const float* origins,
    const float* directions, const int* order, int n_rays, int n_steps,
    float h, float hh12, float w_n, float w_rhs, float k_ne, float tec_unit,
    int threads, float* x_end, float* tau, float* path, void* stream) {
  if (nx < 3 || ny < 3 || nz < 3) return (int)cudaErrorInvalidValue;
  return trace_log_density<true, K1R_BUDGET(2), ZpcValueGrad,
                           ZpcValueGradPacked>(
      coef, packed, origin, spacing, nx, ny, nz, origins, directions,
      order, n_rays, n_steps, h, hh12, w_n, w_rhs, k_ne, tec_unit, threads,
      x_end, tau, path, stream);
}
