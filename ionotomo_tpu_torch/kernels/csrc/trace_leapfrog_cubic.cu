// K1c: the bent-ray Fermat tracer, leapfrog (velocity Verlet) over the
// Catmull-Rom tricubic field model, with the Hermite TEC quadrature, all
// n_steps in one launch.
//
// Replaces: ionotomo_tpu/geometry/fermat.py, _trace_impl's leapfrog branch
// (:204-227) fused with _rhs (:61) and the tricubic evaluator
// (core/tricubic.py:529, interp_rows_with_grad; the interp == "cubic"
// branch of field_evaluator, :110-112) that trace_rays(method="leapfrog")
// runs under lax.scan with the package's default field model. The table is
// the log-density field itself: the cubic model has no prefilter.
//
// Bound on the H100: the field gather. Each step evaluates the field once:
// 16 rows x 4 z-taps x 4 B = 256 B read from 16 scattered rows of the
// (nx*ny, nz) table, three times the zp tracer's 84 B, plus ~840 flops
// (~520 of weights and contraction, then exp, sqrt, the divisions and the
// kick-drift-kick update). Successive steps of one ray depend on each
// other, so it is bound by gather latency, hidden only by the number of
// rays in flight.
//
// Design: one thread per ray, the integrator of trace_leapfrog.cuh (shared
// with the zp tracer K1) over the evaluator of cubic_eval.cuh (shared with
// K5 and K5^T), which folds each z-contracted pencil into its y sums at
// once, so the 32 pencil sums are never all live in registers.
//
// Determinism: no atomics and a fixed order of operations per thread, so
// the output is bitwise identical from run to run.
#include "cubic_eval.cuh"
#include "trace_leapfrog.cuh"

// A type of this file alone (global scope: a __global__ template takes it).
struct CubicValueGrad {
  __device__ __forceinline__ void operator()(const TableGrid& g, float x,
                                             float y, float z, float& m,
                                             float& gx, float& gy,
                                             float& gz) const {
    cubic_value_grad_at(g, x, y, z, m, gx, gy, gz);
  }
};

// path may be null (keep_path=False).
extern "C" int ionotomo_trace_leapfrog_cubic(
    const float* table, const float* origin, const float* spacing, int nx,
    int ny, int nz, const float* origins, const float* directions, int n_rays,
    int n_steps, float h, float hh12, float w_n, float w_rhs, float k_ne,
    float tec_unit, float* x_end, float* tau, float* path, void* stream) {
  if (nx < 2 || ny < 2 || nz < 2) return (int)cudaErrorInvalidValue;
  const TraceConsts c{h, hh12, w_n, w_rhs, k_ne, tec_unit};
  return launch_trace_leapfrog<CubicValueGrad>(table, origin, spacing, nx, ny,
                                               nz, origins, directions,
                                               n_rays, n_steps, c, x_end, tau,
                                               path, stream);
}
