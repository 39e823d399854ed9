// K1: the bent-ray Fermat tracer, leapfrog (velocity Verlet) over the zp
// field model, with the Hermite TEC quadrature, all n_steps in one launch.
//
// Replaces: ionotomo_tpu/geometry/fermat.py, _trace_impl's leapfrog branch
// fused with _rhs and the zp evaluator (core/boxspline.py,
// interp_rows_with_grad) that trace_rays(method="leapfrog", interp="zp")
// runs under lax.scan.
//
// Bound on the H100: the field gather. Each step evaluates the field once:
// 7 live rows x 3 z-taps x 4 B = 84 B read from 7 scattered rows of the
// (nx*ny, nz) table, plus ~250 flops (weights, exp, sqrt, two divisions,
// the kick-drift-kick update). Successive steps of one ray depend on each
// other, so it is bound by gather latency, hidden only by the number of
// rays in flight.
//
// Design: one thread per ray, the integrator of trace_leapfrog.cuh (shared
// with the cubic tracer K1c) over the evaluator of zp_eval.cuh. The only
// device-memory traffic is the table gather (L2-resident at 128^3: 8 MiB
// of 50 MB), the ray's inputs and its outputs. The reference's scan
// materialises the (R, 8, nz) pencils and the state in device memory at
// every step; none of that exists here.
//
// Determinism: no atomics and a fixed order of operations per thread, so
// the output is bitwise identical from run to run.
#include "trace_leapfrog.cuh"
#include "zp_eval.cuh"

// A type of this file alone (global scope: a __global__ template takes it).
struct ZpValueGrad {
  __device__ __forceinline__ void operator()(const TableGrid& g, float x,
                                             float y, float z, float& m,
                                             float& gx, float& gy,
                                             float& gz) const {
    zp_value_grad_at(g, x, y, z, m, gx, gy, gz);
  }
};

// path may be null (keep_path=False).
extern "C" int ionotomo_trace_leapfrog_zp(
    const float* coef, const float* origin, const float* spacing, int nx,
    int ny, int nz, const float* origins, const float* directions, int n_rays,
    int n_steps, float h, float hh12, float w_n, float w_rhs, float k_ne,
    float tec_unit, float* x_end, float* tau, float* path, void* stream) {
  const TraceConsts c{h, hh12, w_n, w_rhs, k_ne, tec_unit};
  return launch_trace_leapfrog<ZpValueGrad>(coef, origin, spacing, nx, ny, nz,
                                            origins, directions, n_rays,
                                            n_steps, c, x_end, tau, path,
                                            stream);
}
