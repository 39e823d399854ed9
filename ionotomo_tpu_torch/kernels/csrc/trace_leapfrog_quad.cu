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
// Bound on the H100: the field gather, as K1's. Each step evaluates the
// field once: 9 rows x 3 z taps, plus ~510 flops.
//
// Design: K1's (trace_leapfrog_zp.cu), on the evaluator of quad_eval.cuh:
// - quadratic's z stencil is the zp one (b-1, b, b+1 of the nearest base
//   b, clamped to [1, nz-2]), so the z-tap-packed table is K1's
//   (pack_zp_taps in trace_leapfrog_zp.cu): a step makes 9 one-sector
//   loads;
// - the wrapper (kernels.trace_leapfrog_quad) packs and sorts the rays
//   (kernels.ray_order) from kernels.TRACE_ZP_RAYS_PER_SM rays an SM, as
//   K1 does; a smaller batch reads the table as it is, in ray order, 32
//   rays a block;
// - one thread per ray, the integrator of trace_leapfrog.cuh. The packed
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
// (launch_trace_leapfrog_ordered). path may be null (keep_path=False).
extern "C" int ionotomo_trace_leapfrog_quad(
    const float* coef, const float* packed, const float* origin,
    const float* spacing, int nx, int ny, int nz, const float* origins,
    const float* directions, const int* order, int n_rays, int n_steps,
    float h, float hh12, float w_n, float w_rhs, float k_ne, float tec_unit,
    int threads, float* x_end, float* tau, float* path, void* stream) {
  if (nx < 3 || ny < 3 || nz < 3) return (int)cudaErrorInvalidValue;
  const TraceConsts c{h, hh12, w_n, w_rhs, k_ne, tec_unit};
  if (packed == nullptr)
    return launch_trace_leapfrog_ordered(
        QuadValueGrad{}, coef, origin, spacing, nx, ny, nz, origins,
        directions, order, n_rays, n_steps, c, threads, x_end, tau, path,
        stream);
  return launch_trace_leapfrog_ordered(
      QuadValueGradPacked{reinterpret_cast<const float4*>(packed)}, coef,
      origin, spacing, nx, ny, nz, origins, directions, order, n_rays,
      n_steps, c, threads, x_end, tau, path, stream);
}
