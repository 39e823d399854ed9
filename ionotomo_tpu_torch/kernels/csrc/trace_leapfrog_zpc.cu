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
// Bound on the H100: the field gather, as K1's. Each step evaluates the
// field once: 7 live rows x 4 z taps, plus ~500 flops (weights, exp,
// sqrt, two divisions, the kick-drift-kick update). Successive steps of
// one ray depend on each other, so only other rays in flight hide a
// step's loads.
//
// Design: K1's (trace_leapfrog_zp.cu), on the evaluator of zpc_eval.cuh:
// - zpc's z stencil is the tricubic one (clamp(b-1), b, b+1, clamp(b+2) of
//   the floor base b), so the z-tap-packed table is K1c's (pack_z_taps in
//   trace_leapfrog_cubic.cu): a step makes 7 one-sector loads;
// - the wrapper (kernels.trace_leapfrog_zpc) packs and sorts the rays
//   (kernels.ray_order) from kernels.TRACE_ZP_RAYS_PER_SM rays an SM, as
//   K1 does (zpc gathers zp's 7 rows); a smaller batch reads the table as
//   it is, in ray order, 32 rays a block;
// - one thread per ray, the integrator of trace_leapfrog.cuh. The packed
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
// (launch_trace_leapfrog_ordered). path may be null (keep_path=False).
extern "C" int ionotomo_trace_leapfrog_zpc(
    const float* coef, const float* packed, const float* origin,
    const float* spacing, int nx, int ny, int nz, const float* origins,
    const float* directions, const int* order, int n_rays, int n_steps,
    float h, float hh12, float w_n, float w_rhs, float k_ne, float tec_unit,
    int threads, float* x_end, float* tau, float* path, void* stream) {
  if (nx < 3 || ny < 3 || nz < 3) return (int)cudaErrorInvalidValue;
  const TraceConsts c{h, hh12, w_n, w_rhs, k_ne, tec_unit};
  if (packed == nullptr)
    return launch_trace_leapfrog_ordered(
        ZpcValueGrad{}, coef, origin, spacing, nx, ny, nz, origins,
        directions, order, n_rays, n_steps, c, threads, x_end, tau, path,
        stream);
  return launch_trace_leapfrog_ordered(
      ZpcValueGradPacked{reinterpret_cast<const float4*>(packed)}, coef,
      origin, spacing, nx, ny, nz, origins, directions, order, n_rays,
      n_steps, c, threads, x_end, tau, path, stream);
}
