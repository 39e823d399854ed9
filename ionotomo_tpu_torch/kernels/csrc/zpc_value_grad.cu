// K6z: zpc value and physical gradient at N points.
//
// Replaces: ionotomo_tpu/core/zpcubic.py, interp_rows_with_grad (:108-129,
// the 8-row gather contracted xy-first against two dense Catmull-Rom z
// bands that the JAX package wrote below jnp). It serves the Hermite
// endpoint derivatives of the zpc model (forward/tec.py, _endpoint_dne_ds),
// E in the linearised dTEC operator on zpc (the inner Jacobian of the
// mixed-fidelity config-4 solve, interp_inner="zpc2"), and each rk4 stage
// of a zpc trace.
//
// Bound on the H100: a gather. Each evaluation reads 7 live rows x 4 z taps
// x 4 B = 112 B scattered over 7 rows of the (nx*ny, nz) table, against
// ~180 flops of weights and contraction, so it is latency- and L2-bound.
// The main path evaluates config 4's 20,000 endpoints: a launch is a few
// microseconds, and how many SMs it reaches decides its time.
//
// Design: K1e's (zp_value_grad.cu). One thread per point, which loads only
// the 4 taps it needs of each live row, so the (N, 8, nz) pencil block is
// never built; the evaluator is zpc_eval.cuh, shared with the tracer K1z
// and the transpose K6z^T. 32 threads a block, the size chip_smoke.py
// --e-study measured best for K1e and K5 at 20,000 endpoints, so that
// the points spread over every SM.
//
// Determinism: no atomics and a fixed summation order per thread, so the
// output is bitwise identical from run to run.
#include "zpc_eval.cuh"

namespace {

__global__ void __launch_bounds__(32)
    zpc_value_grad_kernel(const float* __restrict__ coef,
                          const float* __restrict__ origin,
                          const float* __restrict__ spacing, int nx, int ny,
                          int nz, const float* __restrict__ points, int n,
                          float* __restrict__ value,
                          float* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const TableGrid g = table_grid(coef, origin, spacing, nx, ny, nz);
  float m, gx, gy, gz;
  zpc_value_grad_at(g, points[3 * (size_t)i + 0], points[3 * (size_t)i + 1],
                    points[3 * (size_t)i + 2], m, gx, gy, gz);
  value[i] = m;
  grad[3 * (size_t)i + 0] = gx;
  grad[3 * (size_t)i + 1] = gy;
  grad[3 * (size_t)i + 2] = gz;
}

}  // namespace

extern "C" int ionotomo_zpc_value_grad(const float* coef, const float* origin,
                                       const float* spacing, int nx, int ny,
                                       int nz, const float* points, int n,
                                       float* value, float* grad,
                                       void* stream) {
  if (nx < 3 || ny < 3 || nz < 3) return (int)cudaErrorInvalidValue;
  zpc_value_grad_kernel<<<(n + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
      coef, origin, spacing, nx, ny, nz, points, n, value, grad);
  return (int)cudaGetLastError();
}
