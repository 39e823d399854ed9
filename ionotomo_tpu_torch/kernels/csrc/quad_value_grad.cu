// K6q: triquadratic value and physical gradient at N points.
//
// Replaces: ionotomo_tpu/core/triquadratic.py, interp_rows_with_grad
// (:173-207, the 9-row gather contracted z-first against two dense
// quadratic z bands that the JAX package wrote below jnp). It is each rk4
// stage of a quadratic trace (geometry/fermat.py, field_evaluator's
// "quadratic" branch). The reference has no operator on this model.
//
// Bound on the H100: a gather. Each evaluation reads 9 rows x 3 z taps x
// 4 B = 108 B scattered over 9 rows of the (nx*ny, nz) table of
// prefiltered coefficients, against ~190 flops of weights and contraction.
//
// Design: K5's (cubic_value_grad.cu). One thread per point, which loads
// only the 3 taps it needs of each row, so the (N, 9, nz) pencil block is
// never built; the evaluator is quad_eval.cuh, shared with the tracer K1q.
// 32 threads a block, the size chip_smoke.py --e-study measured best for
// the endpoint kernels K1e and K5.
//
// Determinism: no atomics and a fixed summation order per thread, so the
// output is bitwise identical from run to run.
#include "quad_eval.cuh"

namespace {

__global__ void __launch_bounds__(32)
    quad_value_grad_kernel(const float* __restrict__ coef,
                           const float* __restrict__ origin,
                           const float* __restrict__ spacing, int nx, int ny,
                           int nz, const float* __restrict__ points, int n,
                           float* __restrict__ value,
                           float* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const TableGrid g = table_grid(coef, origin, spacing, nx, ny, nz);
  float m, gx, gy, gz;
  quad_value_grad_at(g, points[3 * (size_t)i + 0], points[3 * (size_t)i + 1],
                     points[3 * (size_t)i + 2], m, gx, gy, gz);
  value[i] = m;
  grad[3 * (size_t)i + 0] = gx;
  grad[3 * (size_t)i + 1] = gy;
  grad[3 * (size_t)i + 2] = gz;
}

}  // namespace

extern "C" int ionotomo_quad_value_grad(const float* coef,
                                        const float* origin,
                                        const float* spacing, int nx, int ny,
                                        int nz, const float* points, int n,
                                        float* value, float* grad,
                                        void* stream) {
  if (nx < 3 || ny < 3 || nz < 3) return (int)cudaErrorInvalidValue;
  quad_value_grad_kernel<<<(n + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
      coef, origin, spacing, nx, ny, nz, points, n, value, grad);
  return (int)cudaGetLastError();
}
