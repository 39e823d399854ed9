// K5: tricubic value and physical gradient at N points.
//
// Replaces: ionotomo_tpu/core/tricubic.py, interp_rows_with_grad (:529-562,
// the 16-pencil row gather contracted against two dense z bands that the
// JAX package wrote below jnp). It serves the Hermite endpoint derivatives
// of the cubic model (forward/tec.py, _endpoint_dne_ds), the endpoint terms
// of the linearised dTEC operator, and the rk4 tracer's field evaluator.
//
// Bound on the H100: a gather. Each evaluation reads 16 rows x 4 z-taps x
// 4 B = 256 B from 16 scattered rows of the (nx*ny, nz) table (one 16-byte
// span per row, except where the edge clamp repeats a tap), against ~520
// flops of weights and contraction. A 128^3 table (8 MiB) stays in the
// 50 MB L2; a 256^3 table (64 MiB) does not.
//
// Design: one thread per point, 64 scalar loads. The reference gathers
// whole nz-deep rows and contracts them against dense bands of 4 nonzeros;
// here each thread loads only the taps it needs, so the (N, 16, nz) pencil
// block is never built. The evaluator is cubic_eval.cuh, shared with the
// cubic tracer K1c and the transpose K5^T.
//
// Determinism: no atomics and a fixed summation order per thread, so the
// output is bitwise identical from run to run.
#include "cubic_eval.cuh"

namespace {

__global__ void cubic_value_grad_kernel(const float* __restrict__ table,
                                        const float* __restrict__ origin,
                                        const float* __restrict__ spacing,
                                        int nx, int ny, int nz,
                                        const float* __restrict__ points,
                                        int n, float* __restrict__ value,
                                        float* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const TableGrid g = table_grid(table, origin, spacing, nx, ny, nz);
  float m, gx, gy, gz;
  cubic_value_grad_at(g, points[3 * (size_t)i + 0], points[3 * (size_t)i + 1],
                      points[3 * (size_t)i + 2], m, gx, gy, gz);
  value[i] = m;
  grad[3 * (size_t)i + 0] = gx;
  grad[3 * (size_t)i + 1] = gy;
  grad[3 * (size_t)i + 2] = gz;
}

}  // namespace

extern "C" int ionotomo_cubic_value_grad(const float* table,
                                         const float* origin,
                                         const float* spacing, int nx, int ny,
                                         int nz, const float* points, int n,
                                         float* value, float* grad,
                                         void* stream) {
  if (nx < 2 || ny < 2 || nz < 2) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  cubic_value_grad_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      table, origin, spacing, nx, ny, nz, points, n, value, grad);
  return (int)cudaGetLastError();
}
