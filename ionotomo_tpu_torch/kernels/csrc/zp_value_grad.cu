// K1e: zp value and physical gradient at N points.
//
// Replaces: ionotomo_tpu/core/boxspline.py, interp_rows_with_grad (the
// 8-row gather + xy-first contraction that the JAX package wrote below
// jnp). In the bent-ray slice it serves the Hermite endpoint derivatives
// (forward/tec.py, _endpoint_dne_ds) and the rk4 tracer's field evaluator.
//
// Bound on the H100: a gather. Each evaluation reads 7 live rows x 3
// z-taps x 4 B = 84 B scattered over 7 rows of the (nx*ny, nz) table,
// against ~150 flops of weights and contraction, so it is latency- and
// L2-bound, far below the flop peak.
//
// Design: one thread per point. The reference gathers whole nz-deep rows
// and contracts them against a dense band of 3 nonzeros; here each thread
// loads only the 3 taps it needs of each live row, so the (N, 8, nz)
// pencil is never built. The weights come from __constant__ tables
// (uniform across a warp, so broadcast). The 50 MB L2 holds a 128^3
// table (8 MiB) whole.
//
// Determinism: no atomics and a fixed summation order per thread, so the
// output is bitwise identical from run to run.
#include "zp_eval.cuh"

namespace {

__global__ void zp_value_grad_kernel(const float* __restrict__ coef,
                                     const float* __restrict__ origin,
                                     const float* __restrict__ spacing,
                                     int nx, int ny, int nz,
                                     const float* __restrict__ points, int n,
                                     float* __restrict__ value,
                                     float* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const TableGrid g = table_grid(coef, origin, spacing, nx, ny, nz);
  float m, gx, gy, gz;
  zp_value_grad_at(g, points[3 * i + 0], points[3 * i + 1], points[3 * i + 2],
                   m, gx, gy, gz);
  value[i] = m;
  grad[3 * i + 0] = gx;
  grad[3 * i + 1] = gy;
  grad[3 * i + 2] = gz;
}

}  // namespace

extern "C" int ionotomo_zp_value_grad(const float* coef, const float* origin,
                                      const float* spacing, int nx, int ny,
                                      int nz, const float* points, int n,
                                      float* value, float* grad,
                                      void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  zp_value_grad_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      coef, origin, spacing, nx, ny, nz, points, n, value, grad);
  return (int)cudaGetLastError();
}

// The text of a CUDA error code returned by any launch of this library.
extern "C" const char* ionotomo_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
