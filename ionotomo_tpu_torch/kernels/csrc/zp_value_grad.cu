// K1e: zp value and physical gradient at N points, of one table or of the
// B tables of an ensemble's members.
//
// Replaces: ionotomo_tpu/core/boxspline.py, interp_rows_with_grad (the
// 8-row gather + xy-first contraction that the JAX package wrote below
// jnp), and what jax.vmap over the members makes of it in the ensemble
// filter (ionotomo_tpu/inversion/kalman.py, the member update). It serves
// the Hermite endpoint derivatives (forward/tec.py: _endpoint_dne_ds and
// the linearised operator's endpoint terms) and the rk4 tracer's field
// evaluator.
//
// Bound on the H100: a gather. Each evaluation reads 7 live rows x 3
// z-taps x 4 B = 84 B scattered over 7 rows of the (nx*ny, nz) table,
// against ~150 flops of weights and contraction, so it is latency- and
// L2-bound, far below the flop peak. The main paths evaluate 20,000
// endpoints (10,000 rays) or serving's 1,240: a launch is a few
// microseconds, and how many SMs it reaches decides its time.
//
// Design: one thread per point. The reference gathers whole nz-deep rows
// and contracts them against a dense band of 3 nonzeros; here each thread
// loads only the 3 taps it needs of each live row, so the (N, 8, nz)
// pencil is never built. The weights come from __constant__ tables
// (uniform across a warp, so broadcast). The 50 MB L2 holds a 128^3
// table (8 MiB) whole. The block is small (ZP_VALUE_GRAD_THREADS) so that
// 20,000 points spread over every SM (chip_smoke.py --e-study).
//
// Member axis (zp_value_grad_batched): the tables packed member-innermost
// (pack_members in rows_value_fwd_batched.cu, the layout K2b reads: one
// (row, z) tap of 8 members is one aligned 32-byte sector, two float4
// loads), and one thread per (point, group of 8 members): the point's
// set-up is made once and contracted for all 8 members
// (zp_value_grad_members_from), each member's sums term for term those of
// one table, so member b is bitwise K1e on table b.
//
// Determinism: no atomics and a fixed summation order per thread, so the
// output is bitwise identical from run to run.
#include "zp_eval.cuh"

// Threads a block (a multiple of 32; the study builds the library again
// with others). chip_smoke.py --e-study, NVIDIA H100 80GB HBM3, 700 W,
// device ms at 32 / 64 / 128 / 256 threads: K1e at config 3b's and 5's
// 20,000 endpoints 0.0029 / 0.0032 / 0.0035 / 0.0034, at serving's 1,240
// 0.0022 / 0.0026 / 0.0028 / 0.0032; the batched K1e, 8 members at the
// 20,000, 0.0052 / 0.0055 / 0.0071 / 0.0070 (8 launches of K1e at 256:
// 0.0287). Sorting the endpoints by their base cell gained nothing.
#ifndef ZP_VALUE_GRAD_THREADS
#define ZP_VALUE_GRAD_THREADS 32
#endif
#ifndef ZP_VALUE_GRAD_BATCHED_THREADS
#define ZP_VALUE_GRAD_BATCHED_THREADS 32
#endif

namespace {

constexpr int kGroup = 8;  // members one packed tap holds

__global__ void __launch_bounds__(ZP_VALUE_GRAD_THREADS)
    zp_value_grad_kernel(const float* __restrict__ coef,
                         const float* __restrict__ origin,
                         const float* __restrict__ spacing, int nx, int ny,
                         int nz, const float* __restrict__ points, int n,
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

// blockIdx.y: the group of 8 members; value (B, n), grad (B, n, 3).
__global__ void __launch_bounds__(ZP_VALUE_GRAD_BATCHED_THREADS)
    zp_value_grad_batched_kernel(const float* __restrict__ packed,
                                 int n_members,
                                 const float* __restrict__ origin,
                                 const float* __restrict__ spacing, int nx,
                                 int ny, int nz,
                                 const float* __restrict__ points, int n,
                                 float* __restrict__ value,
                                 float* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const TableGrid g = table_grid(nullptr, origin, spacing, nx, ny, nz);
  ZpPoint q;
  zp_setup(g, points[3 * (size_t)i + 0], points[3 * (size_t)i + 1],
           points[3 * (size_t)i + 2], q);
  const float* tg =
      packed + (size_t)blockIdx.y * (size_t)nx * ny * nz * kGroup;
  float m[kGroup], gx[kGroup], gy[kGroup], gz[kGroup];
  zp_value_grad_members_from<kGroup>(
      g, q,
      [&](int r, int bz, float (&c)[3][kGroup]) {
        // bz lies in [1, nz-2]: the 3 taps of 8 members, 96 contiguous
        // bytes from a 32-byte boundary
        const float4* p = reinterpret_cast<const float4*>(
            tg + ((size_t)r * nz + (size_t)(bz - 1)) * kGroup);
#pragma unroll
        for (int l = 0; l < 3; ++l) {
          const float4 lo = __ldg(p + 2 * l);
          const float4 hi = __ldg(p + 2 * l + 1);
          c[l][0] = lo.x, c[l][1] = lo.y, c[l][2] = lo.z, c[l][3] = lo.w;
          c[l][4] = hi.x, c[l][5] = hi.y, c[l][6] = hi.z, c[l][7] = hi.w;
        }
      },
      m, gx, gy, gz);
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    const int b = blockIdx.y * kGroup + k;
    if (b < n_members) {
      const size_t j = (size_t)b * n + i;
      value[j] = m[k];
      grad[3 * j + 0] = gx[k];
      grad[3 * j + 1] = gy[k];
      grad[3 * j + 2] = gz[k];
    }
  }
}

}  // namespace

extern "C" int ionotomo_zp_value_grad(const float* coef, const float* origin,
                                      const float* spacing, int nx, int ny,
                                      int nz, const float* points, int n,
                                      float* value, float* grad,
                                      void* stream) {
  const int threads = ZP_VALUE_GRAD_THREADS;
  const int blocks = (n + threads - 1) / threads;
  zp_value_grad_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      coef, origin, spacing, nx, ny, nz, points, n, value, grad);
  return (int)cudaGetLastError();
}

// packed (ceil(B/8), nx*ny*nz, 8): the B tables member-innermost
// (ionotomo_pack_members of the (B, nx*ny*nz) tables); points (n, 3);
// value (B, n), grad (B, n, 3).
extern "C" int ionotomo_zp_value_grad_batched(
    const float* packed, int n_members, const float* origin,
    const float* spacing, int nx, int ny, int nz, const float* points, int n,
    float* value, float* grad, void* stream) {
  const int groups = (n_members + kGroup - 1) / kGroup;
  if (n_members < 1 || groups > 65535) return (int)cudaErrorInvalidValue;
  const int threads = ZP_VALUE_GRAD_BATCHED_THREADS;
  const dim3 blocks((n + threads - 1) / threads, groups);
  zp_value_grad_batched_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      packed, n_members, origin, spacing, nx, ny, nz, points, n, value, grad);
  return (int)cudaGetLastError();
}

// The text of a CUDA error code returned by any launch of this library.
extern "C" const char* ionotomo_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
