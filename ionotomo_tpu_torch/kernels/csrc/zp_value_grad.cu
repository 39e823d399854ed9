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
// (row, z) tap of 8 members is one aligned 32-byte sector), and LANES
// lanes of a warp a point, 8 / LANES members a lane: each lane makes the
// point's set-up with the same arithmetic and contracts its own members
// (zp_value_grad_members_from, each member's sums term for term those of
// one table, so member b is bitwise K1e on table b), and the LANES lanes'
// loads of one tap are one sector. The first design (one thread a point
// and all 8 members, 32 threads a block) ran 8 members' contractions in
// series through the live rows, a long dependent chain over few warps:
// 625 one-warp blocks at 20,000 points, 0.30 of its byte bound. More lanes
// a point cut each lane's chain and multiply the warps, at the cost of
// repeating the set-up; kernels.zp_batched_lanes picks LANES from the
// points an SM (chip_smoke.py --member-study). The translates are
// zp_translate_unrolled's: zp_translate's read 0.3-40 % slower at every
// lanes and size swept, most at 8 lanes (NVIDIA H100 80GB HBM3, 700 W).
//
// Determinism: no atomics and a fixed summation order per thread, so the
// output is bitwise identical from run to run.
#include "zp_eval.cuh"

// Threads a block of K1e (a multiple of 32; the study builds the library
// again with others). chip_smoke.py --e-study, NVIDIA H100 80GB HBM3,
// 700 W, device ms at 32 / 64 / 128 / 256 threads: K1e at config 3b's and
// 5's 20,000 endpoints 0.0029 / 0.0032 / 0.0035 / 0.0034, at serving's
// 1,240 0.0022 / 0.0026 / 0.0028 / 0.0032. Sorting the endpoints by their
// base cell gained nothing.
#ifndef ZP_VALUE_GRAD_THREADS
#define ZP_VALUE_GRAD_THREADS 32
#endif
// The batched kernel's launch floor: its grid with an empty body
// (chip_smoke.py --member-study builds a library with it set to 1).
#ifndef K1EB_LAUNCH_FLOOR
#define K1EB_LAUNCH_FLOOR 0
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

// The M = 8 / LANES consecutive members of a packed tap that a lane
// reads: M floats from a 4*M-byte boundary, in one load.
template <int M>
__device__ __forceinline__ void load_members(const float* p, float (&c)[M]) {
  static_assert(M == 1 || M == 2, "a lane reads one or two members");
  if constexpr (M == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    c[0] = v.x, c[1] = v.y;
  } else {
    c[0] = __ldg(p);
  }
}

// LANES lanes a point (consecutive lanes of a warp), lane sub of a point
// its members sub*M .. sub*M + M - 1 of the group blockIdx.y; value (B,
// n), grad (B, n, 3).
template <int LANES>
__global__ void __launch_bounds__(256) zp_value_grad_batched_kernel(
    const float* __restrict__ packed, int n_members,
    const float* __restrict__ origin, const float* __restrict__ spacing,
    int nx, int ny, int nz, const float* __restrict__ points, int n,
    float* __restrict__ value, float* __restrict__ grad) {
  constexpr int M = kGroup / LANES;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = t / LANES, sub = t % LANES;
  if (K1EB_LAUNCH_FLOOR || i >= n) return;
  const TableGrid g = table_grid(nullptr, origin, spacing, nx, ny, nz);
  ZpPoint q;
  zp_setup(g, points[3 * (size_t)i + 0], points[3 * (size_t)i + 1],
           points[3 * (size_t)i + 2], q);
  const float* tg =
      packed + (size_t)blockIdx.y * (size_t)nx * ny * nz * kGroup + sub * M;
  float m[M], gx[M], gy[M], gz[M];
  zp_value_grad_members_from<M, true>(
      g, q,
      [&](int r, int bz, float (&c)[3][M]) {
        // bz lies in [1, nz-2]: the 3 taps, each this lane's M members
        const float* p = tg + ((size_t)r * nz + (size_t)(bz - 1)) * kGroup;
#pragma unroll
        for (int l = 0; l < 3; ++l) load_members<M>(p + l * kGroup, c[l]);
      },
      m, gx, gy, gz);
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int b = blockIdx.y * kGroup + sub * M + k;
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
// lanes (4 or 8) a point, threads (a multiple of 32, at most 256) a
// block; value (B, n), grad (B, n, 3).
extern "C" int ionotomo_zp_value_grad_batched(
    const float* packed, int n_members, const float* origin,
    const float* spacing, int nx, int ny, int nz, const float* points, int n,
    int lanes, int threads, float* value, float* grad, void* stream) {
  const int groups = (n_members + kGroup - 1) / kGroup;
  if (n_members < 1 || groups > 65535 || threads < 32 || threads > 256 ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 blocks(
      (unsigned)(((long long)n * lanes + threads - 1) / threads), groups);
  cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 4:
      zp_value_grad_batched_kernel<4><<<blocks, threads, 0, s>>>(
          packed, n_members, origin, spacing, nx, ny, nz, points, n, value,
          grad);
      break;
    case 8:
      zp_value_grad_batched_kernel<8><<<blocks, threads, 0, s>>>(
          packed, n_members, origin, spacing, nx, ny, nz, points, n, value,
          grad);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The text of a CUDA error code returned by any launch of this library.
extern "C" const char* ionotomo_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
