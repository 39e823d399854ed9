// K1e^T: transpose of K1e (zp value + physical gradient at points) with
// respect to the coefficient table. Given a value cotangent cv (N,) and
// a gradient cotangent cg (N, 3), it scatters into the 7 live rows x 3 z
// taps of each point
//   wxy_k (cv qb_l + cg_z/s_z dqb_l) + wu_k (cg_x/s_x) qb_l
//                                    + wv_k (cg_y/s_y) qb_l.
//
// Replaces: the transpose XLA derives from the gather in
// ionotomo_tpu/core/boxspline.py, interp_rows_with_grad (:253-282). In
// the inversion slice it carries the Hermite endpoint terms of the
// linearised dTEC operator's transpose: 2R = 20k endpoints at config 3b.
//
// Bound on the H100: like K3 (rows_value_bwd.cu), the busiest row of a
// serial per-row reduction; at 20k points it is a few microseconds of
// work and launch latency dominates.
//
// Design: the plan-and-reduce scheme of K3 (row_reduce.cuh) over the
// (endpoint, translate) pairs, sorted by row once per operator. A lane
// recomputes the zp weights of its pair's point with the evaluator that
// K1 and K1e use (zp_eval.cuh), so no per-point weights are stored. The
// row comes from the plan, which the wrapper builds from the same row
// index arithmetic. No float atomics: bitwise reproducible.
#include "row_reduce.cuh"
#include "zp_eval.cuh"

namespace {

struct ZpPair {
  ZpGrid g;
  const float* __restrict__ points;
  const float* __restrict__ cv;
  const float* __restrict__ cg;
  int K;  // translates per point in the plan (7: the zero pad is skipped)
  __device__ __forceinline__ void operator()(int p, int (&z)[3],
                                             float (&c)[3]) const {
    const int n = p / K;
    const int k = p - n * K;
    ZpPoint q;
    zp_setup(g, points[3 * n + 0], points[3 * n + 1], points[3 * n + 2], q);
    int row;
    float wk, wu, wv;
    zp_translate(g, q, k, row, wk, wu, wv);
    const float v = cv[n];
    const float gx = cg[3 * n + 0] / g.sx;
    const float gy = cg[3 * n + 1] / g.sy;
    const float gz = cg[3 * n + 2] / g.sz;
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      z[l] = q.bz - 1 + l;
      c[l] = wk * (v * q.wz[l] + gz * q.dwz[l]) + wu * (gx * q.wz[l])
             + wv * (gy * q.wz[l]);
    }
  }
};

__global__ void zp_value_grad_bwd_kernel(const float* __restrict__ origin,
                                         const float* __restrict__ spacing,
                                         int nx, int ny, int nz,
                                         const float* __restrict__ points,
                                         const float* __restrict__ cv,
                                         const float* __restrict__ cg,
                                         const int* __restrict__ order,
                                         const int* __restrict__ offsets,
                                         int K, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int n_rows = nx * ny;
  const int row = blockIdx.x * row_reduce::kWarpsPerBlock + warp;
  if (row >= n_rows) return;
  const ZpPair pair{zp_grid(nullptr, origin, spacing, nx, ny, nz), points,
                    cv, cg, K};
  row_reduce::reduce_row<3>(row, order, offsets, nz, smem + warp * nz,
                            out + (size_t)row * (size_t)nz, pair);
}

}  // namespace

// points (N, 3); cv (N,); cg (N, 3); order (N*K,) flat (point, translate)
// pair ids sorted by row; offsets (nx*ny+1,); out (nx*ny, nz), fully
// written.
extern "C" int ionotomo_zp_value_grad_bwd(const float* origin,
                                          const float* spacing, int nx,
                                          int ny, int nz,
                                          const float* points,
                                          const float* cv, const float* cg,
                                          const int* order,
                                          const int* offsets, int K,
                                          float* out, void* stream) {
  if (K < 1 || K > 8 || nx < 3 || ny < 3 || nz < 3)
    return (int)cudaErrorInvalidValue;
  zp_value_grad_bwd_kernel<<<row_reduce::blocks_for(nx * ny),
                             32 * row_reduce::kWarpsPerBlock,
                             row_reduce::smem_bytes(nz),
                             (cudaStream_t)stream>>>(
      origin, spacing, nx, ny, nz, points, cv, cg, order, offsets, K, out);
  return (int)cudaGetLastError();
}
