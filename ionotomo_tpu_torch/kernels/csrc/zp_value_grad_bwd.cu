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
// Bound on the H100: bytes, mostly the table it writes (8 MiB at 128^3);
// the pairs are few (140k at config 3b), each ~60 flops of zp weights.
// Like K3 it was bounded by its busiest row, walked serially by one warp
// (16.8 ms at 2^20 edge-case points, where a corner row gets ~260k
// pairs); the segmented plan of row_reduce.cuh bounds every warp's work
// by C pairs.
//
// Design: the plan-and-reduce scheme of K3 (row_reduce.cuh) over the
// (endpoint, translate) pairs, sorted by row and z once per operator, in
// one launch. A lane recomputes the zp weights of its pair's point with
// the evaluator that K1 and K1e use (zp_eval.cuh), so no per-point
// weights are stored; the loads of the next batch's points overlap the
// current batch's arithmetic. The row comes from the plan, which the
// wrapper builds from the same row index arithmetic. No float atomics:
// bitwise reproducible.
#include "row_reduce.cuh"
#include "zp_eval.cuh"

namespace {

struct ZpPair {
  TableGrid g;
  const float* __restrict__ points;
  const float* __restrict__ cv;
  const float* __restrict__ cg;
  int K;  // pair id stride: p = n*K + t (t < 7: the zero pad is skipped)
  struct In {
    int t;  // translate; -1: no pair
    float x, y, z, v, gx, gy, gz;
  };
  __device__ __forceinline__ In load(int p) const {
    In in;
    if (p < 0) {
      in.t = -1;
      in.x = in.y = in.z = in.v = in.gx = in.gy = in.gz = 0.0f;
      return in;
    }
    const int n = p / K;
    in.t = p - n * K;
    in.x = __ldg(points + 3 * (size_t)n + 0);
    in.y = __ldg(points + 3 * (size_t)n + 1);
    in.z = __ldg(points + 3 * (size_t)n + 2);
    in.v = __ldg(cv + n);
    in.gx = __ldg(cg + 3 * (size_t)n + 0);
    in.gy = __ldg(cg + 3 * (size_t)n + 1);
    in.gz = __ldg(cg + 3 * (size_t)n + 2);
    return in;
  }
  __device__ __forceinline__ void contributions(const In& in, int (&z)[3],
                                                float (&c)[3]) const {
    if (in.t < 0) {
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        z[l] = INT_MAX;
        c[l] = 0.0f;
      }
      return;
    }
    ZpPoint q;
    zp_setup(g, in.x, in.y, in.z, q);
    int row;
    float wk, wu, wv;
    zp_translate(g, q, in.t, row, wk, wu, wv);
    const float gx = in.gx / g.sx;
    const float gy = in.gy / g.sy;
    const float gz = in.gz / g.sz;
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      z[l] = q.bz - 1 + l;
      c[l] = wk * (in.v * q.wz[l] + gz * q.dwz[l]) + wu * (gx * q.wz[l])
             + wv * (gy * q.wz[l]);
    }
  }
};

__global__ void zp_value_grad_bwd_kernel(const float* __restrict__ origin,
                                         const float* __restrict__ spacing,
                                         int nx, int ny, int nz,
                                         const float* __restrict__ points,
                                         const float* __restrict__ cv,
                                         const float* __restrict__ cg, int K,
                                         row_reduce::Plan plan,
                                         float* __restrict__ out) {
  extern __shared__ float smem[];
  const ZpPair pair{table_grid(nullptr, origin, spacing, nx, ny, nz), points,
                    cv, cg, K};
  row_reduce::reduce_segment<3>(plan, nz, smem + (threadIdx.x >> 5) * nz,
                                out, pair);
}

}  // namespace

// points (N, 3); cv (N,); cg (N, 3); the plan over the flat (point,
// translate) pair ids n*K + t: order (P,), offsets and row_seg
// (nx*ny+1,), seg_row (n_seg_max,), counters (nx*ny,) at zero; partials
// (n_seg_max, nz) scratch; out (nx*ny, nz), fully written.
extern "C" int ionotomo_zp_value_grad_bwd(
    const float* origin, const float* spacing, int nx, int ny, int nz,
    const float* points, const float* cv, const float* cg, int K,
    const int* order, const int* offsets, const int* seg_row,
    const int* row_seg, int* counters, int n_seg_max, int chunk,
    float* partials, float* out, void* stream) {
  if (K < 1 || K > 8 || nx < 3 || ny < 3 || nz < 3 ||
      n_seg_max < nx * ny || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const row_reduce::Plan plan{order,    offsets, seg_row,   row_seg, counters,
                              partials, nx * ny, n_seg_max, chunk};
  zp_value_grad_bwd_kernel<<<row_reduce::blocks_for(n_seg_max),
                             32 * row_reduce::kWarpsPerBlock,
                             row_reduce::smem_bytes(nz),
                             (cudaStream_t)stream>>>(
      origin, spacing, nx, ny, nz, points, cv, cg, K, plan, out);
  return (int)cudaGetLastError();
}
