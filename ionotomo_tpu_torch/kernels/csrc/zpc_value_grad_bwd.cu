// K6z^T: transpose of K6z (zpc value + physical gradient at points) with
// respect to the table, added into a table in place. Given a value
// cotangent cv (N,) and a gradient cotangent cg (N, 3), it adds into the 7
// live rows t x 4 z taps l of each point
//   w_t (cv wz_l + cg_z/h_z dwz_l) + wu_t cg_x/h_x wz_l + wv_t cg_y/h_y wz_l
// with the zp translate weights w_t, wu_t, wv_t and the Catmull-Rom z
// weights wz_l, dwz_l (those of two clamped taps on one lane merged, as
// zpc_eval.cuh merges them).
//
// Replaces: the transpose XLA derives from the gather in
// ionotomo_tpu/core/zpcubic.py, interp_rows_with_grad (:108-129), which
// jax.linear_transpose reaches through the Hermite endpoint terms of the
// linearised dTEC operator (inversion/solvers.py:88-121) on zpc: Jᵀ's
// endpoint terms in the inner Jacobian of the config-4 solve with
// interp_inner="zpc2", 2R = 20,000 endpoints into a (65536, 256) table.
//
// Bound on the H100: bytes, and at a solve's few endpoints mostly
// latency, as K5^T's. 140,000 live pairs at config 4, each ~40 flops
// after ~100 of point set-up; the touched cells are few (a touched row
// holds 3-5 touched z of 256). The function reads the points and the
// cotangents once and reads and writes each touched cell once.
//
// Design: K5^T's (cubic_value_grad_bwd.cu), not K1e^T's, because K1e^T
// writes a whole table that the caller then adds, and loses to
// index_add_ (chip_smoke.py, phase 6). The plan-and-reduce scheme of
// row_reduce.cuh over the (endpoint, translate) pairs, ids n*8 + t (t <
// 7: the zero-weight pad is skipped), sorted by row and cell base once
// per operator over a plan of occupied rows (core/zpcubic.py:
// endpoint_plan, built by core/tricubic.py:build_row_plan(
// occupied_rows=True)); one launch, each
// warp reducing one segment over its row's z span and adding the sum into
// the table it is given (row_reduce::add_segment_into, shared with
// K5^T): table[row, z] += sum once per touched cell, so each cell rounds
// as table + (the transpose alone). A lane recomputes its pair's weights
// with the evaluator of K6z and K1z (zpc_eval.cuh), so no per-point
// weights are stored. No float atomics: bitwise reproducible.
#include "row_reduce.cuh"
#include "zpc_eval.cuh"

namespace {

struct ZpcPair {
  TableGrid g;
  const float* __restrict__ points;
  const float* __restrict__ cv;
  const float* __restrict__ cg;
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
    const int n = p >> 3;
    in.t = p & 7;
    in.x = __ldg(points + 3 * (size_t)n + 0);
    in.y = __ldg(points + 3 * (size_t)n + 1);
    in.z = __ldg(points + 3 * (size_t)n + 2);
    in.v = __ldg(cv + n);
    in.gx = __ldg(cg + 3 * (size_t)n + 0);
    in.gy = __ldg(cg + 3 * (size_t)n + 1);
    in.gz = __ldg(cg + 3 * (size_t)n + 2);
    return in;
  }
  __device__ __forceinline__ void contributions(const In& in, int (&z)[4],
                                                float (&c)[4]) const {
    if (in.t < 0) {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        z[l] = INT_MAX;
        c[l] = 0.0f;
      }
      return;
    }
    ZpcPoint p;
    zpc_setup(g, in.x, in.y, in.z, p);
    int row;
    float wk, wu, wv;
    zp_translate(g, p.q, in.t, row, wk, wu, wv);
    const float gx = in.gx / g.sx;
    const float gy = in.gy / g.sy;
    const float gz = in.gz / g.sz;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      z[l] = p.az.i[l];
      c[l] = wk * (in.v * p.az.w[l] + gz * p.az.dw[l])
             + wu * (gx * p.az.w[l]) + wv * (gy * p.az.w[l]);
    }
  }
};

// One used segment of the plan a warp: row_reduce::add_segment_into over
// the row's span, added into table (n_rows, nz). The register budget is
// K5^T's (chip_smoke.py --k5t-study).
__global__ void __launch_bounds__(256, 4)
    zpc_value_grad_bwd_kernel(
        const float* __restrict__ origin, const float* __restrict__ spacing,
        int nx, int ny, int nz, const float* __restrict__ points,
        const float* __restrict__ cv, const float* __restrict__ cg,
        row_reduce::Plan plan, const int* __restrict__ z0_range,
        float* __restrict__ table) {
  extern __shared__ float smem[];
  const ZpcPair pair{table_grid(nullptr, origin, spacing, nx, ny, nz),
                     points, cv, cg};
  row_reduce::add_segment_into<4>(plan, z0_range, nz,
                                  smem + (threadIdx.x >> 5) * nz, table,
                                  pair);
}

}  // namespace

// table += K6z^T(cv, cg): points (N, 3); cv (N,); cg (N, 3); the plan of
// occupied rows over the flat (point, translate) pair ids n*8 + t, t < 7:
// order (7 N,), offsets and row_seg (nx*ny+1,), seg_row (n_seg_max,),
// counters (nx*ny,) at zero, z0_range (nx*ny, 2) each row's least and
// greatest cell base; partials (n_seg_max, nz) scratch; table (nx*ny, nz),
// read and written only at the touched z span of each occupied row.
extern "C" int ionotomo_zpc_value_grad_bwd(
    const float* origin, const float* spacing, int nx, int ny, int nz,
    const float* points, const float* cv, const float* cg, const int* order,
    const int* offsets, const int* seg_row, const int* row_seg, int* counters,
    const int* z0_range, int n_seg_max, int chunk, float* partials,
    float* table, void* stream) {
  if (nx < 3 || ny < 3 || nz < 3 || n_seg_max < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const row_reduce::Plan plan{order,    offsets, seg_row,   row_seg, counters,
                              partials, nx * ny, n_seg_max, chunk};
  zpc_value_grad_bwd_kernel<<<row_reduce::blocks_for(n_seg_max),
                              32 * row_reduce::kWarpsPerBlock,
                              row_reduce::smem_bytes(nz),
                              (cudaStream_t)stream>>>(
      origin, spacing, nx, ny, nz, points, cv, cg, plan, z0_range, table);
  return (int)cudaGetLastError();
}
