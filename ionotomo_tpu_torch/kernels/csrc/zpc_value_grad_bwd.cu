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
// Bound on the H100: bytes, and at a solve's few endpoints latency. 140,000
// live pairs at config 4, each ~40 flops after ~100 of point set-up; the
// touched cells are few (a touched row holds 3-5 touched z of 256). The
// function reads the points and the cotangents once and reads and writes
// each touched cell once. What the first design (K5^T's scheme,
// row_reduce::add_segment_into: one warp a used segment) spent its time on
// was neither: each warp ran a chain of five dependent loads (seg_row;
// row_seg, offsets and z0_range; order; the point; the table) before and
// around a few pairs, and at config 4 all but 619 of its 31,649 used
// segments (the far endpoints' rows) hold 1-3 pairs, so most lanes idled.
//
// Design: the plan of occupied rows (core/zpcubic.py:endpoint_plan, built
// once per operator by core/tricubic.py:build_row_plan(occupied_rows=True)
// over the (endpoint, translate) pairs, ids n*8 + t, t < 7: the
// zero-weight pad is skipped) carries a task list (core/tricubic.py:
// with_tasks), one int4 a task, so a task's bounds are one 16-byte load:
// - whole short rows (one segment, at most 32 pairs), consecutive in the
//   plan, gathered greedily into tasks of at most 32 pairs whose z spans
//   fit the warp's nz floats of shared memory: a lane a pair, the lanes
//   of a row reducing over their sorted run;
// - each segment of a longer row (the antennas' rows, where 100 start
//   points share a cell) as one task, reduced as add_segment_into reduces
//   it, its ticket and fold included; these first, the rows of most
//   segments first.
// A warp a task (row_reduce::add_task_into). The grid holds 3 blocks of 8
// warps an SM; a warp takes the task of its rank, and only tasks past the
// grid go out through an int counter, as warps come free (at config 4's
// 2,933 tasks none). A lane recomputes its pair's weights with the
// evaluator of K6z and K1z (zpc_eval.cuh), so no per-point weights are
// stored. Every cell adds its sum as
// add_segment_into adds it (table[row, z] += sum once per touched cell,
// the same scan tree and fold), so the result is bitwise the first
// design's over the same plan, and each cell is rounded as table + (the
// transpose alone). No float atomics: bitwise reproducible; the integer
// counters only decide which warp does a task or a fold.
//
// A build with -DK6ZT_SEGMENT_CHAIN=1 is the first design, launch
// included (add_segment_into, one warp a used segment, 4 blocks an SM):
// the bitwise reference of the card tests and of chip_smoke.py
// --k6zt-study.
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
    int row;
    contributions(in, row, z, c);
  }
  // ... and the pair's table row (INT_MAX without a pair)
  __device__ __forceinline__ void contributions(const In& in, int& row,
                                                int (&z)[4],
                                                float (&c)[4]) const {
    if (in.t < 0) {
      row = INT_MAX;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        z[l] = INT_MAX;
        c[l] = 0.0f;
      }
      return;
    }
    ZpcPoint p;
    zpc_setup(g, in.x, in.y, in.z, p);
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

#ifdef K6ZT_SEGMENT_CHAIN
// The first design: one used segment of the plan a warp,
// row_reduce::add_segment_into over the row's span, with K5^T's register
// budget.
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
#else
// The launch: 3 blocks of 8 warps an SM (80 registers), which measured
// faster than K5^T's 4 (64 registers) at config 4's endpoints and at the
// edge-case points (PERF.md §6, the K6z^T study).
constexpr int kBlocksPerSm = 3;

// Each warp takes the warp task of its rank, and only tasks past the grid
// go out through an int counter (sched[0]), as warps come free; the last
// block to finish (sched[1] counts them) puts both back to zero.
__global__ void __launch_bounds__(256, kBlocksPerSm)
    zpc_value_grad_bwd_kernel(
        const float* __restrict__ origin, const float* __restrict__ spacing,
        int nx, int ny, int nz, const float* __restrict__ points,
        const float* __restrict__ cv, const float* __restrict__ cg,
        row_reduce::Plan plan, const int4* __restrict__ tasks,
        const int* __restrict__ n_tasks, int* sched,
        float* __restrict__ table) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  float* srow = smem + (threadIdx.x >> 5) * nz;
  const ZpcPair pair{table_grid(nullptr, origin, spacing, nx, ny, nz),
                     points, cv, cg};
  const int used = __ldg(n_tasks);
  const int warps = gridDim.x * row_reduce::kWarpsPerBlock;
  for (int q = blockIdx.x * row_reduce::kWarpsPerBlock + (threadIdx.x >> 5);
       q < used;) {
    const int4 task = __ldg(tasks + q);
    row_reduce::add_task_into<4>(plan, task, nz, srow, table, pair);
    if (used <= warps) break;  // no task past the grid
    int next = 0;
    if (lane == 0) next = atomicAdd(sched, 1);
    q = warps + __shfl_sync(row_reduce::kFullMask, next, 0);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(sched + 1, 1) == (int)gridDim.x - 1)
      sched[0] = sched[1] = 0;
  }
}
#endif

}  // namespace

// table += K6z^T(cv, cg): points (N, 3); cv (N,); cg (N, 3); the plan of
// occupied rows over the flat (point, translate) pair ids n*8 + t, t < 7:
// order (7 N,), offsets and row_seg (nx*ny+1,), seg_row (n_seg_max,),
// counters (nx*ny,) at zero, z0_range (nx*ny, 2) each row's least and
// greatest cell base, its task list tasks (n_seg_max, 4), n_tasks (1,)
// the tasks used, and sched (2,) at zero (left at zero); partials
// (n_seg_max, nz) scratch; table (nx*ny, nz), read and written only at
// the touched z span of each occupied row.
extern "C" int ionotomo_zpc_value_grad_bwd(
    const float* origin, const float* spacing, int nx, int ny, int nz,
    const float* points, const float* cv, const float* cg, const int* order,
    const int* offsets, const int* seg_row, const int* row_seg, int* counters,
    const int* z0_range, const int* tasks, const int* n_tasks, int* sched,
    int n_seg_max, int chunk, float* partials, float* table, void* stream) {
  if (nx < 3 || ny < 3 || nz < 3 || n_seg_max < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const row_reduce::Plan plan{order,    offsets, seg_row,   row_seg, counters,
                              partials, nx * ny, n_seg_max, chunk};
#ifdef K6ZT_SEGMENT_CHAIN
  zpc_value_grad_bwd_kernel<<<row_reduce::blocks_for(n_seg_max),
                              32 * row_reduce::kWarpsPerBlock,
                              row_reduce::smem_bytes(nz),
                              (cudaStream_t)stream>>>(
      origin, spacing, nx, ny, nz, points, cv, cg, plan, z0_range, table);
#else
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int blocks = min(row_reduce::blocks_for(n_seg_max),
                         max(sms, 1) * kBlocksPerSm);
  zpc_value_grad_bwd_kernel<<<blocks, 32 * row_reduce::kWarpsPerBlock,
                              row_reduce::smem_bytes(nz),
                              (cudaStream_t)stream>>>(
      origin, spacing, nx, ny, nz, points, cv, cg, plan,
      reinterpret_cast<const int4*>(tasks), n_tasks, sched, table);
#endif
  return (int)cudaGetLastError();
}
