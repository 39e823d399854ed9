// K5^T: transpose of K5 (tricubic value + physical gradient at points) with
// respect to the table. Given a value cotangent cv (N,) and a gradient
// cotangent cg (N, 3), it scatters into the 16 rows (a, b) x 4 z taps l of
// each point
//   cv wx_a wy_b wz_l + cg_x/h_x dwx_a wy_b wz_l + cg_y/h_y wx_a dwy_b wz_l
//                     + cg_z/h_z wx_a wy_b dwz_l.
//
// Replaces: the transpose XLA derives from the gather in
// ionotomo_tpu/core/tricubic.py, interp_rows_with_grad (:529-562), which
// jax.linear_transpose reaches through the Hermite endpoint terms of the
// linearised dTEC operator (inversion/solvers.py:88-121). At config 4 it
// carries 2R = 20,000 endpoints into a (65536, 256) table.
//
// Bound on the H100: bytes, and at a solve's few endpoints mostly latency.
// The pairs are few (320,000 at config 4, 20,000 points), each ~30 flops
// after ~135 of point set-up, and they touch few cells: the start points
// of a bundle sit on its antennas at the bottom of the grid, the ends at
// the top, so a touched row holds 3-4 touched z of 256. The function reads
// the points and cotangents once and reads and writes each touched cell
// once.
//
// Design: the plan-and-reduce scheme of K3 and K1e^T (row_reduce.cuh) over
// the (endpoint, pencil) pairs, ids n*16 + 4a + b, sorted by row and cell
// base once per operator, in one launch, over a plan of occupied rows only
// (core/tricubic.py:endpoint_plan): no segment for an empty row, and each
// row's least and greatest cell base, so the warp of a segment knows the
// z span [lo, hi] its row's pairs touch. A warp reduces its segment as
// reduce_segment does (batches in plan order, the same scan tree, the
// segments of a long row folded in segment order by the last of them), but
// only over the span, and then adds the sum into the table it is given,
// table[row, z] += sum, once per touched cell: the kernel accumulates into
// the caller's table (the linearised operator passes K3's fresh output),
// and each cell is rounded exactly as K3 + (the sum in a zeroed table),
// the former kernel followed by an elementwise add, rounds it. The launch
// gives a warp to every segment the plan's static bound allows; the count
// of used segments is the plan's last row_seg, on the device, and a warp
// past it returns at once. At a solve's endpoints each segment is a chain
// of dependent loads (its row, its bounds, its pair ids, its points, the
// table), so the time follows the resident warps: a register budget of 4
// blocks of 256 an SM (64 registers, 32 warps) against the compiler's own
// choice is measured by chip_smoke.py --k5t-study. All 16 rows are live.
// A lane recomputes the weights of its pair's point with
// the evaluator that K5 and K1c use (cubic_eval.cuh), so no per-point
// weights are stored. The row comes from the plan, which the wrapper
// builds from the same index arithmetic; where the edge clamp repeats a
// row or a tap, the repeated pairs and taps each add their share, as the
// reference's scatter does. No float atomics: bitwise reproducible.
#include "cubic_eval.cuh"
#include "row_reduce.cuh"

namespace {

struct CubicPair {
  TableGrid g;
  const float* __restrict__ points;
  const float* __restrict__ cv;
  const float* __restrict__ cg;
  struct In {
    int k;  // pencil 4a + b; -1: no pair
    float x, y, z, v, gx, gy, gz;
  };
  __device__ __forceinline__ In load(int p) const {
    In in;
    if (p < 0) {
      in.k = -1;
      in.x = in.y = in.z = in.v = in.gx = in.gy = in.gz = 0.0f;
      return in;
    }
    const int n = p >> 4;
    in.k = p & 15;
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
    if (in.k < 0) {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        z[l] = INT_MAX;
        c[l] = 0.0f;
      }
      return;
    }
    CubicAxis ax, ay, az;
    cubic_axis(in.x, g.ox, g.sx, g.nx, ax);
    cubic_axis(in.y, g.oy, g.sy, g.ny, ay);
    cubic_axis(in.z, g.oz, g.sz, g.nz, az);
    const int a = in.k >> 2, b = in.k & 3;
    float wx = 0.0f, dwx = 0.0f, wy = 0.0f, dwy = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // select without indexing registers
      if (k == a) {
        wx = ax.w[k];
        dwx = ax.dw[k];
      }
      if (k == b) {
        wy = ay.w[k];
        dwy = ay.dw[k];
      }
    }
    const float wxy = wx * wy;
    // the value-weight part and the dz part of the cotangent
    const float s = in.v * wxy + (in.gx / g.sx) * (dwx * wy)
                    + (in.gy / g.sy) * (wx * dwy);
    const float sz = (in.gz / g.sz) * wxy;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      z[l] = az.i[l];
      c[l] = s * az.w[l] + sz * az.dw[l];
    }
  }
};

// The touched z of a row whose pairs have cell bases in [z0_lo, z0_hi]:
// the taps base-1 .. base+2, clamped.
__device__ __forceinline__ void row_span(const int* __restrict__ z0_range,
                                         int row, int nz, int& lo, int& hi) {
  lo = max(__ldg(z0_range + 2 * row) - 1, 0);
  hi = min(__ldg(z0_range + 2 * row + 1) + 2, nz - 1);
}

// The register budget: at least this many blocks of 256 threads resident
// on an SM (64 registers a thread). chip_smoke.py --k5t-study builds the
// library with other values to measure it.
#ifndef K5T_MIN_BLOCKS
#define K5T_MIN_BLOCKS 4
#endif

// One used segment of the plan a warp (a warp past them returns at once):
// reduced over its row's span in shared memory as reduce_segment reduces
// it, then added into table (n_rows, nz), or, in a row of several
// segments, written to partials and folded in segment order by the row's
// last warp.
__global__ void __launch_bounds__(256, K5T_MIN_BLOCKS)
    cubic_value_grad_bwd_kernel(
        const float* __restrict__ origin, const float* __restrict__ spacing,
        int nx, int ny, int nz, const float* __restrict__ points,
        const float* __restrict__ cv, const float* __restrict__ cg,
        row_reduce::Plan plan, const int* __restrict__ z0_range,
        float* __restrict__ table) {
  extern __shared__ float smem[];
  float* srow = smem + (threadIdx.x >> 5) * nz;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * row_reduce::kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= plan.row_seg[plan.n_rows]) return;  // past the used segments
  const CubicPair pair{table_grid(nullptr, origin, spacing, nx, ny, nz),
                       points, cv, cg};
  const int row = plan.seg_row[s];
  const int first = plan.row_seg[row];
  const int nseg = plan.row_seg[row + 1] - first;
  const int beg = plan.offsets[row] + (s - first) * plan.chunk;
  const int end = min(beg + plan.chunk, plan.offsets[row + 1]);
  int lo, hi;
  row_span(z0_range, row, nz, lo, hi);
  for (int z = lo + lane; z <= hi; z += 32) srow[z] = 0.0f;
  __syncwarp();

  // batch b is reduced while the inputs of b+1 and the ids of b+2 load
  int p_next = beg + 32 + lane < end ? plan.order[beg + 32 + lane] : -1;
  CubicPair::In in = pair.load(beg + lane < end ? plan.order[beg + lane]
                                                : -1);
  for (int j0 = beg; j0 < end; j0 += 32) {
    const int p_after = j0 + 64 + lane < end ? plan.order[j0 + 64 + lane]
                                             : -1;
    const CubicPair::In in_next = pair.load(p_next);
    int z[4];
    float c[4];
    pair.contributions(in, z, c);
    row_reduce::add_batch<4>(z, c, nz, srow);
    in = in_next;
    p_next = p_after;
  }
  __syncwarp();

  float* dst = table + (size_t)row * (size_t)nz;
  if (nseg == 1) {
    for (int z = lo + lane; z <= hi; z += 32) dst[z] += srow[z];
    return;
  }
  float* part = plan.partials + (size_t)s * (size_t)nz;
  for (int z = lo + lane; z <= hi; z += 32) __stcg(part + z, srow[z]);
  __threadfence();
  __syncwarp();
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(plan.counters + row, 1);
  ticket = __shfl_sync(row_reduce::kFullMask, ticket, 0);
  if (ticket != nseg - 1) return;
  __threadfence();
  // the partial rows in segment order, as fold_partials sums them
  const float* parts = plan.partials + (size_t)first * (size_t)nz;
  for (int z = lo + lane; z <= hi; z += 32) {
    float acc = 0.0f;
    for (int k = 0; k < nseg; ++k)
      acc += __ldcg(parts + (size_t)k * (size_t)nz + z);
    dst[z] += acc;
  }
  if (lane == 0) plan.counters[row] = 0;
}

}  // namespace

// table += K5^T(cv, cg): points (N, 3); cv (N,); cg (N, 3); the plan of
// occupied rows over the flat (point, pencil) pair ids n*16 + k: order
// (16 N,), offsets and row_seg (nx*ny+1,), seg_row (n_seg_max,), counters
// (nx*ny,) at zero, z0_range (nx*ny, 2) each row's least and greatest
// cell base; partials (n_seg_max, nz) scratch; table (nx*ny, nz), read
// and written only at the touched z span of each occupied row.
extern "C" int ionotomo_cubic_value_grad_bwd(
    const float* origin, const float* spacing, int nx, int ny, int nz,
    const float* points, const float* cv, const float* cg, const int* order,
    const int* offsets, const int* seg_row, const int* row_seg, int* counters,
    const int* z0_range, int n_seg_max, int chunk, float* partials,
    float* table, void* stream) {
  if (nx < 2 || ny < 2 || nz < 2 || n_seg_max < 1 || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const row_reduce::Plan plan{order,    offsets, seg_row,   row_seg, counters,
                              partials, nx * ny, n_seg_max, chunk};
  cubic_value_grad_bwd_kernel<<<row_reduce::blocks_for(n_seg_max),
                                32 * row_reduce::kWarpsPerBlock,
                                row_reduce::smem_bytes(nz),
                                (cudaStream_t)stream>>>(
      origin, spacing, nx, ny, nz, points, cv, cg, plan, z0_range, table);
  return (int)cudaGetLastError();
}
