// Deterministic scatter-add into the rows of an (n_rows, nz) table, shared
// by K3 (rows_value_bwd.cu) and K1e^T (zp_value_grad_bwd.cu).
//
// A scatter is a reduction over the (point, translate) pairs that land on
// each table row. The pairs are fixed for a whole solve (straight rays),
// so the caller sorts them once (core/tricubic.py:build_row_plan, the
// "plan"): `order` lists the flat pair ids grouped by row and, within a
// row, by the point's first z tap; each row's group is cut into segments
// of at most `chunk` pairs (C), and every row, empty or not, has at least
// one segment.
//
// What bounded the first design (one warp walking a whole row, one pair
// after another, with 2L shuffles per pair and one lane adding) was the
// busiest row: 5,203 pairs at config 3b, 262,951 where points outside the
// grid clamp onto a corner row. Here:
//
// - one warp reduces one segment, so a warp's work is at most C pairs
//   whatever the data, and a long row is spread over many warps;
// - all 32 lanes add: lane i holds pair i of a batch of 32; the pairs are
//   sorted by z within the row, so the pairs that add into one z element
//   sit in neighbouring lanes, and a segmented shuffle scan (5 steps) sums
//   each run; the last lane of each run adds the run's sum into the row in
//   shared memory (distinct runs have distinct z, so no two lanes write
//   one element). A batch whose z are not sorted (zi that is not a
//   monotone function of its first tap) adds lane by lane instead;
// - the next batch's pair ids and the inputs of the batch after the
//   current one are loaded while the current batch is reduced;
// - a row of one segment writes its row directly. A row of several writes
//   each segment's partial row to scratch; the warp that finishes last
//   (an int atomicAdd on the row's counter after a __threadfence, as in
//   CUDA's threadFenceReduction sample) sums the partials in segment
//   order, writes the row and puts the counter back to zero. One launch
//   per call; a cluster reading partials through distributed shared memory
//   would cap a row at 8-16 segments, and a corner row needs ~500.
//
// No float atomics: every element sums its contributions in an order the
// plan fixes (batches in order, a fixed scan tree inside a batch, then
// segments in order), so the result is bitwise the same on every call.
// The integer counter only decides which warp does the final sum.
// Contributions at z outside [0, nz) are dropped, as the reference's
// dense z band drops them.
//
// Bound on the H100: bytes. Per pair the kernel reads its id and gathers
// the point's inputs; per row it writes nz floats once. The gathers are
// dependent random reads (id, then the point's data), which the batch
// pipeline and 32-40 resident warps per SM (48-64 registers a thread)
// hide.
#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace row_reduce {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// A plan (core/tricubic.py:RowPlan) and the call's scratch.
struct Plan {
  const int* order;    // (P,) flat pair ids, grouped by row, z-sorted
  const int* offsets;  // (n_rows+1,) start of each row's pairs in order
  const int* seg_row;  // (n_seg_max,) row of each segment; n_rows: unused
  const int* row_seg;  // (n_rows+1,) first segment of each row
  int* counters;       // (n_rows,) zero before and after every call
  float* partials;     // (n_seg_max, nz) scratch, written before read
  int n_rows;
  int n_seg_max;
  int chunk;           // C: pairs per segment at most
};

// Add one batch into srow: lane i holds the L (z, value) contributions of
// the batch's pair i (z = INT_MAX in lanes without a pair).
template <int L>
__device__ __forceinline__ void add_batch(const int (&z)[L],
                                          const float (&c)[L], int nz,
                                          float* srow) {
  const int lane = threadIdx.x & 31;
  bool sorted = true;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const int prev = __shfl_up_sync(kFullMask, z[l], 1);
    sorted = sorted && (lane == 0 || prev <= z[l]);
  }
  if (__all_sync(kFullMask, sorted)) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      // inclusive scan of each run of equal z (runs are contiguous)
      float v = c[l];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float vo = __shfl_up_sync(kFullMask, v, d);
        const int zo = __shfl_up_sync(kFullMask, z[l], d);
        if (lane >= d && zo == z[l]) v += vo;
      }
      const int zn = __shfl_down_sync(kFullMask, z[l], 1);
      if ((lane == 31 || zn != z[l]) && z[l] >= 0 && z[l] < nz)
        srow[z[l]] += v;
      __syncwarp();
    }
  } else {
    for (int s = 0; s < 32; ++s) {
      if (lane == s) {
#pragma unroll
        for (int l = 0; l < L; ++l)
          if (z[l] >= 0 && z[l] < nz) srow[z[l]] += c[l];
      }
      __syncwarp();
    }
  }
}

// Sum the nseg partial rows at parts (segment order) into dst[0:nz).
__device__ __forceinline__ void fold_partials(const float* parts, int nseg,
                                              int nz, float* dst) {
  const int lane = threadIdx.x & 31;
  for (int z0 = lane; z0 < nz; z0 += 128) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int k = 0; k < nseg; ++k) {
      const float* p = parts + (size_t)k * (size_t)nz + z0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (z0 + 32 * q < nz) acc[q] += __ldcg(p + 32 * q);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (z0 + 32 * q < nz) dst[z0 + 32 * q] = acc[q];
  }
}

// The warp's segment, blockIdx.x * kWarpsPerBlock + warp, reduced into
// its row of out (n_rows, nz). srow is the warp's nz floats of shared
// memory. Pair is a functor with
//   In load(int p) const               start the loads of flat pair p
//                                      (p < 0: no pair);
//   void contributions(const In&, int (&z)[L], float (&c)[L]) const.
template <int L, class Pair>
__device__ __forceinline__ void reduce_segment(const Plan& plan, int nz,
                                               float* srow,
                                               float* __restrict__ out,
                                               const Pair& pair) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= plan.n_seg_max) return;
  const int row = plan.seg_row[s];
  if (row >= plan.n_rows) return;  // past the plan's last segment
  const int first = plan.row_seg[row];
  const int nseg = plan.row_seg[row + 1] - first;
  const int beg = plan.offsets[row] + (s - first) * plan.chunk;
  const int end = min(beg + plan.chunk, plan.offsets[row + 1]);
  for (int z = lane; z < nz; z += 32) srow[z] = 0.0f;
  __syncwarp();

  // batch b is reduced while the inputs of b+1 and the ids of b+2 load
  int p_next = beg + 32 + lane < end ? plan.order[beg + 32 + lane] : -1;
  typename Pair::In in =
      pair.load(beg + lane < end ? plan.order[beg + lane] : -1);
  for (int j0 = beg; j0 < end; j0 += 32) {
    const int p_after = j0 + 64 + lane < end ? plan.order[j0 + 64 + lane]
                                             : -1;
    const typename Pair::In in_next = pair.load(p_next);
    int z[L];
    float c[L];
    pair.contributions(in, z, c);
    add_batch<L>(z, c, nz, srow);
    in = in_next;
    p_next = p_after;
  }
  __syncwarp();

  float* dst = out + (size_t)row * (size_t)nz;
  if (nseg == 1) {
    for (int z = lane; z < nz; z += 32) dst[z] = srow[z];
    return;
  }
  float* part = plan.partials + (size_t)s * (size_t)nz;
  for (int z = lane; z < nz; z += 32) __stcg(part + z, srow[z]);
  __threadfence();
  __syncwarp();
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(plan.counters + row, 1);
  ticket = __shfl_sync(kFullMask, ticket, 0);
  if (ticket != nseg - 1) return;
  __threadfence();
  fold_partials(plan.partials + (size_t)first * (size_t)nz, nseg, nz, dst);
  if (lane == 0) plan.counters[row] = 0;
}

// Launch shape: one warp per segment, kWarpsPerBlock warps per block, nz
// floats of dynamic shared memory per warp.
inline int blocks_for(int n_seg_max) {
  return (n_seg_max + kWarpsPerBlock - 1) / kWarpsPerBlock;
}
inline size_t smem_bytes(int nz) {
  return (size_t)kWarpsPerBlock * (size_t)nz * sizeof(float);
}

}  // namespace row_reduce
