// Deterministic scatter-add into the rows of an (n_rows, nz) table, shared
// by K3 (rows_value_bwd.cu), K1e^T (zp_value_grad_bwd.cu), K5^T
// (cubic_value_grad_bwd.cu) and, with a leading member axis, K3b
// (rows_value_bwd_batched.cu).
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

// reduce_segment over a plan of occupied rows, adding into the caller's
// table rather than writing a row: the accumulating transposes K5^T
// (cubic_value_grad_bwd.cu) and K6z^T (zpc_value_grad_bwd.cu), whose
// pairs' 4 z taps are the Catmull-Rom stencil base-1 .. base+2 (clamped)
// of a cell base. z0_range (n_rows, 2) holds each row's least and greatest
// cell base, so the warp of a segment reduces and adds only the z span
// [lo, hi] its row's pairs touch. One used segment a warp (a warp past
// the plan's last row_seg returns at once): reduced over the span in
// shared memory as reduce_segment reduces it, then added into table
// (n_rows, nz), table[row, z] += sum once per touched cell, or, in a row
// of several segments, written to partials and folded in segment order by
// the row's last warp, which adds the fold. So each cell is rounded as
// the table + (the sum in a zeroed table) rounds it.
template <int L, class Pair>
__device__ __forceinline__ void add_segment_into(
    const Plan& plan, const int* __restrict__ z0_range, int nz, float* srow,
    float* __restrict__ table, const Pair& pair) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= plan.row_seg[plan.n_rows]) return;  // past the used segments
  const int row = plan.seg_row[s];
  const int first = plan.row_seg[row];
  const int nseg = plan.row_seg[row + 1] - first;
  const int beg = plan.offsets[row] + (s - first) * plan.chunk;
  const int end = min(beg + plan.chunk, plan.offsets[row + 1]);
  // the touched z: the taps base-1 .. base+2 of the row's bases, clamped
  const int lo = max(__ldg(z0_range + 2 * row) - 1, 0);
  const int hi = min(__ldg(z0_range + 2 * row + 1) + 2, nz - 1);
  for (int z = lo + lane; z <= hi; z += 32) srow[z] = 0.0f;
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
  ticket = __shfl_sync(kFullMask, ticket, 0);
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

// dst[z] += srow[z] for z in [lo, hi], a pass of 128 cells at a time with
// its four loads issued before its stores (a long row's span can reach
// nz: one round trip a pass, not one a 32 cells).
__device__ __forceinline__ void add_span_into(const float* srow, int lo,
                                              int hi, float* dst) {
  const int lane = threadIdx.x & 31;
  for (int z0 = lo + lane; z0 <= hi; z0 += 128) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = z0 + 32 * q <= hi ? dst[z0 + 32 * q] : 0.0f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (z0 + 32 * q <= hi) dst[z0 + 32 * q] = v[q] + srow[z0 + 32 * q];
  }
}

// add_segment_into's sums over a plan's task list (core/tricubic.py:
// with_tasks), one task a warp, each read with one 16-byte load. A task
// (x, y, z, w) is
// - x >= 0: one segment of a long row x (more pairs than one segment or
//   one batch hold): its pairs order[y, z) and the row's touched z span
//   lo = w & 0xffff, hi = w >> 16. Reduced as add_segment_into reduces a
//   segment, with the loads the fold needs (row_seg, offsets) issued
//   beside the first batch's, and a row's last warp folding four cells a
//   lane over four segments' loads at once;
// - x < 0: whole short rows, consecutive in the plan: the pairs order[y,
//   z), at most 32, one a lane. A lane learns its pair's row from
//   contributions() (the plan's row: both come from the same clamps), the
//   rows' z spans from their first and last lanes (the lowest tap of the
//   least cell base, the highest of the greatest) and their places in
//   srow from a scan of the spans. Slot off + z - lo is then increasing
//   along the lanes and equal exactly where (row, z) is, so add_batch over
//   the slots sums each run as it sums the row's batch alone: a run's
//   scan tree depends only on the lanes' places in the run, and each of a
//   row's cells adds its runs tap by tap from 0.0f. Each row's span is
//   then added into the table cell by cell, the loads of a pass of 128
//   slots issued before its stores.
// Either way each cell is rounded as add_segment_into rounds it: bitwise
// its result over the same plan. srow: nz floats, the slots of a task of
// short rows (the plan keeps their spans' sum within nz).
template <int L, class Pair>
__device__ __forceinline__ void add_task_into(
    const Plan& plan, int4 task, int nz, float* srow,
    float* __restrict__ table, const Pair& pair) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the previous task's reads of srow are done
  if (task.x >= 0) {
    const int row = task.x, beg = task.y, end = task.z;
    const int lo = task.w & 0xffff, hi = task.w >> 16;
    const int first = __ldg(plan.row_seg + row);
    const int nseg = __ldg(plan.row_seg + row + 1) - first;
    const int row_beg = __ldg(plan.offsets + row);
    for (int z = lo + lane; z <= hi; z += 32) srow[z] = 0.0f;
    __syncwarp();
    // batch b is reduced while the inputs of b+1 and the ids of b+2 load
    const auto id = [&](int j) {
      return j < end ? __ldg(plan.order + j) : -1;
    };
    int p_next = id(beg + 32 + lane);
    typename Pair::In in = pair.load(id(beg + lane));
    for (int j0 = beg; j0 < end; j0 += 32) {
      const int p_after = id(j0 + 64 + lane);
      const typename Pair::In in_next = pair.load(p_next);
      int z[L];
      float c[L];
      pair.contributions(in, z, c);
      add_batch<L>(z, c, nz, srow);
      in = in_next;
      p_next = p_after;
    }
    __syncwarp();
    float* dst = table + (size_t)row * (size_t)nz;
    if (nseg == 1) {
      add_span_into(srow, lo, hi, dst);
      return;
    }
    // add_segment_into's ticket and fold, the segment's own index s; the
    // fold takes four cells a lane and four segments' loads at once, each
    // cell summed in segment order from 0.0f
    const int s = first + (beg - row_beg) / plan.chunk;
    float* part = plan.partials + (size_t)s * (size_t)nz;
    for (int z = lo + lane; z <= hi; z += 32) __stcg(part + z, srow[z]);
    __threadfence();
    __syncwarp();
    int ticket = 0;
    if (lane == 0) ticket = atomicAdd(plan.counters + row, 1);
    ticket = __shfl_sync(kFullMask, ticket, 0);
    if (ticket != nseg - 1) return;
    __threadfence();
    const float* parts = plan.partials + (size_t)first * (size_t)nz;
    for (int z0 = lo + lane; z0 <= hi; z0 += 128) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int k = 0; k < nseg; ++k) {
        const float* p = parts + (size_t)k * (size_t)nz + z0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (z0 + 32 * q <= hi) acc[q] += __ldcg(p + 32 * q);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (z0 + 32 * q <= hi) dst[z0 + 32 * q] += acc[q];
    }
    if (lane == 0) plan.counters[row] = 0;
    return;
  }

  const int n = task.z - task.y;  // <= 32
  const bool has = lane < n;
  int row, z[L];
  float c[L];
  pair.contributions(
      pair.load(has ? __ldg(plan.order + task.y + lane) : -1), row, z, c);
  const int prev = __shfl_up_sync(kFullMask, row, 1);
  const bool head = has && (lane == 0 || prev != row);
  const unsigned heads = __ballot_sync(kFullMask, head);
  const unsigned upto = 0xffffffffu >> (31 - lane);  // lanes 0 .. lane
  const int h = 31 - __clz(heads & upto);            // the row's first lane
  const unsigned later = heads & ~upto;
  const int t = later ? __ffs(later) - 2 : n - 1;    // the row's last lane
  const int lo = __shfl_sync(kFullMask, z[0], h);
  const int hi = __shfl_sync(kFullMask, z[L - 1], t);
  const int span = hi - lo + 1;
  int incl = head ? span : 0;  // inclusive scan of the rows' spans
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += v;
  }
  const int total = __shfl_sync(kFullMask, incl, 31);
  const int off_h = __shfl_sync(kFullMask, incl - span, h);
  const int off = has ? off_h : INT_MAX;
  int slot[L];
#pragma unroll
  for (int l = 0; l < L; ++l) slot[l] = has ? off + z[l] - lo : INT_MAX;
  for (int i = lane; i < total; i += 32) srow[i] = 0.0f;
  __syncwarp();
  add_batch<L>(slot, c, total, srow);
  __syncwarp();
  for (int i0 = 0; i0 < total; i0 += 128) {
    float* dst[4];
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + 32 * q + lane;
      // the last lane whose row's slots start at or before slot i
      int k = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        const int o = __shfl_sync(kFullMask, off, k + step);
        if (o <= i) k += step;
      }
      const int r = __shfl_sync(kFullMask, row, k);
      const int zl = __shfl_sync(kFullMask, lo, k);
      const int ok = __shfl_sync(kFullMask, off, k);
      dst[q] = i < total ? table + (size_t)r * (size_t)nz + (zl + i - ok)
                         : nullptr;
      v[q] = dst[q] ? *dst[q] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (dst[q]) *dst[q] = v[q] + srow[i0 + 32 * q + lane];
  }
}

// Members a warp reduces in one pass over its segment: one group of the
// member-innermost layout (rows_value_fwd_batched.cu, pack_members), whose
// kMemberGroup values of one point are two aligned float4.
constexpr int kMemberGroup = 8;

// add_batch for every member of a group at once: lane i holds the batch's
// pair i, its L z taps (z = INT_MAX in lanes without a pair) and its
// contributions c[m][l] for the group's members (zeros past the last);
// member m < tb adds into srow + m * nz. The z-run structure does not
// depend on the member, so it is found once: the sort test, and for each
// l each lane's place in its run (pos: the scan's lane d back is in the
// run iff pos >= d), whether it ends the run, and the longest run (scan
// steps past it add nothing in any lane, so they are skipped). Each
// member's values then go through add_batch's scan tree with add_batch's
// adds, so member m's sums are bitwise what add_batch makes of c[m]
// alone. A step shuffles all members' values at once (8 independent
// chains in flight); the first step is taken whatever the runs, as
// add_batch takes it. Members' adds into their rows follow l by l, as
// add_batch's do.
template <int L>
__device__ __forceinline__ void add_batch_members(
    const int (&z)[L], const float (&c)[kMemberGroup][L], int tb, int nz,
    float* srow) {
  const int lane = threadIdx.x & 31;
  bool sorted = true;
  int prev[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    prev[l] = __shfl_up_sync(kFullMask, z[l], 1);
    sorted = sorted && (lane == 0 || prev[l] <= z[l]);
  }
  if (__all_sync(kFullMask, sorted)) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const unsigned head =
          __ballot_sync(kFullMask, lane == 0 || prev[l] != z[l]);
      // the run's first lane: the highest head at or below this lane
      const int pos =
          lane - (31 - __clz(head & (0xffffffffu >> (31 - lane))));
      const bool keep = (lane == 31 || ((head >> (lane + 1)) & 1u)) &&
                        z[l] >= 0 && z[l] < nz;
#ifdef K3B_FULL_SCAN
      const int span = 31;
#else
      const int span = (int)__reduce_max_sync(kFullMask, (unsigned)pos);
#endif
      float v[kMemberGroup];
#pragma unroll
      for (int m = 0; m < kMemberGroup; ++m) {
        v[m] = c[m][l];
        const float vo = __shfl_up_sync(kFullMask, v[m], 1);
        if (pos >= 1) v[m] += vo;
      }
#pragma unroll
      for (int d = 2; d < 32; d <<= 1) {
        if (d <= span) {  // uniform over the warp
#pragma unroll
          for (int m = 0; m < kMemberGroup; ++m) {
            const float vo = __shfl_up_sync(kFullMask, v[m], d);
            if (pos >= d) v[m] += vo;
          }
        }
      }
      if (keep) {
#pragma unroll
        for (int m = 0; m < kMemberGroup; ++m)
          if (m < tb) srow[m * nz + z[l]] += v[m];
      }
      __syncwarp();
    }
  } else {
    for (int s = 0; s < 32; ++s) {
      if (lane == s) {
#pragma unroll
        for (int m = 0; m < kMemberGroup; ++m) {
          if (m < tb) {
#pragma unroll
            for (int l = 0; l < L; ++l)
              if (z[l] >= 0 && z[l] < nz) srow[m * nz + z[l]] += c[m][l];
          }
        }
      }
      __syncwarp();
    }
  }
}

// reduce_segment with a leading member axis, over the one plan all
// members share: the warp's segment reduced into its row of every
// member's table, out (n_members, n_rows, nz), a group of up to
// kMemberGroup members a pass. srow is the warp's min(n_members,
// kMemberGroup) * nz floats of shared memory. The pairs' ids and
// member-invariant inputs are loaded once a pass and the batch's z runs
// found once for the group (add_batch_members). A row of one segment is
// written here. A row of several writes, for every member, only the span
// of its partial row that its pairs touch: the least and greatest z tap
// the warp added (inside [0, nz), so the clamped taps too), found by a
// warp min and max and stored in spans[s] (INT_MAX, -1 where no tap lies
// in the table). fold_member_rows sums those spans in a second launch: no
// ticket, so no warp folds a skewed row's segments for all members alone.
// Outside its span a partial row would hold +0.0 (srow starts at +0.0, and
// a running sum from +0.0 is never -0.0 in round to nearest), which adds
// nothing to any sum: so leaving it unwritten and unread changes no bit.
// Each member's sums run in reduce_segment's order (batches in order, the
// same scan tree, then segments in order), so member b of the result is
// bitwise what reduce_segment makes of member b alone. Pair is a functor
// with
//   In load(int p, int b0) const          start the loads of flat pair p
//                                         for members b0 .. b0+7
//                                         (p < 0: no pair);
//   void contributions(const In&, int (&z)[L],
//                      float (&c)[kMemberGroup][L]) const.
template <int L, class Pair>
__device__ __forceinline__ void reduce_segment_members(
    const Plan& plan, int nz, int n_members, float* srow,
    float* __restrict__ out, int2* __restrict__ spans, const Pair& pair) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (s >= plan.n_seg_max) return;
  const int row = plan.seg_row[s];
  if (row >= plan.n_rows) return;  // past the plan's last segment
  const int first = plan.row_seg[row];
  const int nseg = plan.row_seg[row + 1] - first;
  const int beg = plan.offsets[row] + (s - first) * plan.chunk;
  const int end = min(beg + plan.chunk, plan.offsets[row + 1]);

  for (int b0 = 0; b0 < n_members; b0 += kMemberGroup) {
    const int tb = min(kMemberGroup, n_members - b0);
    for (int z = lane; z < tb * nz; z += 32) srow[z] = 0.0f;
    __syncwarp();
    int lo = INT_MAX, hi = -1;  // the taps this lane added
    int p_next = beg + 32 + lane < end ? plan.order[beg + 32 + lane] : -1;
    typename Pair::In in =
        pair.load(beg + lane < end ? plan.order[beg + lane] : -1, b0);
    for (int j0 = beg; j0 < end; j0 += 32) {
      const int p_after = j0 + 64 + lane < end ? plan.order[j0 + 64 + lane]
                                               : -1;
      const typename Pair::In in_next = pair.load(p_next, b0);
      int z[L];
      float c[kMemberGroup][L];
      pair.contributions(in, z, c);
#pragma unroll
      for (int l = 0; l < L; ++l)
        if (z[l] >= 0 && z[l] < nz) {
          lo = min(lo, z[l]);
          hi = max(hi, z[l]);
        }
      add_batch_members<L>(z, c, tb, nz, srow);
      in = in_next;
      p_next = p_after;
    }
    __syncwarp();
    if (nseg == 1) {
      float* dst = out + ((size_t)b0 * plan.n_rows + row) * (size_t)nz;
      const size_t stride = (size_t)plan.n_rows * (size_t)nz;
      for (int m = 0; m < tb; ++m)
        for (int z = lane; z < nz; z += 32)
          dst[m * stride + z] = srow[m * nz + z];
    } else {
      lo = __reduce_min_sync(kFullMask, lo);
      hi = __reduce_max_sync(kFullMask, hi);
      if (b0 == 0 && lane == 0) spans[s] = make_int2(lo, hi);
      float* dst =
          plan.partials + ((size_t)b0 * plan.n_seg_max + s) * (size_t)nz;
      const size_t stride = (size_t)plan.n_seg_max * (size_t)nz;
      for (int m = 0; m < tb; ++m)
        for (int z = lo + lane; z <= hi; z += 32)
          __stcg(dst + m * stride + z, srow[m * nz + z]);
    }
    __syncwarp();
  }
}

// Threads of one fold_member_rows block: z cells of a row, each thread
// one z of a group of members; the blocks an SM its register budget is
// set for (48 registers: the compiler's own choice took 128, and 1-2
// rows an SM); the segments whose loads a thread issues together
// (chip_smoke.py --member-study, NVIDIA H100 80GB HBM3, 700 W: 4 read
// 2-24 % slower at config 5's bundles).
constexpr int kFoldThreads = 128;
constexpr int kFoldMinBlocks = 8;
constexpr int kFoldUnroll = 2;

// The second pass of reduce_segment_members, over the plan's list of the
// rows of several segments (core/tricubic.py: RowPlan.multi_rows, built
// with the plan on the device; n_multi of them). A block takes the listed
// rows blockIdx.x, blockIdx.x + gridDim.x, ... (a block past the count
// does nothing), so the grid is sized by the host from a bound and no
// block is spent on a row of one segment. In a row, blockIdx.y picks
// kFoldThreads z cells and blockIdx.z a group of kMemberGroup members, a
// thread one z cell of the group's members: it tests whether a segment's span covers
// its z once for all of them, and loads their partials at once. Each
// element sums, in segment order from 0.0f, the partial rows of the
// segments whose span covers it, and is 0.0f where none does: bitwise the
// sum of the whole partial rows that fold_partials forms, since outside
// its span a partial row is +0.0 (reduce_segment_members), and each
// element of the row is written. The spans of 32 segments are read by the
// 32 lanes at once and handed round by shuffles, and the loads of
// kFoldUnroll segments are issued together, so a row costs a chain of
// four dependent reads (its list entry, its segments, their spans, their
// partials) and many rows are in flight at once. The first two designs,
// 4 elements a thread over 256-thread blocks (spans through shared memory
// with two barriers, then by shuffles), held 2-4 rows an SM (53 and 96
// registers) and read 0.035-0.040 ms at config 5's 650,000 points against
// this one's 0.018-0.019; 4 or 2 members a thread read 10 % and 50 %
// slower there (only a skewed row, the zp edge-case points' corner row of
// 515 segments, gains from the shorter chains of 2: 0.159 against 0.213).
// Bound: bytes, each member's spans read and its rows written once, 4 B
// (sum of spans + rows * nz) a member.
__device__ __forceinline__ void fold_member_rows(
    const int* __restrict__ multi_rows, const int* __restrict__ n_multi,
    const int* __restrict__ row_seg, const int2* __restrict__ spans,
    const float* partials, int n_members, int n_rows, int n_seg_max, int nz,
    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int count = __ldg(n_multi);
  const int z = blockIdx.y * kFoldThreads + threadIdx.x;
  const int b0 = blockIdx.z * kMemberGroup;
  const int tb = min(kMemberGroup, n_members - b0);
  const bool has = z < nz;
  const size_t in_stride = (size_t)n_seg_max * nz;
  const size_t out_stride = (size_t)n_rows * nz;
  const float* pz = partials + (size_t)b0 * in_stride + (has ? z : 0);
  float* oz = out + (size_t)b0 * out_stride + (has ? z : 0);
  for (int j = blockIdx.x; j < count; j += gridDim.x) {  // uniform
    const int row = __ldg(multi_rows + j);
    const int first = __ldg(row_seg + row);
    const int nseg = __ldg(row_seg + row + 1) - first;
    const float* base = pz + (size_t)first * nz;
    float acc[kMemberGroup];
#pragma unroll
    for (int m = 0; m < kMemberGroup; ++m) acc[m] = 0.0f;
    for (int k0 = 0; k0 < nseg; k0 += 32) {
      const int tile = min(32, nseg - k0);
      const int2 mine = lane < tile ? __ldg(spans + first + k0 + lane)
                                    : make_int2(INT_MAX, -1);
      for (int k = 0; k < tile; k += kFoldUnroll) {
        float v[kFoldUnroll][kMemberGroup];
        bool in[kFoldUnroll];
#pragma unroll
        for (int u = 0; u < kFoldUnroll; ++u) {
          // lanes past the tile hold the empty span, so k + u < 32 does
          const int lo = __shfl_sync(kFullMask, mine.x, (k + u) & 31);
          const int hi = __shfl_sync(kFullMask, mine.y, (k + u) & 31);
          in[u] = has && k + u < tile && lo <= z && z <= hi;
          const float* p = base + (size_t)(k0 + k + u) * nz;
#pragma unroll
          for (int m = 0; m < kMemberGroup; ++m)
            v[u][m] = in[u] && m < tb ? __ldcg(p + m * in_stride) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kFoldUnroll; ++u)
#pragma unroll
          for (int m = 0; m < kMemberGroup; ++m)
            if (in[u]) acc[m] += v[u][m];
      }
    }
    if (has) {
#pragma unroll
      for (int m = 0; m < kMemberGroup; ++m)
        if (m < tb) oz[m * out_stride + (size_t)row * nz] = acc[m];
    }
  }
}

// Launch shape: one warp per segment, kWarpsPerBlock warps per block, nz
// floats of dynamic shared memory per warp.
inline int blocks_for(int n_seg_max) {
  return (n_seg_max + kWarpsPerBlock - 1) / kWarpsPerBlock;
}
inline size_t smem_bytes(int nz) {
  return (size_t)kWarpsPerBlock * (size_t)nz * sizeof(float);
}
// Warps a block of reduce_segment_members holds: kWarpsPerBlock where
// their member rows fit in the 48 KB a block gets without opting in to
// more, else as many as fit in the 227 KB it may opt in to (6 at least, at
// nz = MAX_NZ_REDUCE = 1024 and 8 members).
inline size_t member_smem_per_warp(int n_members, int nz) {
  return (size_t)min(n_members, kMemberGroup) * (size_t)nz * sizeof(float);
}
inline int member_warps(int n_members, int nz) {
  const size_t fit = (size_t)227 * 1024 / member_smem_per_warp(n_members, nz);
  return (int)min((size_t)kWarpsPerBlock, fit);
}

}  // namespace row_reduce
