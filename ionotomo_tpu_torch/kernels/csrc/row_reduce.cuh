// Deterministic scatter-add into the rows of an (n_rows, nz) table, shared
// by K3 (rows_value_bwd.cu) and K1e^T (zp_value_grad_bwd.cu).
//
// A scatter is a reduction over the (point, translate) pairs that land on
// each table row. The pairs are fixed for a whole solve (straight rays),
// so the caller sorts them by row once (a stable torch.sort, the "plan":
// `order` lists the flat pair ids p = n*K + k grouped by row, `offsets`
// is the CSR start of each row's group). Here one warp owns one row:
//
// - the 32 lanes each load one pair of the row's group at a time and
//   compute its L (z index, value) contributions (the Pair functor);
// - the contributions are broadcast one pair after another with
//   __shfl_sync; z element z of the row belongs to lane z % 32, which
//   adds it into the row, kept in shared memory (bank z % 32: no
//   conflicts, and no other lane touches it);
// - the finished row is written once, so rows with no pair get zeros.
//
// No float atomics: every element sums its contributions in the plan's
// order (rows ascending, then pairs ascending), so the result is bitwise
// the same from run to run. Contributions at z outside [0, nz) are
// dropped, as the reference's dense z band drops them.
//
// Cost: per pair, L pairs of shuffles plus one add in the owning lane, so
// a row's time grows with its pair count. Rows inside the ray cone hold
// hundreds of pairs and rows outside none: the load is skewed, and the
// busiest row bounds the kernel.
#pragma once

#include <cuda_runtime.h>

namespace row_reduce {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// Reduce the pairs of row `row` into out_row[0:nz). `srow` is this warp's
// nz floats of shared memory. Pair(p, z[L], c[L]) fills the contributions
// of flat pair id p (z < 0 marks an unused slot).
template <int L, class Pair>
__device__ __forceinline__ void reduce_row(int row, const int* __restrict__ order,
                                           const int* __restrict__ offsets,
                                           int nz, float* srow,
                                           float* __restrict__ out_row,
                                           const Pair& pair) {
  const int lane = threadIdx.x & 31;
  for (int z = lane; z < nz; z += 32) srow[z] = 0.0f;
  __syncwarp();
  const int beg = offsets[row];
  const int end = offsets[row + 1];
  for (int j0 = beg; j0 < end; j0 += 32) {
    int zl[L];
    float cl[L];
    if (j0 + lane < end) {
      pair(order[j0 + lane], zl, cl);
    } else {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        zl[l] = -1;
        cl[l] = 0.0f;
      }
    }
    const int count = min(32, end - j0);
    for (int s = 0; s < count; ++s) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int z = __shfl_sync(kFullMask, zl[l], s);
        const float c = __shfl_sync(kFullMask, cl[l], s);
        if (z >= 0 && z < nz && (z & 31) == lane) srow[z] += c;
      }
    }
  }
  __syncwarp();
  for (int z = lane; z < nz; z += 32) out_row[z] = srow[z];
}

// Launch shape: one warp per row, kWarpsPerBlock warps per block, nz
// floats of dynamic shared memory per warp.
inline int blocks_for(int n_rows) {
  return (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
}
inline size_t smem_bytes(int nz) {
  return (size_t)kWarpsPerBlock * (size_t)nz * sizeof(float);
}

}  // namespace row_reduce
