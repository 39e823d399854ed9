// K3b: transpose of the row-gather value map with a leading member axis,
//   table_ct[b, ri[n,k], zi[n,l]] += ct[b, n] * wxy[n,k] * wz[n,l].
//
// Replaces: ionotomo_tpu/core/tricubic.py, _rows_value_transpose (the
// batched-cotangent branch, :380-408, reached through the batching rule
// :461-486): the hand-written member-axis transpose of rows_value_p that
// the ensemble Kalman filter's vmap over members binds. The indices and
// weights are the members' shared ray geometry; only the cotangent has
// the member axis. At config 5: 8 members, 650,000 quadrature points
// (330,000 on the inner bundle), 7 live zp rows, L=3, a (16384, 128)
// table per member.
//
// Bound on the H100: bytes. The shared inputs (ids, wxy, zi, wz) are read
// once for all members, ct once per member, and every member's table is
// written once (8 MiB each at 128^3).
//
// Design: the plan-and-reduce scheme of K3 (row_reduce.cuh) over the one
// plan of the point set, in two launches.
// - reduce (ionotomo_rows_value_bwd_batched): one warp a segment, a group
//   of up to 8 members a pass with one row of shared memory each. The
//   cotangent comes member-innermost, (ceil(B/8), N, 8) from the call's
//   pack (pack_members, rows_value_fwd_batched.cu), so a pair's 8
//   cotangents are one 32-byte load where the (B, N) array takes 8
//   scattered sectors. A batch's z-run structure is found once for the
//   group and every member's values run through K3's scan tree
//   (add_batch_members), skipping the steps no run reaches. A row of one
//   segment is written directly, a row of several writes partial rows.
// - fold (ionotomo_fold_member_rows): a block's threads sum every
//   member's partial rows of a row of several segments in segment order,
//   so the members of a skewed row are folded side by side, not by one
//   warp.
// No float atomics and no tickets: member b of the result is bitwise K3
// of ct[b] over the same plan, and the result is bitwise the same on
// every call. The plan's counters are not touched.
#include <cuda_runtime.h>

#include "row_reduce.cuh"

namespace {

constexpr int kMaxK = 16;
constexpr int kMaxL = 4;
using row_reduce::kMemberGroup;

// Blocks of 8 warps an SM the reduce's register budget is set for; 1 is
// the compiler's own choice (chip_smoke.py --member-study).
#ifndef K3B_MIN_BLOCKS
#define K3B_MIN_BLOCKS 1
#endif

template <int L>
struct RowsPairMembers {
  const float* __restrict__ ctp;  // (ceil(n_members/8), n_points, 8)
  const float* __restrict__ wxy;
  const int* __restrict__ zi;
  const float* __restrict__ wz;
  int K;
  int n_points;
  struct In {
    float4 ct[2];
    float wxy;
    int z[L];
    float wz[L];
  };
  __device__ __forceinline__ In load(int p, int b0) const {
    In in;
    if (p < 0) {
      in.ct[0] = in.ct[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      in.wxy = 0.0f;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        in.z[l] = INT_MAX;
        in.wz[l] = 0.0f;
      }
      return in;
    }
    const int n = p / K;
    const float4* c = reinterpret_cast<const float4*>(
        ctp + ((size_t)(b0 / kMemberGroup) * (size_t)n_points + n) *
                  kMemberGroup);
    in.ct[0] = __ldg(c);
    in.ct[1] = __ldg(c + 1);
    in.wxy = __ldg(wxy + p);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      in.z[l] = __ldg(zi + (size_t)n * L + l);
      in.wz[l] = __ldg(wz + (size_t)n * L + l);
    }
    return in;
  }
  __device__ __forceinline__ void contributions(
      const In& in, int (&z)[L], float (&c)[kMemberGroup][L]) const {
    const float ct[kMemberGroup] = {in.ct[0].x, in.ct[0].y, in.ct[0].z,
                                    in.ct[0].w, in.ct[1].x, in.ct[1].y,
                                    in.ct[1].z, in.ct[1].w};
#pragma unroll
    for (int l = 0; l < L; ++l) z[l] = in.z[l];
#pragma unroll
    for (int m = 0; m < kMemberGroup; ++m) {
      const float a = ct[m] * in.wxy;
#pragma unroll
      for (int l = 0; l < L; ++l) c[m][l] = a * in.wz[l];
    }
  }
};

template <int L>
__global__ void __launch_bounds__(32 * row_reduce::kWarpsPerBlock,
                                  K3B_MIN_BLOCKS)
    rows_value_bwd_batched_kernel(
    const float* __restrict__ ctp, int n_members, int n_points,
    const float* __restrict__ wxy, int K, const int* __restrict__ zi,
    const float* __restrict__ wz, int nz, row_reduce::Plan plan,
    float* __restrict__ out) {
  extern __shared__ float smem[];
  const RowsPairMembers<L> pair{ctp, wxy, zi, wz, K, n_points};
  row_reduce::reduce_segment_members<L>(
      plan, nz, n_members,
      smem + (threadIdx.x >> 5) * min(n_members, kMemberGroup) * nz, out,
      pair);
}

template <int L>
int launch(const float* ctp, int n_members, int n_points, const float* wxy,
           int K, const int* zi, const float* wz, int nz,
           const row_reduce::Plan& plan, float* out, cudaStream_t stream) {
  const int warps = row_reduce::member_warps(n_members, nz);
  const size_t smem =
      (size_t)warps * row_reduce::member_smem_per_warp(n_members, nz);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rows_value_bwd_batched_kernel<L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rows_value_bwd_batched_kernel<L>
      <<<(plan.n_seg_max + warps - 1) / warps, 32 * warps, smem, stream>>>(
          ctp, n_members, n_points, wxy, K, zi, wz, nz, plan, out);
  return (int)cudaGetLastError();
}

__global__ void fold_member_rows_kernel(const int* __restrict__ row_seg,
                                        int n_rows,
                                        const float* __restrict__ partials,
                                        int n_members, int n_seg_max, int nz,
                                        float* __restrict__ out) {
  row_reduce::fold_member_rows(row_seg, n_rows, partials, n_members,
                               n_seg_max, nz, out);
}

}  // namespace

// The reduce: ctp (ceil(B/8), N, 8), the cotangent member-innermost
// (pack_members of ct (B, N)); wxy (N, K); zi, wz (N, L); the plan as for
// ionotomo_rows_value_bwd (its counters are not used); partials (B,
// n_seg_max, nz) scratch; out (B, n_rows, nz), written at every row of
// one segment. ionotomo_fold_member_rows writes the other rows.
extern "C" int ionotomo_rows_value_bwd_batched(
    const float* ctp, int n_members, int n_points, const float* wxy, int K,
    const int* zi, const float* wz, int L, int nz, const int* order,
    const int* offsets, const int* seg_row, const int* row_seg, int n_rows,
    int n_seg_max, int chunk, float* partials, float* out, void* stream) {
  if (n_members < 1 || K < 1 || K > kMaxK || L < 1 || L > kMaxL || nz < 1 ||
      n_rows < 1 || n_seg_max < n_rows || chunk < 1 ||
      row_reduce::member_warps(n_members, nz) < 1)
    return (int)cudaErrorInvalidValue;
  const row_reduce::Plan plan{order,    offsets, seg_row,   row_seg, nullptr,
                              partials, n_rows,  n_seg_max, chunk};
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 1:
      return launch<1>(ctp, n_members, n_points, wxy, K, zi, wz, nz, plan,
                       out, s);
    case 2:
      return launch<2>(ctp, n_members, n_points, wxy, K, zi, wz, nz, plan,
                       out, s);
    case 3:
      return launch<3>(ctp, n_members, n_points, wxy, K, zi, wz, nz, plan,
                       out, s);
    default:
      return launch<4>(ctp, n_members, n_points, wxy, K, zi, wz, nz, plan,
                       out, s);
  }
}

// The fold: row_seg (n_rows+1,) of the plan; partials and out as the
// reduce left them. A block of kFoldThreads takes kFoldRows rows.
extern "C" int ionotomo_fold_member_rows(const int* row_seg, int n_rows,
                                         const float* partials, int n_members,
                                         int n_seg_max, int nz, float* out,
                                         void* stream) {
  if (n_members < 1 || n_rows < 1 || nz < 1) return (int)cudaErrorInvalidValue;
  fold_member_rows_kernel<<<(n_rows + row_reduce::kFoldRows - 1) /
                                row_reduce::kFoldRows,
                            row_reduce::kFoldThreads, 0,
                            (cudaStream_t)stream>>>(
      row_seg, n_rows, partials, n_members, n_seg_max, nz, out);
  return (int)cudaGetLastError();
}
