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
// plan of the point set. The warp of a segment holds one row of shared
// memory per member (a tile of up to 8 members a pass), loads a batch's
// pair inputs once and adds it into every member's row; a row of several
// segments takes one ticket after all members' partial rows are written.
// No float atomics; member b of the result is bitwise K3 of ct[b] over
// the same plan, and the result is bitwise the same on every call.
#include <cuda_runtime.h>

#include "row_reduce.cuh"

namespace {

constexpr int kMaxK = 16;
constexpr int kMaxL = 4;

template <int L>
struct RowsPairMembers {
  const float* __restrict__ ct;  // (n_members, n_points)
  const float* __restrict__ wxy;
  const int* __restrict__ zi;
  const float* __restrict__ wz;
  int K;
  int n_points;
  struct In {
    float ct[row_reduce::kMemberTile];
    float wxy;
    int z[L];
    float wz[L];
  };
  __device__ __forceinline__ In load(int p, int b0, int tb) const {
    In in;
    if (p < 0) {
#pragma unroll
      for (int m = 0; m < row_reduce::kMemberTile; ++m) in.ct[m] = 0.0f;
      in.wxy = 0.0f;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        in.z[l] = INT_MAX;
        in.wz[l] = 0.0f;
      }
      return in;
    }
    const int n = p / K;
#pragma unroll
    for (int m = 0; m < row_reduce::kMemberTile; ++m)
      in.ct[m] = m < tb ? __ldg(ct + (size_t)(b0 + m) * (size_t)n_points + n)
                        : 0.0f;
    in.wxy = __ldg(wxy + p);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      in.z[l] = __ldg(zi + (size_t)n * L + l);
      in.wz[l] = __ldg(wz + (size_t)n * L + l);
    }
    return in;
  }
  __device__ __forceinline__ void contributions(const In& in, int m,
                                                int (&z)[L],
                                                float (&c)[L]) const {
    const float a = in.ct[m] * in.wxy;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      z[l] = in.z[l];
      c[l] = a * in.wz[l];
    }
  }
};

template <int L>
__global__ void rows_value_bwd_batched_kernel(
    const float* __restrict__ ct, int n_members, int n_points,
    const float* __restrict__ wxy, int K, const int* __restrict__ zi,
    const float* __restrict__ wz, int nz, int tile, row_reduce::Plan plan,
    float* __restrict__ out) {
  extern __shared__ float smem[];
  const RowsPairMembers<L> pair{ct, wxy, zi, wz, K, n_points};
  row_reduce::reduce_segment_members<L>(
      plan, nz, n_members, tile, smem + (threadIdx.x >> 5) * tile * nz, out,
      pair);
}

template <int L>
int launch(const float* ct, int n_members, int n_points, const float* wxy,
           int K, const int* zi, const float* wz, int nz,
           const row_reduce::Plan& plan, float* out, cudaStream_t stream) {
  const int tile = row_reduce::member_tile(n_members, nz);
  rows_value_bwd_batched_kernel<L>
      <<<row_reduce::blocks_for(plan.n_seg_max),
         32 * row_reduce::kWarpsPerBlock,
         (size_t)tile * row_reduce::smem_bytes(nz), stream>>>(
          ct, n_members, n_points, wxy, K, zi, wz, nz, tile, plan, out);
  return (int)cudaGetLastError();
}

}  // namespace

// ct (B, N); wxy (N, K); zi, wz (N, L); the plan as for
// ionotomo_rows_value_bwd (one ticket a row for all members); partials
// (B, n_seg_max, nz) scratch; out (B, n_rows, nz), fully written.
extern "C" int ionotomo_rows_value_bwd_batched(
    const float* ct, int n_members, int n_points, const float* wxy, int K,
    const int* zi, const float* wz, int L, int nz, const int* order,
    const int* offsets, const int* seg_row, const int* row_seg, int* counters,
    int n_rows, int n_seg_max, int chunk, float* partials, float* out,
    void* stream) {
  if (n_members < 1 || K < 1 || K > kMaxK || L < 1 || L > kMaxL || nz < 1 ||
      n_rows < 1 || n_seg_max < n_rows || chunk < 1 ||
      row_reduce::smem_bytes(nz) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const row_reduce::Plan plan{order,    offsets, seg_row,   row_seg, counters,
                              partials, n_rows,  n_seg_max, chunk};
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 1:
      return launch<1>(ct, n_members, n_points, wxy, K, zi, wz, nz, plan, out,
                       s);
    case 2:
      return launch<2>(ct, n_members, n_points, wxy, K, zi, wz, nz, plan, out,
                       s);
    case 3:
      return launch<3>(ct, n_members, n_points, wxy, K, zi, wz, nz, plan, out,
                       s);
    default:
      return launch<4>(ct, n_members, n_points, wxy, K, zi, wz, nz, plan, out,
                       s);
  }
}
