// K3: transpose of the row-gather value map (the backward of K2),
//   table_ct[ri[n,k], zi[n,l]] += ct[n] * wxy[n,k] * wz[n,l].
//
// Replaces: ionotomo_tpu/core/tricubic.py, _rows_value_transpose (the
// unbatched dense-row branch, :432-450), the hand-written transpose of
// the custom primitive rows_value_p. In the inversion slice it is R^T in
// every application of the linearised dTEC operator's transpose: 650k
// quadrature points (10k rays x 65 samples), 7 live zp rows (the 8th
// translate has weight 0 and is left out of the plan), L=3 z taps, on a
// (16384, 128) table at config 3b. The cubic shape (K=16, L=4) is taken
// as well.
//
// Bound on the H100: bytes. Per (point, row) pair it reads a 4 B id and
// gathers ct[n], wxy[n,k], zi[n,:] and wz[n,:]; it writes the table once
// (8 MiB at 128^3); the arithmetic is L multiply-adds per pair. What held
// the first design back was the busiest table row, walked serially by
// one warp; the segmented plan of row_reduce.cuh bounds every warp's work
// by C pairs, and the gathers of one batch load while the previous batch
// is summed.
//
// Design: deterministic plan-and-reduce (row_reduce.cuh) in one launch.
// The wrapper passes the plan of the point set (pairs sorted by row and
// z, cut into segments, built once per operator) and a scratch buffer for
// the partial rows of long rows. No float atomics, so the result is
// bitwise reproducible.
#include <cuda_runtime.h>

#include "row_reduce.cuh"

namespace {

constexpr int kMaxK = 16;
constexpr int kMaxL = 4;

template <int L>
struct RowsPair {
  const float* __restrict__ ct;
  const float* __restrict__ wxy;
  const int* __restrict__ zi;
  const float* __restrict__ wz;
  int K;
  struct In {
    float ct, wxy;
    int z[L];
    float wz[L];
  };
  __device__ __forceinline__ In load(int p) const {
    In in;
    if (p < 0) {
      in.ct = 0.0f;
      in.wxy = 0.0f;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        in.z[l] = INT_MAX;
        in.wz[l] = 0.0f;
      }
      return in;
    }
    const int n = p / K;
    in.ct = __ldg(ct + n);
    in.wxy = __ldg(wxy + p);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      in.z[l] = __ldg(zi + (size_t)n * L + l);
      in.wz[l] = __ldg(wz + (size_t)n * L + l);
    }
    return in;
  }
  __device__ __forceinline__ void contributions(const In& in, int (&z)[L],
                                                float (&c)[L]) const {
    const float a = in.ct * in.wxy;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      z[l] = in.z[l];
      c[l] = a * in.wz[l];
    }
  }
};

template <int L>
__global__ void rows_value_bwd_kernel(const float* __restrict__ ct,
                                      const float* __restrict__ wxy, int K,
                                      const int* __restrict__ zi,
                                      const float* __restrict__ wz, int nz,
                                      row_reduce::Plan plan,
                                      float* __restrict__ out) {
  extern __shared__ float smem[];
  const RowsPair<L> pair{ct, wxy, zi, wz, K};
  row_reduce::reduce_segment<L>(plan, nz, smem + (threadIdx.x >> 5) * nz,
                                out, pair);
}

template <int L>
int launch(const float* ct, const float* wxy, int K, const int* zi,
           const float* wz, int nz, const row_reduce::Plan& plan, float* out,
           cudaStream_t stream) {
  rows_value_bwd_kernel<L><<<row_reduce::blocks_for(plan.n_seg_max),
                             32 * row_reduce::kWarpsPerBlock,
                             row_reduce::smem_bytes(nz), stream>>>(
      ct, wxy, K, zi, wz, nz, plan, out);
  return (int)cudaGetLastError();
}

}  // namespace

// ct (N,); wxy (N, K); zi, wz (N, L); the plan: order (P,) flat pair ids
// n*K + k, offsets and row_seg (n_rows+1,), seg_row (n_seg_max,),
// counters (n_rows,) at zero; partials (n_seg_max, nz) scratch; out
// (n_rows, nz), fully written.
extern "C" int ionotomo_rows_value_bwd(
    const float* ct, const float* wxy, int K, const int* zi, const float* wz,
    int L, int nz, const int* order, const int* offsets, const int* seg_row,
    const int* row_seg, int* counters, int n_rows, int n_seg_max, int chunk,
    float* partials, float* out, void* stream) {
  if (K < 1 || K > kMaxK || L < 1 || L > kMaxL || nz < 1 || n_rows < 1 ||
      n_seg_max < n_rows || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const row_reduce::Plan plan{order,    offsets, seg_row,   row_seg, counters,
                              partials, n_rows,  n_seg_max, chunk};
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 1: return launch<1>(ct, wxy, K, zi, wz, nz, plan, out, s);
    case 2: return launch<2>(ct, wxy, K, zi, wz, nz, plan, out, s);
    case 3: return launch<3>(ct, wxy, K, zi, wz, nz, plan, out, s);
    default: return launch<4>(ct, wxy, K, zi, wz, nz, plan, out, s);
  }
}
