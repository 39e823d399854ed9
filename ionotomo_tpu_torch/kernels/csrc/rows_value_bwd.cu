// K3: transpose of the row-gather value map (the backward of K2),
//   table_ct[ri[n,k], zi[n,l]] += ct[n] * wxy[n,k] * wz[n,l].
//
// Replaces: ionotomo_tpu/core/tricubic.py, _rows_value_transpose (the
// unbatched dense-row branch, :432-450), the hand-written transpose of
// the custom primitive rows_value_p. In the inversion slice it is R^T in
// every application of the linearised dTEC operator's transpose: 650k
// quadrature points (10k rays x 65 samples), K=8 rows, L=3 z taps, on a
// (16384, 128) table at config 3b. The cubic shape (K=16, L=4) is taken
// as well.
//
// Bound on the H100: a scatter. The reference scatter-adds K dense
// nz-deep rows per point (per-index bound on the TPU). Here the inputs
// are ~24 B of pair data per (point, row) pair plus ct, and the output
// is the table once (8 MiB at 128^3); the work is L shuffles and adds
// per pair, serial within a row (row_reduce.cuh). The kernel is bound by
// its busiest row, not by bytes.
//
// Design: deterministic plan-and-reduce (row_reduce.cuh). The wrapper
// passes the plan of the point set (pairs sorted by row, built once per
// operator); one warp per table row walks its pairs in a fixed order.
// No float atomics, so the result is bitwise reproducible.
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
  __device__ __forceinline__ void operator()(int p, int (&z)[L],
                                             float (&c)[L]) const {
    const int n = p / K;
    const float a = ct[n] * wxy[p];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      z[l] = zi[(size_t)n * L + l];
      c[l] = a * wz[(size_t)n * L + l];
    }
  }
};

template <int L>
__global__ void rows_value_bwd_kernel(const float* __restrict__ ct,
                                      const int* __restrict__ order,
                                      const int* __restrict__ offsets,
                                      const float* __restrict__ wxy, int K,
                                      const int* __restrict__ zi,
                                      const float* __restrict__ wz,
                                      int n_rows, int nz,
                                      float* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * row_reduce::kWarpsPerBlock + warp;
  if (row >= n_rows) return;
  const RowsPair<L> pair{ct, wxy, zi, wz, K};
  row_reduce::reduce_row<L>(row, order, offsets, nz, smem + warp * nz,
                            out + (size_t)row * (size_t)nz, pair);
}

template <int L>
int launch(const float* ct, const int* order, const int* offsets,
           const float* wxy, int K, const int* zi, const float* wz,
           int n_rows, int nz, float* out, cudaStream_t stream) {
  rows_value_bwd_kernel<L><<<row_reduce::blocks_for(n_rows),
                             32 * row_reduce::kWarpsPerBlock,
                             row_reduce::smem_bytes(nz), stream>>>(
      ct, order, offsets, wxy, K, zi, wz, n_rows, nz, out);
  return (int)cudaGetLastError();
}

}  // namespace

// ct (N,); order (N*K,) flat pair ids sorted by row; offsets (n_rows+1,);
// wxy (N, K); zi, wz (N, L); out (n_rows, nz), fully written.
extern "C" int ionotomo_rows_value_bwd(const float* ct, const int* order,
                                       const int* offsets, const float* wxy,
                                       int K, const int* zi, const float* wz,
                                       int L, int n_rows, int nz, float* out,
                                       void* stream) {
  if (K < 1 || K > kMaxK || L < 1 || L > kMaxL || nz < 1 || n_rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 1: return launch<1>(ct, order, offsets, wxy, K, zi, wz, n_rows, nz, out, s);
    case 2: return launch<2>(ct, order, offsets, wxy, K, zi, wz, n_rows, nz, out, s);
    case 3: return launch<3>(ct, order, offsets, wxy, K, zi, wz, n_rows, nz, out, s);
    default: return launch<4>(ct, order, offsets, wxy, K, zi, wz, n_rows, nz, out, s);
  }
}
