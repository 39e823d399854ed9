// K2b: forward of the row-gather value map with a leading member axis,
//   out[b, n] = sum_k wxy[n,k] * sum_l wz[n,l] * table[b, ri[n,k], zi[n,l]].
//
// Replaces: ionotomo_tpu/core/tricubic.py, _rows_value_impl (the
// batched-table branch, :296-314): what rows_value_p becomes under
// jax.vmap over the field, the member axis of the ensemble Kalman filter.
// The indices and weights are the members' shared ray geometry; only the
// table has the member axis. At config 5: 8 members, 650,000 points
// (330,000 on the inner bundle), zp (K=8, L=3), a (16384, 128) table per
// member.
//
// Bound on the H100: a gather. The index and weight streams (88 B a zp
// point) are read once for all members; each member adds its K x L taps
// and 4 B of output per point.
//
// Design: one thread per point. It loads its row indices and weights once
// into registers and loops over the member tables, so one index and weight
// stream serves every member. Per member the taps are summed in the order
// K2 (rows_value_fwd.cu) sums them for the given xy_first, so member b of
// the result is bitwise K2 of table[b]. Indices are clamped into the
// table. No atomics: bitwise identical from run to run.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kMaxL = 4;

template <bool kXyFirst>
__global__ void rows_value_fwd_batched_kernel(
    const float* __restrict__ table, int n_members, int n_rows, int nz,
    const int* __restrict__ ri, const float* __restrict__ wxy, int K,
    const int* __restrict__ zi, const float* __restrict__ wz, int L, int n,
    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int z[kMaxL];
  float w[kMaxL];
#pragma unroll
  for (int l = 0; l < kMaxL; ++l) {
    if (l < L) {
      z[l] = min(max(zi[(size_t)i * L + l], 0), nz - 1);
      w[l] = wz[(size_t)i * L + l];
    } else {
      z[l] = 0;
      w[l] = 0.0f;
    }
  }
  int r[kMaxK];
  float wk[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < K) {
      r[k] = min(max(ri[(size_t)i * K + k], 0), n_rows - 1);
      wk[k] = wxy[(size_t)i * K + k];
    } else {
      r[k] = 0;
      wk[k] = 0.0f;
    }
  }
  const size_t member_stride = (size_t)n_rows * (size_t)nz;
  for (int b = 0; b < n_members; ++b) {
    const float* tb = table + (size_t)b * member_stride;
    float acc = 0.0f;
    if (kXyFirst) {
      float s[kMaxL] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) {
          const float* row = tb + (size_t)r[k] * (size_t)nz;
#pragma unroll
          for (int l = 0; l < kMaxL; ++l)
            if (l < L) s[l] += wk[k] * __ldg(row + z[l]);
        }
      }
#pragma unroll
      for (int l = 0; l < kMaxL; ++l)
        if (l < L) acc += w[l] * s[l];
    } else {
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) {
          const float* row = tb + (size_t)r[k] * (size_t)nz;
          float pencil = 0.0f;
#pragma unroll
          for (int l = 0; l < kMaxL; ++l)
            if (l < L) pencil += w[l] * __ldg(row + z[l]);
          acc += pencil * wk[k];
        }
      }
    }
    out[(size_t)b * (size_t)n + i] = acc;
  }
}

}  // namespace

// table (B, n_rows, nz); ri, wxy (N, K); zi, wz (N, L); out (B, N).
extern "C" int ionotomo_rows_value_fwd_batched(
    const float* table, int n_members, int n_rows, int nz, const int* ri,
    const float* wxy, int K, const int* zi, const float* wz, int L, int n,
    int xy_first, float* out, void* stream) {
  if (n_members < 1 || K < 1 || K > kMaxK || L < 1 || L > kMaxL)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (xy_first) {
    rows_value_fwd_batched_kernel<true>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(
            table, n_members, n_rows, nz, ri, wxy, K, zi, wz, L, n, out);
  } else {
    rows_value_fwd_batched_kernel<false>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(
            table, n_members, n_rows, nz, ri, wxy, K, zi, wz, L, n, out);
  }
  return (int)cudaGetLastError();
}
