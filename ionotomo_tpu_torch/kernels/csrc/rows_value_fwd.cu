// K2: forward of the row-gather value map,
//   out[n] = sum_k wxy[n,k] * sum_l wz[n,l] * table[ri[n,k], zi[n,l]].
//
// Replaces: ionotomo_tpu/core/tricubic.py, _rows_value_impl (the unbatched
// branch), the impl of the custom primitive rows_value_p that every
// value gather of the JAX package binds: boxspline.interp_rows (zp: K=8
// rows, L=3 z-taps, xy-first) and tricubic.interp_rows (cubic: K=16,
// L=4, z-first). In the bent-ray slice it is the value gather of
// dtec_paired_hermite at every path sample.
//
// Bound on the H100: a gather. A zp point reads 8 rows x 3 taps x 4 B =
// 96 B of table (7 rows live; the 8th has weight 0 but is read, as the
// kernel is generic in K) plus its own 8+3 indices and 8+3 weights
// (88 B), for ~50 flops, so it is memory-latency bound.
//
// Design: one thread per point; the reference's dense (N, K, nz) pencil
// and its (N, nz) z-band are never built: each thread loads only the
// K x L taps. The summation order follows the reference's contraction
// order: xy first (s_l = sum_k wxy_k T[r_k, z_l], then sum_l wz_l s_l),
// or z first (p_k = sum_l wz_l T[r_k, z_l], then sum_k wxy_k p_k).
// Indices are clamped into the table, so a bad index cannot read outside
// it; the callers' indices are always in range.
//
// Determinism: no atomics and a fixed summation order per thread, so the
// output is bitwise identical from run to run.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kMaxL = 4;

template <bool kXyFirst>
__global__ void rows_value_fwd_kernel(const float* __restrict__ table,
                                      int n_rows, int nz,
                                      const int* __restrict__ ri,
                                      const float* __restrict__ wxy, int K,
                                      const int* __restrict__ zi,
                                      const float* __restrict__ wz, int L,
                                      int n, float* __restrict__ out) {
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
  if (kXyFirst) {
    float s[kMaxL] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < K) {
        const int r = min(max(ri[(size_t)i * K + k], 0), n_rows - 1);
        const float wk = wxy[(size_t)i * K + k];
        const float* row = table + (size_t)r * (size_t)nz;
#pragma unroll
        for (int l = 0; l < kMaxL; ++l)
          if (l < L) s[l] += wk * __ldg(row + z[l]);
      }
    }
    float acc = 0.0f;
#pragma unroll
    for (int l = 0; l < kMaxL; ++l)
      if (l < L) acc += w[l] * s[l];
    out[i] = acc;
  } else {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < K) {
        const int r = min(max(ri[(size_t)i * K + k], 0), n_rows - 1);
        const float* row = table + (size_t)r * (size_t)nz;
        float pencil = 0.0f;
#pragma unroll
        for (int l = 0; l < kMaxL; ++l)
          if (l < L) pencil += w[l] * __ldg(row + z[l]);
        acc += pencil * wxy[(size_t)i * K + k];
      }
    }
    out[i] = acc;
  }
}

}  // namespace

extern "C" int ionotomo_rows_value_fwd(const float* table, int n_rows, int nz,
                                       const int* ri, const float* wxy, int K,
                                       const int* zi, const float* wz, int L,
                                       int n, int xy_first, float* out,
                                       void* stream) {
  if (K < 1 || K > kMaxK || L < 1 || L > kMaxL) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (xy_first) {
    rows_value_fwd_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        table, n_rows, nz, ri, wxy, K, zi, wz, L, n, out);
  } else {
    rows_value_fwd_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        table, n_rows, nz, ri, wxy, K, zi, wz, L, n, out);
  }
  return (int)cudaGetLastError();
}
