// K2: forward of the row-gather value map,
//   out[n] = sum_k wxy[n,k] * sum_l wz[n,l] * table[ri[n,k], zi[n,l]],
// and the sort keys of the point order it may run in, and the permutation
// of its inputs into that order.
//
// Replaces: ionotomo_tpu/core/tricubic.py, _rows_value_impl (the unbatched
// branch), the impl of the custom primitive rows_value_p that every
// value gather of the JAX package binds: boxspline.interp_rows (zp: K=8
// rows, L=3 z-taps, xy-first) and tricubic.interp_rows (cubic: K=16,
// L=4, z-first). It is R in every J of the MAP solves and the filters
// (forward/tec.py, PairedDtecLinear) and the value gather of
// dtec_paired_hermite at every path sample.
//
// Bound on the H100: a gather. A cubic point reads 16 rows x 4 taps (64
// scalars at 16 rows of a table that at 256^3 is 64 MiB, past the 50 MB
// L2) plus its own 40 indices and weights, for ~160 flops, so it is bound
// by the sectors the taps cost: a row's 4 taps are 16 bytes at any 4-byte
// offset, one or two 32-byte sectors.
//
// Design:
// - a point order (point_order_keys_kernel below, sorted once per ray
//   bundle by kernels.point_order): thread t computes point order[t] and
//   writes out[order[t]], so a warp holds points of neighbouring stencils,
//   which share rows and sectors in L1 and L2; the bundle keeps its inputs
//   permuted into the order (permute_points_kernel below), so that thread
//   t reads row t of them, coalesced. No order: ray order;
// - the two shapes of the main paths compiled with K and L fixed, each
//   point's index and weight rows read as 16-byte vectors (the arrays
//   16-byte aligned, checked by the host); any other shape, or unaligned
//   arrays, run the generic kernel, one scalar load a value, in ray order;
// - the summation order is the reference's contraction order: xy first
//   (s_l = sum_k wxy_k T[r_k, z_l], then sum_l wz_l s_l) or z first
//   (p_k = sum_l wz_l T[r_k, z_l], then sum_k wxy_k p_k), written as the
//   same expressions in both kernels, so each point's output is bitwise
//   the same in either kernel and in any order.
// Indices are clamped into the table, so a bad index cannot read outside
// it; the callers' indices are always in range.
//
// Determinism: no atomics and a fixed summation order per point, so the
// output is bitwise identical from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

// Study only (chip_smoke.py --k2-study builds a library with
// -DK2_ROW_VECTORS=0): the fixed shapes read a point's index and weight
// rows one scalar at a time.
#ifndef K2_ROW_VECTORS
#define K2_ROW_VECTORS 1
#endif

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


__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

// kN consecutive values from p, as 16-byte vectors when kVec (p 16-byte
// aligned) or as scalars.
template <int kN, bool kVec, class T, class T4>
__device__ __forceinline__ void load_row(const T* __restrict__ p, T (&v)[kN]) {
  if (kVec) {
#pragma unroll
    for (int j = 0; j < kN / 4; ++j) {
      const T4 q = __ldg(reinterpret_cast<const T4*>(p) + j);
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j) v[j] = __ldg(p + j);
  }
}

// The main paths' shapes, K and L fixed: zp (K=8, L=3, xy first) and
// cubic (K=16, L=4, z first); one thread a point. Thread t reads row t of
// the inputs and writes out[order[t]] (out[t] without an order).
template <bool kXyFirst, int kK, int kL>
__global__ void rows_value_fwd_fixed_kernel(
    const float* __restrict__ table, int n_rows, int nz,
    const int* __restrict__ ri, const float* __restrict__ wxy,
    const int* __restrict__ zi, const float* __restrict__ wz,
    const int* __restrict__ order, int n, float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  constexpr bool kVecK = K2_ROW_VECTORS && kK % 4 == 0;
  constexpr bool kVecL = K2_ROW_VECTORS && kL % 4 == 0;
  int z[kL];
  float w[kL];
  int r[kK];
  float wk[kK];
  load_row<kL, kVecL, int, int4>(zi + (size_t)t * kL, z);
  load_row<kL, kVecL, float, float4>(wz + (size_t)t * kL, w);
  load_row<kK, kVecK, int, int4>(ri + (size_t)t * kK, r);
#pragma unroll
  for (int l = 0; l < kL; ++l) z[l] = clampi(z[l], nz - 1);
  float acc = 0.0f;
  if (kXyFirst) {
    load_row<kK, kVecK, float, float4>(wxy + (size_t)t * kK, wk);
    float s[kL];
#pragma unroll
    for (int l = 0; l < kL; ++l) s[l] = 0.0f;
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float* row = table + (size_t)clampi(r[k], n_rows - 1) * (size_t)nz;
#pragma unroll
      for (int l = 0; l < kL; ++l) s[l] += wk[k] * __ldg(row + z[l]);
    }
#pragma unroll
    for (int l = 0; l < kL; ++l) acc += w[l] * s[l];
  } else {
    // every pencil first, then the weights: the taps' loads go out before
    // the weights' (at config 4's 650,000 points 0.0554 ms against 0.0680
    // with each pencil weighted as it is formed; chip_smoke.py --parent on
    // an NVIDIA H100 80GB HBM3)
    float p[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float* row = table + (size_t)clampi(r[k], n_rows - 1) * (size_t)nz;
      float pencil = 0.0f;
#pragma unroll
      for (int l = 0; l < kL; ++l) pencil += w[l] * __ldg(row + z[l]);
      p[k] = pencil;
    }
    load_row<kK, kVecK, float, float4>(wxy + (size_t)t * kK, wk);
#pragma unroll
    for (int k = 0; k < kK; ++k) acc += p[k] * wk[k];
  }
  out[order ? __ldg(order + t) : t] = acc;
}

template <bool kXyFirst, int kK, int kL>
cudaError_t launch_fixed(const float* table, int n_rows, int nz,
                         const int* ri, const float* wxy, const int* zi,
                         const float* wz, const int* order, int n, float* out,
                         cudaStream_t stream) {
  const int threads = 256;
  rows_value_fwd_fixed_kernel<kXyFirst, kK, kL>
      <<<(n + threads - 1) / threads, threads, 0, stream>>>(
          table, n_rows, nz, ri, wxy, zi, wz, order, n, out);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The sort key of a point for kernels.point_order: its stencil's base
// cell, (ix, iy) from the row ri[n, base] and iz from the z tap zi[n, zc],
// as row * nz + iz.
__global__ void point_order_keys_kernel(const int* __restrict__ ri, int K,
                                        int base, const int* __restrict__ zi,
                                        int L, int zc, int n, int n_rows,
                                        int nz, int* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = clampi(ri[(size_t)i * K + base], n_rows - 1);
  const int z = clampi(zi[(size_t)i * L + zc], nz - 1);
  keys[i] = r * nz + z;
}

// Row t of an (n, width) array of 4-byte words from row src of another,
// as 16-byte vectors when kVec (width a multiple of 4, the arrays 16-byte
// aligned).
template <bool kVec>
__device__ __forceinline__ void copy_row(const int* __restrict__ in,
                                         int* __restrict__ out, int width,
                                         int src, int t) {
  const int* from = in + (size_t)src * width;
  int* to = out + (size_t)t * width;
  if (kVec) {
    for (int j = 0; j < width / 4; ++j)
      reinterpret_cast<int4*>(to)[j] =
          __ldg(reinterpret_cast<const int4*>(from) + j);
  } else {
    for (int j = 0; j < width; ++j) to[j] = __ldg(from + j);
  }
}

// A point set's ri, wxy, zi, wz permuted into a point order: row t of each
// output is row order[t] of its input, the bits copied as they are.
template <bool kVecK, bool kVecL>
__global__ void permute_points_kernel(const int* __restrict__ order, int n,
                                      const int* __restrict__ ri,
                                      const int* __restrict__ wxy, int K,
                                      const int* __restrict__ zi,
                                      const int* __restrict__ wz, int L,
                                      int* __restrict__ ri_out,
                                      int* __restrict__ wxy_out,
                                      int* __restrict__ zi_out,
                                      int* __restrict__ wz_out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int src = __ldg(order + t);
  copy_row<kVecK>(ri, ri_out, K, src, t);
  copy_row<kVecK>(wxy, wxy_out, K, src, t);
  copy_row<kVecL>(zi, zi_out, L, src, t);
  copy_row<kVecL>(wz, wz_out, L, src, t);
}

}  // namespace

// order: (n,) int32 point of each thread, with ri, wxy, zi, wz already
// permuted into it (row t is point order[t]'s): thread t reads row t and
// writes out[order[t]]; or null (point t). The fixed shapes (K=8, L=3, xy
// first; K=16, L=4, z first) with the four arrays 16-byte aligned run the
// fixed kernel; any other call runs the generic kernel and takes no
// order.
extern "C" int ionotomo_rows_value_fwd(const float* table, int n_rows, int nz,
                                       const int* ri, const float* wxy, int K,
                                       const int* zi, const float* wz, int L,
                                       int n, int xy_first, const int* order,
                                       float* out, void* stream) {
  if (K < 1 || K > kMaxK || L < 1 || L > kMaxL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = aligned16(ri) && aligned16(wxy) && aligned16(zi) &&
                       aligned16(wz);
  if (aligned && xy_first && K == 8 && L == 3)
    return (int)launch_fixed<true, 8, 3>(table, n_rows, nz, ri, wxy, zi, wz,
                                         order, n, out, s);
  if (aligned && !xy_first && K == 16 && L == 4)
    return (int)launch_fixed<false, 16, 4>(table, n_rows, nz, ri, wxy, zi,
                                           wz, order, n, out, s);
  if (order) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (xy_first) {
    rows_value_fwd_kernel<true><<<blocks, threads, 0, s>>>(
        table, n_rows, nz, ri, wxy, K, zi, wz, L, n, out);
  } else {
    rows_value_fwd_kernel<false><<<blocks, threads, 0, s>>>(
        table, n_rows, nz, ri, wxy, K, zi, wz, L, n, out);
  }
  return (int)cudaGetLastError();
}

// keys: (n,) int32, row * nz + iz (rows * nz < 2^31).
extern "C" int ionotomo_point_order_keys(const int* ri, int K, int base,
                                         const int* zi, int L, int zc, int n,
                                         int n_rows, int nz, int* keys,
                                         void* stream) {
  if (n < 1 || base < 0 || base >= K || zc < 0 || zc >= L)
    return (int)cudaErrorInvalidValue;
  point_order_keys_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      ri, K, base, zi, L, zc, n, n_rows, nz, keys);
  return (int)cudaGetLastError();
}

// The K2 inputs of a point set permuted into order ((n,) int32): each
// output's row t is row order[t] of its input. vec: every array 16-byte
// aligned, so that rows of a multiple of 4 words move as 16-byte vectors.
extern "C" int ionotomo_permute_points(const int* order, int n, const void* ri,
                                       const void* wxy, int K, const void* zi,
                                       const void* wz, int L, int vec,
                                       void* ri_out, void* wxy_out,
                                       void* zi_out, void* wz_out,
                                       void* stream) {
  if (n < 1 || K < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const bool vk = vec && K % 4 == 0, vl = vec && L % 4 == 0;
  const int blocks = (n + 255) / 256;
  cudaStream_t s = (cudaStream_t)stream;
  const int *a = (const int*)ri, *b = (const int*)wxy, *c = (const int*)zi,
            *d = (const int*)wz;
  int *ao = (int*)ri_out, *bo = (int*)wxy_out, *co = (int*)zi_out,
      *dout = (int*)wz_out;
  if (vk && vl)
    permute_points_kernel<true, true><<<blocks, 256, 0, s>>>(
        order, n, a, b, K, c, d, L, ao, bo, co, dout);
  else if (vk)
    permute_points_kernel<true, false><<<blocks, 256, 0, s>>>(
        order, n, a, b, K, c, d, L, ao, bo, co, dout);
  else
    permute_points_kernel<false, false><<<blocks, 256, 0, s>>>(
        order, n, a, b, K, c, d, L, ao, bo, co, dout);
  return (int)cudaGetLastError();
}
