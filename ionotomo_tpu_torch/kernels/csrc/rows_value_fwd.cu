// K2: forward of the row-gather value map,
//   out[n] = sum_k wxy[n,k] * sum_l wz[n,l] * table[ri[n,k], zi[n,l]],
// and the sort keys of the point order it may run in, and the permutation
// of its inputs into that order.
//
// Replaces: ionotomo_tpu/core/tricubic.py, _rows_value_impl (the unbatched
// branch), the impl of the custom primitive rows_value_p that every
// value gather of the JAX package binds: boxspline.interp_rows (zp: K=8
// rows, L=3 z-taps, xy-first), zpcubic.interp_rows (zpc: K=8, L=4,
// xy-first) and tricubic.interp_rows (cubic: K=16, L=4, z-first); the
// port's triquadratic.interp_rows (K=9, L=3, z-first, the generic kernel)
// computes the reference's pencil sums through it too. It is R in every
// J of the MAP solves and the filters (forward/tec.py, PairedDtecLinear)
// and the value gather of dtec_paired_hermite at every path sample.
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
//   permuted into the order (permute_points_tile_kernel below), so that
//   thread t reads row t of them, coalesced. No order: ray order;
// - the three shapes of the main paths (zp, zpc and cubic; boxspline,
//   zpcubic and tricubic.interp_rows) compiled with K and L fixed, each
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
// The permute only moves bits, so bytes bound it: each input row read
// once, each output row written once, the order read once (210 MB at
// config 4's 650,000 cubic points, 117 MB at config 3b's 650,000 zp
// points, past the 50 MB L2). A block takes a tile of 256 points of one
// array, the arrays one after another along blockIdx.y so that one
// array's rows at a time share the L2: it reads the tile's 256 sources
// once, gathers their rows into shared memory (16-byte vectors where a
// row is a multiple of 16 bytes, zp's 12-byte zi and wz rows by word;
// four loads a thread in flight), then writes the tile out as contiguous
// 16-byte stores, whole sectors. At config 4's points: 0.082 ms, against
// 0.113 for a thread a point (the design before, whose 16-byte stores
// 64 bytes apart half-filled each sector an instruction touched) and
// 0.100 for a vector a thread without the tile (chip_smoke.py
// --gather-study, an NVIDIA H100 80GB HBM3 at 700 W).
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

// Study only (chip_smoke.py --gather-study builds a library for each):
// PERMUTE_VARIANT 0 runs the former permute (a thread copies a point's
// four rows), 1 one 16-byte vector or word of one array a thread without
// a tile; PERMUTE_TILE, PERMUTE_THREADS and PERMUTE_LOADS resize the
// tile (the default, variant 2).
#ifndef PERMUTE_VARIANT
#define PERMUTE_VARIANT 2
#endif
#ifndef PERMUTE_TILE
#define PERMUTE_TILE 256
#endif
#ifndef PERMUTE_THREADS
#define PERMUTE_THREADS 256
#endif
#ifndef PERMUTE_LOADS
#define PERMUTE_LOADS 4
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

// The main paths' shapes, K and L fixed: zp (K=8, L=3, xy first), zpc
// (K=8, L=4, xy first) and cubic (K=16, L=4, z first); one thread a
// point. Thread t reads row t of
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

// The four arrays of a point set the permute moves, each (n, words[a])
// 4-byte words.
struct PermuteArrays {
  const int* in[4];
  int* out[4];
  int words[4];
};

template <class T>
__device__ __forceinline__ T pick(int a, T x0, T x1, T x2, T x3) {
  return a == 0 ? x0 : a == 1 ? x1 : a == 2 ? x2 : x3;
}

#if PERMUTE_VARIANT == 0
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

// The former kernel: a thread copies a point's four rows.
template <bool kVecK, bool kVecL>
__global__ void permute_points_by_point_kernel(const int* __restrict__ order,
                                               int n, PermuteArrays a) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int src = __ldg(order + t);
  copy_row<kVecK>(a.in[0], a.out[0], a.words[0], src, t);
  copy_row<kVecK>(a.in[1], a.out[1], a.words[1], src, t);
  copy_row<kVecL>(a.in[2], a.out[2], a.words[2], src, t);
  copy_row<kVecL>(a.in[3], a.out[3], a.words[3], src, t);
}
#elif PERMUTE_VARIANT == 2
constexpr int kPermuteTile = PERMUTE_TILE;
constexpr int kPermuteThreads = PERMUTE_THREADS;
constexpr int kLoadsInFlight = PERMUTE_LOADS;

// A block tile: the rows of kPermuteTile points of array blockIdx.y
// gathered into shared memory (their sources first, then kLoadsInFlight
// loads a thread at once), then written out as contiguous 16-byte stores.
__global__ void __launch_bounds__(kPermuteThreads)
    permute_points_tile_kernel(const int* __restrict__ order, int n,
                               PermuteArrays a, int vec) {
  __shared__ int4 tile4[kPermuteTile * kMaxK / 4];
  __shared__ int src[kPermuteTile];
  int* tile = reinterpret_cast<int*>(tile4);
  const int w = blockIdx.y;
  const int words = pick(w, a.words[0], a.words[1], a.words[2], a.words[3]);
  const int* in = pick(w, a.in[0], a.in[1], a.in[2], a.in[3]);
  int* out = pick(w, a.out[0], a.out[1], a.out[2], a.out[3]);
  const int t0 = blockIdx.x * kPermuteTile;
  const int rows = min(kPermuteTile, n - t0);
  const int total = rows * words;
  for (int q = threadIdx.x; q < rows; q += kPermuteThreads)
    src[q] = __ldg(order + t0 + q);
  __syncthreads();
  constexpr int kStep = kPermuteThreads * kLoadsInFlight;
  if (vec && words % 4 == 0) {
    const int per = words / 4;
    const int4* in4 = reinterpret_cast<const int4*>(in);
    for (int q0 = threadIdx.x; q0 < rows * per; q0 += kStep) {
      int4 v[kLoadsInFlight];
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int q = q0 + u * kPermuteThreads;
        if (q < rows * per) {
          const int r = q / per;
          v[u] = __ldg(in4 + (size_t)src[r] * per + (q - r * per));
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int q = q0 + u * kPermuteThreads;
        if (q < rows * per) tile4[q] = v[u];
      }
    }
  } else {
    for (int q0 = threadIdx.x; q0 < total; q0 += kStep) {
      int v[kLoadsInFlight];
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int q = q0 + u * kPermuteThreads;
        if (q < total) {
          const int r = q / words;
          v[u] = __ldg(in + (size_t)src[r] * words + (q - r * words));
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadsInFlight; ++u) {
        const int q = q0 + u * kPermuteThreads;
        if (q < total) tile[q] = v[u];
      }
    }
  }
  __syncthreads();
  int* dst = out + (size_t)t0 * words;
  const int head = min(total, (int)(((16 - ((uintptr_t)dst & 15)) & 15) / 4));
  const int body = (total - head) / 4;
  for (int q = threadIdx.x; q < head; q += kPermuteThreads) dst[q] = tile[q];
  for (int q = threadIdx.x; q < body; q += kPermuteThreads) {
    const int* v = tile + head + 4 * q;
    reinterpret_cast<int4*>(dst + head)[q] = make_int4(v[0], v[1], v[2], v[3]);
  }
  for (int q = head + 4 * body + threadIdx.x; q < total;
       q += kPermuteThreads)
    dst[q] = tile[q];
}
#else
// Element e of row e / per of an output, row order[e / per] of the input;
// an element is a 16-byte vector or a 4-byte word, per of them a row.
template <int kPer, class T>
__device__ __forceinline__ void permute_element(const int* __restrict__ order,
                                                const T* __restrict__ in,
                                                T* __restrict__ out, int e,
                                                int per) {
  const int p = kPer ? kPer : per;
  const int row = e / p;
  out[e] = __ldg(in + (size_t)__ldg(order + row) * p + (e - row * p));
}

// A point set's ri, wxy, zi, wz permuted into a point order, array
// blockIdx.y; one element a thread, so a warp writes 32 neighbouring
// elements (512 contiguous bytes in 16-byte vectors, 128 in words) and
// reads whole rows.
__global__ void permute_points_kernel(const int* __restrict__ order, int n,
                                      PermuteArrays a, int vec) {
  const int w = blockIdx.y;
  const int words = pick(w, a.words[0], a.words[1], a.words[2], a.words[3]);
  const int* in = pick(w, a.in[0], a.in[1], a.in[2], a.in[3]);
  int* out = pick(w, a.out[0], a.out[1], a.out[2], a.out[3]);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (vec && words % 4 == 0) {
    const int per = words / 4;
    if (e >= n * per) return;
    const int4* in4 = reinterpret_cast<const int4*>(in);
    int4* out4 = reinterpret_cast<int4*>(out);
    if (per == 4) permute_element<4>(order, in4, out4, e, per);
    else if (per == 2) permute_element<2>(order, in4, out4, e, per);
    else if (per == 1) permute_element<1>(order, in4, out4, e, per);
    else permute_element<0>(order, in4, out4, e, per);
  } else {
    if (e >= n * words) return;
    if (words == 3) permute_element<3>(order, in, out, e, words);
    else permute_element<0>(order, in, out, e, words);
  }
}
#endif

}  // namespace

// order: (n,) int32 point of each thread, with ri, wxy, zi, wz already
// permuted into it (row t is point order[t]'s): thread t reads row t and
// writes out[order[t]]; or null (point t). The fixed shapes (K=8, L=3 or
// 4, xy first; K=16, L=4, z first) with the four arrays 16-byte aligned
// run the fixed kernel; any other call runs the generic kernel and takes
// no order.
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
  if (aligned && xy_first && K == 8 && L == 4)
    return (int)launch_fixed<true, 8, 4>(table, n_rows, nz, ri, wxy, zi, wz,
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
  if (n < 1 || K < 1 || K > kMaxK || L < 1 || L > kMaxK ||
      n > (int)(0x7fffffff / kMaxK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const PermuteArrays a = {
      {(const int*)ri, (const int*)wxy, (const int*)zi, (const int*)wz},
      {(int*)ri_out, (int*)wxy_out, (int*)zi_out, (int*)wz_out},
      {K, K, L, L}};
#if PERMUTE_VARIANT == 0
  const bool vk = vec && K % 4 == 0, vl = vec && L % 4 == 0;
  const int blocks = (n + 255) / 256;
  if (vk && vl)
    permute_points_by_point_kernel<true, true><<<blocks, 256, 0, s>>>(order, n,
                                                                      a);
  else if (vk)
    permute_points_by_point_kernel<true, false><<<blocks, 256, 0, s>>>(
        order, n, a);
  else
    permute_points_by_point_kernel<false, false><<<blocks, 256, 0, s>>>(
        order, n, a);
#elif PERMUTE_VARIANT == 2
  permute_points_tile_kernel<<<dim3((n + kPermuteTile - 1) / kPermuteTile, 4),
                               kPermuteThreads, 0, s>>>(order, n, a, vec);
#else
  int per = 1;  // elements of the widest array's row
  for (int w = 0; w < 4; ++w)
    per = max(per, vec && a.words[w] % 4 == 0 ? a.words[w] / 4 : a.words[w]);
  const long long elems = (long long)n * per;
  permute_points_kernel<<<dim3((unsigned)((elems + 255) / 256), 4), 256, 0,
                          s>>>(order, n, a, vec);
#endif
  return (int)cudaGetLastError();
}
