// KG: the lane-wise vector gather out[i, j] = table[idx[i, j], j].
//
// Replaces: bench/probe_gather.py, probe_mosaic_vector_gather (:21, the
// pl.pallas_call at :43), the only Pallas kernel of the JAX package: a
// take_along_axis(axis=0) of a (16384, 128) f32 table inside a kernel,
// which Mosaic could not lower for tables larger than one vreg. The port's
// probe (ionotomo_tpu_torch/probes/gather.py) checks and times it.
//
// Bound on the H100: memory. The function reads its indices once, writes
// its output once and needs each distinct (row, column) value its indices
// touch once: at the probe's uniform indices 63 % of the table, 22 MB at
// (16384, 128), 0.0066 ms. What binds the kernel is the L2's sectors: a
// warp's 32 table loads fall in 32 random rows and use 4 bytes of each
// 32-byte sector they move, 67 MB of sectors for 8 MB of values; the 24
// MB of table, indices and output stay in the 50 MB L2 between calls.
//
// Design: one thread per output element, neighbouring threads on
// neighbouring columns, so index loads and output stores coalesce into
// whole sectors. Indices are clamped into the table, so a bad index reads
// no memory outside it; every output is a copy of a table value, bitwise
// torch.gather's on the clamped indices.
//
// What the table in shared memory did instead (chip_smoke.py
// --gather-study, an NVIDIA H100 80GB HBM3 at 700 W; warm L2, (16384,
// 128)): this kernel 0.0184 ms, four elements a thread 0.0186, a CTA a
// band of 8 columns through L1 0.0213, a band's row slabs in CTAs' own
// shared memory 0.041, a band held by a cluster of 4 or 8 CTAs and read
// through distributed shared memory 0.050 (scattered 4-byte remote reads
// run at about one per 4 cycles an SM, below the L2's random sector
// rate). They stay below as study builds, compiled only with their
// defines.
#include <cuda_runtime.h>
#include <stdint.h>

// Study only (chip_smoke.py --gather-study builds a library for each):
// KG_FORCE 4 runs four elements a thread, 2 a CTA a band through L1, 3 a
// band's row slabs in CTAs' own shared memory; KG_CLUSTER C the band held
// by a cluster of C CTAs; a shape the forced kernel cannot take returns
// cudaErrorInvalidValue.
#ifndef KG_FORCE
#define KG_FORCE 0
#endif
#ifndef KG_CLUSTER
#define KG_CLUSTER 0
#endif
#define KG_STUDY (KG_FORCE || KG_CLUSTER)

#if KG_STUDY
#include <cooperative_groups.h>
namespace cg = cooperative_groups;
#endif

namespace {

__device__ __forceinline__ int clamp_row(int r, int n_rows) {
  return min(max(r, 0), n_rows - 1);
}

__global__ void vector_gather_kernel(const float* __restrict__ table,
                                     int n_rows,
                                     const int* __restrict__ idx,
                                     long long n, int width,
                                     float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int j = (int)(e % width);
  const int r = clamp_row(idx[e], n_rows);
  out[e] = __ldg(table + (size_t)r * (size_t)width + j);
}

#if KG_STUDY
constexpr int kBand = 8;           // columns a band: one 32-byte sector
constexpr int kBandThreads = 512;  // two threads a row, 256 rows a pass
constexpr int kRowsInFlight = 4;   // output rows a thread loads at once
constexpr int kMaxCluster = 8;     // the portable cluster size

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// 4 neighbouring elements of one row a thread (width a multiple of 4).
__global__ void vector_gather_vec4_kernel(const float* __restrict__ table,
                                          int n_rows,
                                          const int4* __restrict__ idx,
                                          long long n4, int width,
                                          float4* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n4) return;
  const size_t j = (size_t)((e * 4) % width);
  const int4 v = __ldg(idx + e);
  float4 x;
  x.x = __ldg(table + (size_t)clamp_row(v.x, n_rows) * width + j);
  x.y = __ldg(table + (size_t)clamp_row(v.y, n_rows) * width + j + 1);
  x.z = __ldg(table + (size_t)clamp_row(v.z, n_rows) * width + j + 2);
  x.w = __ldg(table + (size_t)clamp_row(v.w, n_rows) * width + j + 3);
  out[e] = x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Band blockIdx.y of the table in a cluster of 1 << log2_c CTAs along x;
// CTA blockIdx.x walks output rows [blockIdx.x * rows_per_cta, ...).
// Shared memory: rank_rows rows of 8 floats (two float4s a row).
__global__ void __launch_bounds__(kBandThreads)
    vector_gather_band_kernel(const float* __restrict__ table, int n_rows,
                              int width, const int* __restrict__ idx, int m,
                              float* __restrict__ out, int log2_c,
                              int rank_rows, int rows_per_cta) {
  extern __shared__ float4 band[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c_mask = (1 << log2_c) - 1;
  const int col0 = blockIdx.y * kBand;
  // 1. this rank's rows r = rank + l * C, as 16-byte halves
  for (int q = threadIdx.x; q < 2 * rank_rows; q += kBandThreads) {
    const int r = rank + ((q >> 1) << log2_c);
    if (r < n_rows)
      cp_async16(band + q, table + (size_t)r * width + col0 + 4 * (q & 1));
  }
  cp_async_wait_all();
  cluster.sync();
  // 2. this CTA's output rows: thread t takes half t & 1 of a row's band
  const float* band_f = reinterpret_cast<const float*>(band);
  const int half = threadIdx.x & 1;
  const int i_begin = blockIdx.x * rows_per_cta;
  const int i_end = min(m, i_begin + rows_per_cta);
  constexpr int kStride = kBandThreads / 2;
  for (int i0 = i_begin + (threadIdx.x >> 1); i0 < i_end;
       i0 += kStride * kRowsInFlight) {
    int4 v[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int i = i0 + u * kStride;
      if (i < i_end)
        v[u] = __ldg(reinterpret_cast<const int4*>(
                         idx + (size_t)i * width + col0) + half);
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int i = i0 + u * kStride;
      if (i >= i_end) continue;
      const int rs[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      float x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = clamp_row(rs[k], n_rows);
        x[k] = *cluster.map_shared_rank(
            band_f + (r >> log2_c) * kBand + 4 * half + k,
            r & c_mask);
      }
      reinterpret_cast<float4*>(out + (size_t)i * width + col0)[half] =
          make_float4(x[0], x[1], x[2], x[3]);
    }
  }
  cluster.sync();
}

// Study: a CTA walks one band of 8 columns (thread t: column t & 7, row
// t >> 3), reading the table through L1, so that an SM's loads touch only
// its band's sectors.
constexpr int kL1Threads = 1024;
__global__ void __launch_bounds__(kL1Threads)
    vector_gather_l1_band_kernel(const float* __restrict__ table, int n_rows,
                                 int width, const int* __restrict__ idx,
                                 int m, float* __restrict__ out,
                                 int rows_per_cta) {
  const int col = blockIdx.y * kBand + (threadIdx.x & 7);
  const int i_begin = blockIdx.x * rows_per_cta;
  const int i_end = min(m, i_begin + rows_per_cta);
  constexpr int kStride = kL1Threads / kBand;
  for (int i0 = i_begin + (threadIdx.x >> 3); i0 < i_end;
       i0 += kStride * kRowsInFlight) {
    int r[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int i = i0 + u * kStride;
      r[u] = i < i_end ? clamp_row(__ldg(idx + (size_t)i * width + col),
                                   n_rows)
                       : 0;
    }
    float x[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u)
      x[u] = __ldg(table + (size_t)r[u] * width + col);
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int i = i0 + u * kStride;
      if (i < i_end) out[(size_t)i * width + col] = x[u];
    }
  }
}

// Study: a CTA holds rows [lo, lo + slab) of one band in its own shared
// memory (blockIdx.z the slab) and writes, of its share of the output
// rows, the elements whose row it holds; no cluster, each element written
// by one CTA.
__global__ void __launch_bounds__(kBandThreads)
    vector_gather_slab_kernel(const float* __restrict__ table, int n_rows,
                              int width, const int* __restrict__ idx, int m,
                              float* __restrict__ out, int slab,
                              int rows_per_cta) {
  extern __shared__ float4 band[];
  const int lo = blockIdx.z * slab;
  const int hi = min(n_rows, lo + slab);
  const int col0 = blockIdx.y * kBand;
  for (int q = threadIdx.x; q < 2 * (hi - lo); q += kBandThreads)
    cp_async16(band + q,
               table + (size_t)(lo + (q >> 1)) * width + col0 + 4 * (q & 1));
  cp_async_wait_all();
  __syncthreads();
  const float* band_f = reinterpret_cast<const float*>(band);
  const int half = threadIdx.x & 1;
  const int i_begin = blockIdx.x * rows_per_cta;
  const int i_end = min(m, i_begin + rows_per_cta);
  constexpr int kStride = kBandThreads / 2;
  for (int i0 = i_begin + (threadIdx.x >> 1); i0 < i_end;
       i0 += kStride * kRowsInFlight) {
    int4 v[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int i = i0 + u * kStride;
      if (i < i_end)
        v[u] = __ldg(reinterpret_cast<const int4*>(
                         idx + (size_t)i * width + col0) + half);
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int i = i0 + u * kStride;
      if (i >= i_end) continue;
      const int rs[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      float* o = out + (size_t)i * width + col0 + 4 * half;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = clamp_row(rs[k], n_rows);
        if (r >= lo && r < hi) o[k] = band_f[(r - lo) * kBand + 4 * half + k];
      }
    }
  }
}

int device_attribute(cudaDeviceAttr what) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, what, dev);
  return v;
}

// The band kernel's launch at one shape.
struct BandLaunch {
  int log2_c, p, rank_rows, rows_per_cta;
  size_t smem;
};

// The band kernel's launch with clusters of KG_CLUSTER CTAs, P clusters a
// band where bands x C CTAs leave SMs idle; false if the band does not fit.
bool band_launch(int n_rows, int width, int m, BandLaunch* b) {
  const int smem_max =
      device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const int n_sm = device_attribute(cudaDevAttrMultiProcessorCount);
  const int bands = width / kBand;
  int log2_c = 0;
  while ((1 << log2_c) < KG_CLUSTER) ++log2_c;
  const int c = 1 << log2_c;
  const int rank_rows = (n_rows + c - 1) / c;
  const size_t smem = (size_t)rank_rows * kBand * sizeof(float);
  if (c > kMaxCluster || smem > (size_t)smem_max) return false;
  int p = n_sm / (bands * c);
  p = max(1, min(p, (m + c * kBandThreads / 2 - 1) / (c * kBandThreads / 2)));
  b->log2_c = log2_c;
  b->p = p;
  b->rank_rows = rank_rows;
  b->rows_per_cta = (m + c * p - 1) / (c * p);
  b->smem = smem;
  return true;
}

cudaError_t launch_band(const float* table, int n_rows, int width,
                        const int* idx, int m, float* out,
                        const BandLaunch& b, cudaStream_t stream) {
  static size_t smem_set = 0;  // the dynamic shared memory allowed so far
  if (b.smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        vector_gather_band_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b.smem);
    if (e != cudaSuccess) return e;
    smem_set = b.smem;
  }
  const int c = 1 << b.log2_c;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(c * b.p), (unsigned)(width / kBand), 1);
  cfg.blockDim = dim3(kBandThreads, 1, 1);
  cfg.dynamicSmemBytes = b.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a cluster that cannot be placed would fail the launch: ask first
  static int placed_c = 0;
  static size_t placed_smem = 0;
  if (c != placed_c || b.smem != placed_smem) {
    int clusters = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(
        &clusters, vector_gather_band_kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    placed_c = c;
    placed_smem = b.smem;
  }
  return cudaLaunchKernelEx(&cfg, vector_gather_band_kernel, table, n_rows,
                            width, idx, m, out, b.log2_c, b.rank_rows,
                            b.rows_per_cta);
}

// The forced study kernel.
cudaError_t launch_study(const float* table, int n_rows, int width,
                         const int* idx, int m, float* out, cudaStream_t s) {
  const bool aligned = aligned16(table) && aligned16(idx) && aligned16(out);
  if (!aligned || width % (KG_FORCE == 4 ? 4 : kBand))
    return cudaErrorInvalidValue;
  if (KG_CLUSTER) {
    BandLaunch b;
    if (width / kBand > 65535 || !band_launch(n_rows, width, m, &b))
      return cudaErrorInvalidValue;
    const cudaError_t e = launch_band(table, n_rows, width, idx, m, out, b, s);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
  const int n_sm = device_attribute(cudaDevAttrMultiProcessorCount);
  const int bands = width / kBand;
  if (KG_FORCE == 4) {
    const long long n4 = (long long)m * width / 4;
    vector_gather_vec4_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
        table, n_rows, reinterpret_cast<const int4*>(idx), n4, width,
        reinterpret_cast<float4*>(out));
  } else if (KG_FORCE == 2) {
    const int p = max(1, 2 * n_sm / bands);
    vector_gather_l1_band_kernel<<<dim3(p, bands), kL1Threads, 0, s>>>(
        table, n_rows, width, idx, m, out, (m + p - 1) / p);
  } else {
    const int smem_max =
        device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin);
    const int max_rows = smem_max / (kBand * (int)sizeof(float));
    const int k = (n_rows + max_rows - 1) / max_rows;
    const int slab = (n_rows + k - 1) / k;
    const int p = max(1, n_sm / (bands * k));
    const size_t smem = (size_t)slab * kBand * sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        vector_gather_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    vector_gather_slab_kernel<<<dim3(p, bands, k), kBandThreads, smem, s>>>(
        table, n_rows, width, idx, m, out, slab, (m + p - 1) / p);
  }
  return cudaGetLastError();
}
#endif  // KG_STUDY

}  // namespace

// table (n_rows, width); idx, out (m, width).
extern "C" int ionotomo_vector_gather(const float* table, int n_rows,
                                      int width, const int* idx, int m,
                                      float* out, void* stream) {
  if (n_rows < 1 || width < 1 || m < 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)m * (long long)width;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#if KG_STUDY
  return (int)launch_study(table, n_rows, width, idx, m, out, s);
#else
  const int threads = 256;
  vector_gather_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                         s>>>(table, n_rows, idx, n, width, out);
  return (int)cudaGetLastError();
#endif
}
