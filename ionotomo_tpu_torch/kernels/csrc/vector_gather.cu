// KG: the lane-wise vector gather out[i, j] = table[idx[i, j], j].
//
// Replaces: bench/probe_gather.py, probe_mosaic_vector_gather (:21, the
// pl.pallas_call at :43), the only Pallas kernel of the JAX package: a
// take_along_axis(axis=0) of a (16384, 128) f32 table inside a kernel,
// which Mosaic could not lower for tables larger than one vreg. On the
// H100 the same gather is a plain kernel; the port's probe
// (ionotomo_tpu_torch/probes/gather.py) checks and times it.
//
// Bound on the H100: memory. Each output element reads its index (4 B),
// one table element (4 B, a random row of its own column) and writes 4 B;
// the 8 MiB table stays in the 50 MB L2.
//
// Design: one thread per output element, neighbouring threads on
// neighbouring columns, so index loads and output stores coalesce and
// the table reads of a warp fall in 32 different rows of neighbouring
// columns. Indices are clamped into the table, so a bad index cannot
// read outside it.
#include <cuda_runtime.h>

namespace {

__global__ void vector_gather_kernel(const float* __restrict__ table,
                                     int n_rows,
                                     const int* __restrict__ idx,
                                     long long n, int width,
                                     float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int j = (int)(e % width);
  const int r = min(max(idx[e], 0), n_rows - 1);
  out[e] = __ldg(table + (size_t)r * (size_t)width + j);
}

}  // namespace

// table (n_rows, width); idx, out (m, width).
extern "C" int ionotomo_vector_gather(const float* table, int n_rows,
                                      int width, const int* idx, int m,
                                      float* out, void* stream) {
  if (n_rows < 1 || width < 1 || m < 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)m * (long long)width;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  vector_gather_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(table, n_rows, idx, n,
                                                 width, out);
  return (int)cudaGetLastError();
}
