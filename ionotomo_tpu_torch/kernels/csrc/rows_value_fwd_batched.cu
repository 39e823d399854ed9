// K2b: forward of the row-gather value map with a leading member axis,
//   out[b, n] = sum_k wxy[n,k] * sum_l wz[n,l] * table[b, ri[n,k], zi[n,l]],
// and the member-innermost pack that K2b and K3b (rows_value_bwd_batched.cu)
// read their member axis from.
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
// Design. Member-major tables put a tap's 8 member values 8 MiB apart: 8
// sectors, and 64 MiB of tables past the 50 MB L2. So the call first packs
// the tables member-innermost (pack_members: (ceil(B/8), R*nz, 8), zeros
// past the last member), where one (row, z) tap of 8 members is one
// aligned 32-byte sector, two float4 loads. Then one thread per point
// loads its row indices and weights once and, for each group of 8
// members, each tap's 8 values at once, summing every member in the
// order K2 (rows_value_fwd.cu) sums for the given xy_first, so member b
// of the result is bitwise K2 of table[b] (the zp model's zero-weight 8th
// row is read and added, as K2 does). Indices are clamped into the table.
// No atomics: bitwise identical from run to run.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kGroup = 8;  // members a packed tap holds
constexpr int kThreads = 256;

// Blocks an SM the gather's register budget is set for; 1 is the
// compiler's own choice (chip_smoke.py --member-study).
#ifndef K2B_MIN_BLOCKS
#define K2B_MIN_BLOCKS 1
#endif

__device__ __forceinline__ void load_tap(const float* p, float (&v)[kGroup]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

// KMax: K rounded up to 8 or 16, so the zp model's 8 rows keep 8 row
// indices and weights in registers, not 16.
template <int L, int KMax, bool kXyFirst>
__global__ void __launch_bounds__(kThreads, K2B_MIN_BLOCKS)
    rows_value_fwd_batched_kernel(
    const float* __restrict__ packed, int n_members, int n_rows, int nz,
    const int* __restrict__ ri, const float* __restrict__ wxy, int K,
    const int* __restrict__ zi, const float* __restrict__ wz, int n,
    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int z[L];
  float w[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    z[l] = min(max(zi[(size_t)i * L + l], 0), nz - 1);
    w[l] = wz[(size_t)i * L + l];
  }
  int r[KMax];
  float wk[KMax];
#pragma unroll
  for (int k = 0; k < KMax; ++k) {
    if (k < K) {
      r[k] = min(max(ri[(size_t)i * K + k], 0), n_rows - 1);
      wk[k] = wxy[(size_t)i * K + k];
    } else {
      r[k] = 0;
      wk[k] = 0.0f;
    }
  }
  const size_t group_stride = (size_t)n_rows * (size_t)nz * kGroup;
  for (int b0 = 0; b0 < n_members; b0 += kGroup) {
    const float* tg = packed + (size_t)(b0 / kGroup) * group_stride;
    float acc[kGroup];
    if (kXyFirst) {
      float s[L][kGroup];
#pragma unroll
      for (int l = 0; l < L; ++l)
#pragma unroll
        for (int m = 0; m < kGroup; ++m) s[l][m] = 0.0f;
#pragma unroll
      for (int k = 0; k < KMax; ++k) {
        if (k < K) {
          const float* row = tg + (size_t)r[k] * (size_t)nz * kGroup;
#pragma unroll
          for (int l = 0; l < L; ++l) {
            float v[kGroup];
            load_tap(row + (size_t)z[l] * kGroup, v);
#pragma unroll
            for (int m = 0; m < kGroup; ++m) s[l][m] += wk[k] * v[m];
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kGroup; ++m) {
        acc[m] = 0.0f;
#pragma unroll
        for (int l = 0; l < L; ++l) acc[m] += w[l] * s[l][m];
      }
    } else {
#pragma unroll
      for (int m = 0; m < kGroup; ++m) acc[m] = 0.0f;
#pragma unroll
      for (int k = 0; k < KMax; ++k) {
        if (k < K) {
          const float* row = tg + (size_t)r[k] * (size_t)nz * kGroup;
          float pencil[kGroup];
#pragma unroll
          for (int m = 0; m < kGroup; ++m) pencil[m] = 0.0f;
#pragma unroll
          for (int l = 0; l < L; ++l) {
            float v[kGroup];
            load_tap(row + (size_t)z[l] * kGroup, v);
#pragma unroll
            for (int m = 0; m < kGroup; ++m) pencil[m] += w[l] * v[m];
          }
#pragma unroll
          for (int m = 0; m < kGroup; ++m) acc[m] += pencil[m] * wk[k];
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kGroup; ++m)
      if (b0 + m < n_members) out[(size_t)(b0 + m) * (size_t)n + i] = acc[m];
  }
}

template <int L, int KMax>
void launch_fwd(const float* packed, int n_members, int n_rows, int nz,
                const int* ri, const float* wxy, int K, const int* zi,
                const float* wz, int n, bool xy_first, float* out,
                cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  if (xy_first)
    rows_value_fwd_batched_kernel<L, KMax, true>
        <<<blocks, kThreads, 0, stream>>>(packed, n_members, n_rows, nz, ri,
                                          wxy, K, zi, wz, n, out);
  else
    rows_value_fwd_batched_kernel<L, KMax, false>
        <<<blocks, kThreads, 0, stream>>>(packed, n_members, n_rows, nz, ri,
                                          wxy, K, zi, wz, n, out);
}

template <int L>
void launch_fwd(const float* packed, int n_members, int n_rows, int nz,
                const int* ri, const float* wxy, int K, const int* zi,
                const float* wz, int n, bool xy_first, float* out,
                cudaStream_t stream) {
  if (K <= 8)
    launch_fwd<L, 8>(packed, n_members, n_rows, nz, ri, wxy, K, zi, wz, n,
                     xy_first, out, stream);
  else
    launch_fwd<L, kMaxK>(packed, n_members, n_rows, nz, ri, wxy, K, zi, wz,
                         n, xy_first, out, stream);
}

// One thread per (group, element): the group's 8 member values of one
// element, read coalesced member by member, written as two float4.
__global__ void pack_members_kernel(const float* __restrict__ x,
                                    int n_members, size_t count,
                                    float* __restrict__ packed) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t groups = (size_t)(n_members + kGroup - 1) / kGroup;
  if (t >= groups * count) return;
  const size_t g = t / count, j = t - g * count;
  float v[kGroup];
#pragma unroll
  for (int m = 0; m < kGroup; ++m) {
    const size_t b = g * kGroup + m;
    v[m] = b < (size_t)n_members ? __ldg(x + b * count + j) : 0.0f;
  }
  float4* o = reinterpret_cast<float4*>(packed + t * kGroup);
  o[0] = make_float4(v[0], v[1], v[2], v[3]);
  o[1] = make_float4(v[4], v[5], v[6], v[7]);
}

}  // namespace

// packed (ceil(B/8), n_rows, nz, 8): the tables member-innermost
// (ionotomo_pack_members of table (B, n_rows*nz)); ri, wxy (N, K); zi, wz
// (N, L); out (B, N).
extern "C" int ionotomo_rows_value_fwd_batched(
    const float* packed, int n_members, int n_rows, int nz, const int* ri,
    const float* wxy, int K, const int* zi, const float* wz, int L, int n,
    int xy_first, float* out, void* stream) {
  if (n_members < 1 || K < 1 || K > kMaxK || L < 1 || L > 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (L) {
    case 1:
      launch_fwd<1>(packed, n_members, n_rows, nz, ri, wxy, K, zi, wz, n,
                    xy_first, out, s);
      break;
    case 2:
      launch_fwd<2>(packed, n_members, n_rows, nz, ri, wxy, K, zi, wz, n,
                    xy_first, out, s);
      break;
    case 3:
      launch_fwd<3>(packed, n_members, n_rows, nz, ri, wxy, K, zi, wz, n,
                    xy_first, out, s);
      break;
    default:
      launch_fwd<4>(packed, n_members, n_rows, nz, ri, wxy, K, zi, wz, n,
                    xy_first, out, s);
  }
  return (int)cudaGetLastError();
}

// x (B, count) member-major -> packed (ceil(B/8), count, 8), zeros past
// member B-1.
extern "C" int ionotomo_pack_members(const float* x, int n_members,
                                     long long count, float* packed,
                                     void* stream) {
  if (n_members < 1 || count < 1) return (int)cudaErrorInvalidValue;
  const size_t total =
      (size_t)((n_members + kGroup - 1) / kGroup) * (size_t)count;
  const int threads = 256;
  pack_members_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                        0, (cudaStream_t)stream>>>(x, n_members,
                                                   (size_t)count, packed);
  return (int)cudaGetLastError();
}
