// K1c: the bent-ray Fermat tracer, leapfrog (velocity Verlet) over the
// Catmull-Rom tricubic field model, with the Hermite TEC quadrature, all
// n_steps in one launch.
//
// Replaces: ionotomo_tpu/geometry/fermat.py, _trace_impl's leapfrog branch
// (:204-227) fused with _rhs (:61) and the tricubic evaluator
// (core/tricubic.py:529, interp_rows_with_grad; the interp == "cubic"
// branch of field_evaluator, :110-112) that trace_rays(method="leapfrog")
// runs under lax.scan with the package's default field model. The table is
// the log-density field itself: the cubic model has no prefilter.
//
// K1r on cubic (ionotomo_trace_rk4_cubic): the rk4 branch of _trace_impl
// (:182-202) on the same evaluators, packs, ray order and call as K1c
// (trace_rays(method="rk4", interp="cubic")), four evaluations a step
// in one launch where the reference's rk4 scan makes four gathers a step.
//
// Bound on the H100: the field gather. Each step evaluates the field once
// at 16 rows x 4 z taps, plus ~840 flops (~520 of weights and contraction,
// then exp, sqrt, the divisions and the kick-drift-kick update).
// Successive steps of one ray depend on each other, so only other rays in
// flight hide a step's loads. Read from the (nx*ny, nz) table as 64 scalar
// loads a step, the taps cost 64 load instructions and 16-32 L2 sectors
// per ray, and a warp of one antenna's 32 directions fans out after a few
// steps, so its lanes share no row: the L1 and L2 sector traffic, not the
// arithmetic, bounded the first version of this kernel.
//
// Design:
// - the z-tap-packed table (cubic_eval.cuh): a pack kernel, launched by
//   the wrapper just before the tracer, writes the four taps of every (row, cell
//   base) as one aligned float4, base-major ((nz-1) x nx*ny float4s, 32 MiB
//   at 128^3, inside the L2); a step then makes 16 one-sector loads;
// - a ray order (ionotomo_tpu_torch/kernels/__init__.py, ray_order): when
//   the batch fills the card, the caller sorts the rays once per call
//   (keys from ray_order_keys_kernel below) so that a warp holds rays of
//   one direction from neighbouring origins; parallel rays stay neighbours
//   at every height, reach the same cell base at the same step and share
//   rows and sectors in L1. Each thread writes its ray's outputs at the
//   ray's own index. A smaller batch is traced in its own order, 64 rays a
//   block, so that it spreads over more SMs;
// - one thread per ray, the integrator of trace_leapfrog.cuh (shared with
//   the zp tracer K1) over the evaluator of cubic_eval.cuh (shared with K5
//   and K5^T). The weights, the contraction order and the integrator are
//   those of the unpacked evaluator, so every ray's output is bitwise what
//   the unpacked kernel gives, in any order.
//
// Determinism: no atomics and a fixed order of operations per thread, so
// the output is bitwise identical from run to run.
#include "cubic_eval.cuh"
#include "trace_leapfrog.cuh"

// Types of this file alone (global scope: a __global__ template takes them).
struct CubicValueGrad {
  __device__ __forceinline__ void operator()(const TableGrid& g, float x,
                                             float y, float z, float& m,
                                             float& gx, float& gy,
                                             float& gz) const {
    cubic_value_grad_at(g, x, y, z, m, gx, gy, gz);
  }
};

struct CubicValueGradPacked {
  const float4* __restrict__ packed;
  __device__ __forceinline__ void operator()(const TableGrid& g, float x,
                                             float y, float z, float& m,
                                             float& gx, float& gy,
                                             float& gz) const {
    cubic_value_grad_packed_at(g, packed, x, y, z, m, gx, gy, gz);
  }
};

namespace {

constexpr int kPackRows = 32;   // rows of a pack tile: one per lane
constexpr int kPackBases = 32;  // cell bases of a pack tile

// packed[b * n_rows + row] = (T[row, clamp(b-1)], T[row, b], T[row, b+1],
// T[row, clamp(b+2)]) for b in [0, nz-2]. A block stages the taps of 32
// rows x 32 bases in shared memory (read along z, coalesced), then each
// warp writes 32 rows of one base (512 contiguous bytes).
__global__ void pack_z_taps_kernel(const float* __restrict__ table,
                                   int n_rows, int nz,
                                   float4* __restrict__ packed) {
  // 35 taps a row: an odd stride, so the lanes' reads hit distinct banks
  __shared__ float tile[kPackRows][kPackBases + 3];
  const int r0 = blockIdx.x * kPackRows, b0 = blockIdx.y * kPackBases;
  for (int i = threadIdx.x; i < kPackRows * (kPackBases + 3);
       i += blockDim.x) {
    const int r = i / (kPackBases + 3), k = i % (kPackBases + 3);
    const int z = min(max(b0 - 1 + k, 0), nz - 1);
    tile[r][k] = r0 + r < n_rows ? __ldg(table + (size_t)(r0 + r) * nz + z)
                                 : 0.0f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, row = r0 + lane;
  for (int j = threadIdx.x >> 5; j < kPackBases; j += blockDim.x >> 5) {
    const int b = b0 + j;
    if (b <= nz - 2 && row < n_rows)
      packed[(size_t)b * n_rows + row] =
          make_float4(tile[lane][j], tile[lane][j + 1], tile[lane][j + 2],
                      tile[lane][j + 3]);
  }
}

}  // namespace

// The packed table of a (n_rows, nz) table into packed ((nz-1) * n_rows
// float4s, 16-byte aligned).
extern "C" int ionotomo_pack_z_taps(const float* table, int n_rows, int nz,
                                    float* packed, void* stream) {
  if (n_rows < 1 || nz < 2) return (int)cudaErrorInvalidValue;
  const dim3 blocks((n_rows + kPackRows - 1) / kPackRows,
                    (nz - 1 + kPackBases - 1) / kPackBases);
  pack_z_taps_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      table, n_rows, nz, reinterpret_cast<float4*>(packed));
  return (int)cudaGetLastError();
}

namespace {

// The sort key of each ray for ray_order (kernels/__init__.py): the
// Z-order code of its direction's (x, y) in 256 steps over [-1, 1] above
// that of its origin's (x, y) in 256 steps over the grid's extent, as an
// int32 whose signed order is the code's order.
__device__ __forceinline__ unsigned spread8(unsigned v) {
  v = (v | (v << 4)) & 0x0F0Fu;
  v = (v | (v << 2)) & 0x3333u;
  return (v | (v << 1)) & 0x5555u;
}

__device__ __forceinline__ unsigned quantize8(float v) {
  return (unsigned)fminf(fmaxf(v * 256.0f, 0.0f), 255.0f);
}

__global__ void ray_order_keys_kernel(const float* __restrict__ origins,
                                      const float* __restrict__ directions,
                                      const float* __restrict__ origin,
                                      const float* __restrict__ spacing,
                                      int nx, int ny, int n,
                                      int* __restrict__ keys) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const unsigned dx = quantize8(0.5f * (directions[3 * r] + 1.0f));
  const unsigned dy = quantize8(0.5f * (directions[3 * r + 1] + 1.0f));
  const unsigned ox = quantize8((origins[3 * r] - origin[0]) /
                                (spacing[0] * (float)(nx - 1)));
  const unsigned oy = quantize8((origins[3 * r + 1] - origin[1]) /
                                (spacing[1] * (float)(ny - 1)));
  const unsigned key = ((spread8(dx) | (spread8(dy) << 1)) << 16) |
                       spread8(ox) | (spread8(oy) << 1);
  keys[r] = (int)(key ^ 0x80000000u);
}

}  // namespace

extern "C" int ionotomo_ray_order_keys(const float* origins,
                                       const float* directions,
                                       const float* origin,
                                       const float* spacing, int nx, int ny,
                                       int n, int* keys, void* stream) {
  if (n < 1 || nx < 2 || ny < 2) return (int)cudaErrorInvalidValue;
  ray_order_keys_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      origins, directions, origin, spacing, nx, ny, n, keys);
  return (int)cudaGetLastError();
}

// packed: the packed table of `table` (ionotomo_pack_z_taps), which the
// tracer reads in its place; null: the tracer reads the table with the
// unpacked evaluator. order: (n_rays,) ray of each thread, or null.
// threads: the block size (launch_trace_ordered). path may be null
// (keep_path=False).
extern "C" int ionotomo_trace_leapfrog_cubic(
    const float* table, const float* packed, const float* origin,
    const float* spacing, int nx, int ny, int nz, const float* origins,
    const float* directions, const int* order, int n_rays, int n_steps,
    float h, float hh12, float w_n, float w_rhs, float k_ne, float tec_unit,
    int threads, float* x_end, float* tau, float* path, void* stream) {
  if (nx < 2 || ny < 2 || nz < 2) return (int)cudaErrorInvalidValue;
  return trace_log_density<false, 0, CubicValueGrad,
                           CubicValueGradPacked>(
      table, packed, origin, spacing, nx, ny, nz, origins, directions,
      order, n_rays, n_steps, h, hh12, w_n, w_rhs, k_ne, tec_unit, threads,
      x_end, tau, path, stream);
}

// K1r on this model: the rk4 integrator (trace_leapfrog.cuh, trace_rk4_ray)
// over the same evaluators in its own launch, 256 rays a block at a sorted
// batch (kernels.TRACE_RK4_THREADS) with a register budget of 3 blocks of 256
// an SM (85 registers; 4 bytes spilled): of the budgets 1-4 the fastest on this
// model (chip_smoke.py --rk4-study). Arguments as above.
extern "C" int ionotomo_trace_rk4_cubic(
    const float* table, const float* packed, const float* origin,
    const float* spacing, int nx, int ny, int nz, const float* origins,
    const float* directions, const int* order, int n_rays, int n_steps,
    float h, float hh12, float w_n, float w_rhs, float k_ne, float tec_unit,
    int threads, float* x_end, float* tau, float* path, void* stream) {
  if (nx < 2 || ny < 2 || nz < 2) return (int)cudaErrorInvalidValue;
  return trace_log_density<true, K1R_BUDGET(3), CubicValueGrad,
                           CubicValueGradPacked>(
      table, packed, origin, spacing, nx, ny, nz, origins, directions,
      order, n_rays, n_steps, h, hh12, w_n, w_rhs, k_ne, tec_unit, threads,
      x_end, tau, path, stream);
}
