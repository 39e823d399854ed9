// K1: the bent-ray Fermat tracer, leapfrog (velocity Verlet) over the zp
// field model, with the Hermite TEC quadrature, all n_steps in one launch,
// and the z-tap pack of the table it reads.
//
// Replaces: ionotomo_tpu/geometry/fermat.py, _trace_impl's leapfrog branch
// fused with _rhs and the zp evaluator (core/boxspline.py,
// interp_rows_with_grad) that trace_rays(method="leapfrog", interp="zp")
// runs under lax.scan.
//
// K1r on zp (ionotomo_trace_rk4_zp): the rk4 branch of _trace_impl
// (:182-202) on the same evaluators, packs, ray order and call as K1
// (trace_rays(method="rk4", interp="zp")), four evaluations a step
// in one launch where the reference's rk4 scan makes four gathers a step.
//
// Bound on the H100: the field gather. Each step evaluates the field once:
// 7 live rows x 3 z-taps x 4 B = 84 B read from 7 scattered rows of the
// (nx*ny, nz) table, plus ~470 flops (weights, exp, sqrt, two divisions,
// the kick-drift-kick update). Successive steps of one ray depend on each
// other, so only other rays in flight hide a step's loads. Read as 21
// scalar loads a step, the taps cost 21 load instructions and 7-14 L2
// sectors per ray, and the rays of a warp fan out after a few steps, so
// they share no row.
//
// Design, K1c's two levers (trace_leapfrog_cubic.cu) carried over:
// - the z-tap-packed table (zp_eval.cuh, zp_value_grad_packed_at): a pack
//   kernel, launched by the wrapper just before the tracer, writes the 3
//   taps of every (row, z base) as one aligned float4 with a zero pad,
//   base-major ((nz-2) x nx*ny float4s, 33 MB at 128^3, inside the L2); a
//   step then makes 7 one-sector loads;
// - a ray order (kernels.ray_order, whose keys trace_leapfrog_cubic.cu
//   makes): the caller sorts the rays by direction, then origin, so that
//   a warp holds parallel rays from neighbouring origins, which reach the
//   same z base at the same step and share rows and sectors in L1. Each
//   thread writes its ray's outputs at the ray's own index;
// - the wrapper (kernels.trace_leapfrog_zp) sorts and packs from
//   kernels.TRACE_ZP_RAYS_PER_SM rays an SM, where the two pay for
//   themselves (chip_smoke.py --k1-study); a smaller batch reads the
//   table as it is, in ray order, 32 rays a block, so that it spreads
//   over more SMs;
// - one thread per ray, the integrator of trace_leapfrog.cuh (shared with
//   K1c) over the evaluator of zp_eval.cuh (shared with K1e). The weights,
//   the contraction order and the integrator are those of the unpacked
//   evaluator, so every ray's output is bitwise what the unpacked kernel
//   gives in ray order.
//
// Determinism: no atomics and a fixed order of operations per thread, so
// the output is bitwise identical from run to run.
#include "trace_leapfrog.cuh"
#include "zp_eval.cuh"

// Types of this file alone (global scope: a __global__ template takes them).
struct ZpValueGrad {
  __device__ __forceinline__ void operator()(const TableGrid& g, float x,
                                             float y, float z, float& m,
                                             float& gx, float& gy,
                                             float& gz) const {
    zp_value_grad_at(g, x, y, z, m, gx, gy, gz);
  }
};

struct ZpValueGradPacked {
  const float4* __restrict__ packed;
  __device__ __forceinline__ void operator()(const TableGrid& g, float x,
                                             float y, float z, float& m,
                                             float& gx, float& gy,
                                             float& gz) const {
    zp_value_grad_packed_at(g, packed, x, y, z, m, gx, gy, gz);
  }
};

namespace {

constexpr int kPackRows = 32;   // rows of a pack tile: one per lane
constexpr int kPackBases = 32;  // z bases of a pack tile

// packed[(b-1) * n_rows + row] = (T[row, b-1], T[row, b], T[row, b+1], 0)
// for b in [1, nz-2]. A block stages the taps of 32 rows x 32 bases in
// shared memory (read along z, coalesced), then each warp writes 32 rows of
// one base (512 contiguous bytes).
__global__ void pack_zp_taps_kernel(const float* __restrict__ table,
                                    int n_rows, int nz,
                                    float4* __restrict__ packed) {
  // 35 slots a row (34 used): an odd stride, so the lanes' reads hit
  // distinct banks
  __shared__ float tile[kPackRows][kPackBases + 3];
  const int r0 = blockIdx.x * kPackRows, j0 = blockIdx.y * kPackBases;
  for (int i = threadIdx.x; i < kPackRows * (kPackBases + 2);
       i += blockDim.x) {
    const int r = i / (kPackBases + 2), k = i % (kPackBases + 2);
    const int z = min(j0 + k, nz - 1);
    tile[r][k] = r0 + r < n_rows ? __ldg(table + (size_t)(r0 + r) * nz + z)
                                 : 0.0f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, row = r0 + lane;
  for (int j = threadIdx.x >> 5; j < kPackBases; j += blockDim.x >> 5) {
    const int b1 = j0 + j;  // base b - 1
    if (b1 <= nz - 3 && row < n_rows)
      packed[(size_t)b1 * n_rows + row] = make_float4(
          tile[lane][j], tile[lane][j + 1], tile[lane][j + 2], 0.0f);
  }
}

}  // namespace

// The packed table of a (n_rows, nz) table into packed ((nz-2) * n_rows
// float4s, 16-byte aligned).
extern "C" int ionotomo_pack_zp_taps(const float* table, int n_rows, int nz,
                                     float* packed, void* stream) {
  if (n_rows < 1 || nz < 3) return (int)cudaErrorInvalidValue;
  const dim3 blocks((n_rows + kPackRows - 1) / kPackRows,
                    (nz - 2 + kPackBases - 1) / kPackBases);
  pack_zp_taps_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      table, n_rows, nz, reinterpret_cast<float4*>(packed));
  return (int)cudaGetLastError();
}

// packed: the packed table of `coef` (ionotomo_pack_zp_taps), which the
// tracer reads in its place; null: the tracer reads the table with the
// unpacked evaluator. order: (n_rays,) ray of each thread, or null.
// threads: the block size (launch_trace_ordered). path may be null
// (keep_path=False).
extern "C" int ionotomo_trace_leapfrog_zp(
    const float* coef, const float* packed, const float* origin,
    const float* spacing, int nx, int ny, int nz, const float* origins,
    const float* directions, const int* order, int n_rays, int n_steps,
    float h, float hh12, float w_n, float w_rhs, float k_ne, float tec_unit,
    int threads, float* x_end, float* tau, float* path, void* stream) {
  if (nx < 3 || ny < 3 || nz < 3) return (int)cudaErrorInvalidValue;
  return trace_log_density<false, 0, ZpValueGrad,
                           ZpValueGradPacked>(
      coef, packed, origin, spacing, nx, ny, nz, origins, directions,
      order, n_rays, n_steps, h, hh12, w_n, w_rhs, k_ne, tec_unit, threads,
      x_end, tau, path, stream);
}

// K1r on this model: the rk4 integrator (trace_leapfrog.cuh, trace_rk4_ray)
// over the same evaluators in its own launch, 256 rays a block at a sorted
// batch (kernels.TRACE_RK4_THREADS) with a register budget of 2 blocks of 256
// an SM (128 registers, as at a budget of 1; 3 and 4 spill and are slower:
// chip_smoke.py --rk4-study). Arguments as above.
extern "C" int ionotomo_trace_rk4_zp(
    const float* coef, const float* packed, const float* origin,
    const float* spacing, int nx, int ny, int nz, const float* origins,
    const float* directions, const int* order, int n_rays, int n_steps,
    float h, float hh12, float w_n, float w_rhs, float k_ne, float tec_unit,
    int threads, float* x_end, float* tau, float* path, void* stream) {
  if (nx < 3 || ny < 3 || nz < 3) return (int)cudaErrorInvalidValue;
  return trace_log_density<true, K1R_BUDGET(2), ZpValueGrad,
                           ZpValueGradPacked>(
      coef, packed, origin, spacing, nx, ny, nz, origins, directions,
      order, n_rays, n_steps, h, hh12, w_n, w_rhs, k_ne, tec_unit, threads,
      x_end, tau, path, stream);
}
