// K7: tricubic value, and value + physical gradient, at N points over one
// x-slab of a field sharded along x, with the slab's halos.
//
// Replaces: the per-shard body of ionotomo_tpu/parallel/grid_sharding.py,
// interp_sharded and interp_sharded_with_grad (:138, :164): _owned_blocks
// (:115-135, the halo-extended slab, the global-to-slab index map, the
// ownership mask and a 64-tap block gather) contracted by
// core/tricubic.py:_contract_value or _contract_value_grad (:130, :139),
// then masked to zero where the shard does not own the point. The psum of
// the shards' outputs stays outside the kernel (parallel/sharding.py:psum,
// in shard order on the mesh's first device).
//
// The slab is (loc + 2*HALO) x-planes of (ny, nz): the shard's own planes
// x0 .. x0+loc-1 with HALO planes of each neighbour on either side
// (grid_sharding._exchange_halos fills them). Each point's stencil is set
// up in the GLOBAL index space (cubic_eval.cuh:cubic_axis, K5's own), so
// the first shard's tap -1 clamps to global plane 0 and the last shard's
// taps clamp to plane nx-1; the wrapped halos (the far edge's planes, in
// the ring exchange) are never read. A shard owns the points whose cell
// base x (the stencil's second tap) lies in [x0, x0 + loc): every point
// has exactly one owner, and its taps x0-1 .. x0+loc+1 lie inside the
// slab. An owned point reads its 64 taps at slab plane gx - x0 + HALO and
// contracts them in cubic_eval.cuh's order (cubic_value_grad_axes), so
// the owner's output is bitwise K5's on the whole table; a point the shard
// does not own gets 0. The shards' outputs summed in any order are then
// bitwise K5's, since exactly one term is not zero.
//
// Bound on the H100: bytes, and at a solve's few endpoints launch latency.
// A shard reads every point (12 B) and writes every output (4 or 16 B),
// owned or not, and the owned points' taps: at most 256 B a point from 16
// scattered rows. One thread a point: a point the shard does not own reads
// its x coordinate, writes its zeros and returns, so the S launches of a
// call cost S reads of the points and one evaluation each.
//
// Determinism: no atomics, a fixed summation order per thread.
#include "cubic_eval.cuh"

#ifndef CUBIC_SHARDED_THREADS
#define CUBIC_SHARDED_THREADS 128
#endif

namespace {

constexpr int kHalo = 2;

// The global x stencil of a point and whether the shard of planes
// [x0, x0 + loc) owns it.
__device__ __forceinline__ bool owned_axis(const TableGrid& g, float px,
                                           int x0, int loc, CubicAxis& ax) {
  cubic_axis(px, g.ox, g.sx, g.nx, ax);
  return ax.i[1] >= x0 && ax.i[1] < x0 + loc;
}

template <bool kGrad>
__global__ void __launch_bounds__(CUBIC_SHARDED_THREADS)
    cubic_sharded_kernel(const float* __restrict__ slab,
                         const float* __restrict__ origin,
                         const float* __restrict__ spacing, int nx, int ny,
                         int nz, int x0, int loc,
                         const float* __restrict__ points, int n,
                         float* __restrict__ value, float* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const TableGrid g = table_grid(slab, origin, spacing, nx, ny, nz);
  CubicAxis ax;
  float m = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
  if (owned_axis(g, points[3 * (size_t)i + 0], x0, loc, ax)) {
    CubicAxis ay, az;
    cubic_axis(points[3 * (size_t)i + 1], g.oy, g.sy, g.ny, ay);
    cubic_axis(points[3 * (size_t)i + 2], g.oz, g.sz, g.nz, az);
    cubic_value_grad_axes(g, ax, ay, az, kHalo - x0, m, gx, gy, gz);
  }
  value[i] = m;
  if (kGrad) {
    grad[3 * (size_t)i + 0] = gx;
    grad[3 * (size_t)i + 1] = gy;
    grad[3 * (size_t)i + 2] = gz;
  }
}

template <bool kGrad>
int launch(const float* slab, const float* origin, const float* spacing,
           int nx, int ny, int nz, int x0, int loc, const float* points,
           int n, float* value, float* grad, void* stream) {
  if (nx < 2 || ny < 2 || nz < 2 || loc < kHalo || x0 < 0 || x0 + loc > nx)
    return (int)cudaErrorInvalidValue;
  const int threads = CUBIC_SHARDED_THREADS;
  const int blocks = (n + threads - 1) / threads;
  cubic_sharded_kernel<kGrad><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      slab, origin, spacing, nx, ny, nz, x0, loc, points, n, value, grad);
  return (int)cudaGetLastError();
}

}  // namespace

// value (N,): the shard's tricubic value at points (N, 3), 0 where it does
// not own the point. slab ((loc + 4) * ny, nz): the shard's planes x0 ..
// x0+loc-1 with 2 halo planes on either side; origin, spacing (3,) and
// nx, ny, nz: the GLOBAL grid.
extern "C" int ionotomo_cubic_sharded_value(const float* slab,
                                            const float* origin,
                                            const float* spacing, int nx,
                                            int ny, int nz, int x0, int loc,
                                            const float* points, int n,
                                            float* value, void* stream) {
  return launch<false>(slab, origin, spacing, nx, ny, nz, x0, loc, points, n,
                       value, nullptr, stream);
}

// value (N,) and physical gradient (N, 3) [1/km], as above.
extern "C" int ionotomo_cubic_sharded_value_grad(
    const float* slab, const float* origin, const float* spacing, int nx,
    int ny, int nz, int x0, int loc, const float* points, int n, float* value,
    float* grad, void* stream) {
  return launch<true>(slab, origin, spacing, nx, ny, nz, x0, loc, points, n,
                      value, grad, stream);
}
