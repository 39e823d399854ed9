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
// Two forms, one launch each:
// - over the shard's order (grid_sharding.py:shard_order, kept by a
//   ShardedPoints for a point set evaluated many times): the owned points
//   sorted by base cell, stable, as K2's PointOrder is, and copied into
//   that order. The first blocks evaluate them, a thread a point in cell
//   order (neighbouring threads read neighbouring rows of the slab), and
//   write each output at its point's index; the blocks after them write
//   the zeros of the points the shard does not own (a bit a point in the
//   order's mask), coalesced. No point is written twice.
// - one-shot (no order): a thread a point over all N in the points' order;
//   a point the shard does not own reads its x coordinate and writes its
//   zeros.
// The ordered form of the value takes one lane a point, or four (lanes =
// 4): lane a forms the y and z sums of x tap a and lane 0 adds the four
// in cubic_value_grad_axes' order, so a few owned points (a solve's
// endpoints) spread over four times the warps. The value + gradient
// always takes four, its longer sums over four lanes. The order picks
// the value's (kernels.k7_lanes, from chip_smoke.py --k7-study).
//
// Bound on the H100: bytes, and at a solve's few endpoints launch latency.
// The ordered form reads each owned point (12 B), its index (4 B) and
// each shard's mask (a bit a point) once, and writes every output (4 or
// 16 B) a shard, and the owned points' taps: at most 256 B a point from
// 16 rows; the one-shot form reads every point a shard.
//
// Determinism: no atomics, a fixed summation order per point.
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
__device__ __forceinline__ void store(float* value, float* grad, size_t i,
                                      float m, float gx, float gy,
                                      float gz) {
  value[i] = m;
  if (kGrad) {
    grad[3 * i + 0] = gx;
    grad[3 * i + 1] = gy;
    grad[3 * i + 2] = gz;
  }
}

// The owned point at p, one thread.
__device__ __forceinline__ void eval_point(const TableGrid& g, const float* p,
                                           int x0, float& m, float& gx,
                                           float& gy, float& gz) {
  CubicAxis ax, ay, az;
  cubic_axis(p[0], g.ox, g.sx, g.nx, ax);
  cubic_axis(p[1], g.oy, g.sy, g.ny, ay);
  cubic_axis(p[2], g.oz, g.sz, g.nz, az);
  cubic_value_grad_axes(g, ax, ay, az, kHalo - x0, m, gx, gy, gz);
}

template <class T>
__device__ __forceinline__ T pick(const T (&v)[4], int a) {
  return a == 0 ? v[0] : a == 1 ? v[1] : a == 2 ? v[2] : v[3];
}

// The owned point at p, four lanes (sub = lane & 3 the x tap): each lane
// the y and z sums of its tap as cubic_value_grad_axes forms them, lane 0
// the x sums over the four in its order (shuffles within the quad, whose
// lanes are all active or all not).
__device__ __forceinline__ void eval_point_quad(const TableGrid& g,
                                                const float* p, int x0,
                                                int sub, float& m, float& gx,
                                                float& gy, float& gz) {
  CubicAxis ax, ay, az;
  cubic_axis(p[0], g.ox, g.sx, g.nx, ax);
  cubic_axis(p[1], g.oy, g.sy, g.ny, ay);
  cubic_axis(p[2], g.oz, g.sz, g.nz, az);
  const int ia = pick(ax.i, sub) + kHalo - x0;
  float czy = 0.0f, czy_dy = 0.0f, czy_dz = 0.0f;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const size_t r = (size_t)(ia * g.ny + ay.i[b]);
    const float* row = g.coef + r * (size_t)g.nz;
    float cz = 0.0f, cz_d = 0.0f;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const float c = __ldg(row + az.i[l]);
      cz += c * az.w[l];
      cz_d += c * az.dw[l];
    }
    czy += cz * ay.w[b];
    czy_dy += cz * ay.dw[b];
    czy_dz += cz_d * ay.w[b];
  }
  const int lead = (threadIdx.x & 31) & ~3;
  const unsigned quad = 0xfu << lead;
  float v = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float s = __shfl_sync(quad, czy, lead + a);
    const float s_dy = __shfl_sync(quad, czy_dy, lead + a);
    const float s_dz = __shfl_sync(quad, czy_dz, lead + a);
    v += s * ax.w[a];
    dx += s * ax.dw[a];
    dy += s_dy * ax.w[a];
    dz += s_dz * ax.w[a];
  }
  m = v;
  gx = dx / g.sx;
  gy = dy / g.sy;
  gz = dz / g.sz;
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
  store<kGrad>(value, grad, i, m, gx, gy, gz);
}

// The ordered form: blocks [0, eval_blocks) evaluate the n_own owned
// points (own_points (n_own, 3) in cell order, order (n_own,) their
// indices), kLanes lanes a point; the blocks after them write the zeros
// of the points whose bit in mask ((n + 31) / 32 words) is clear.
template <bool kGrad, int kLanes>
__global__ void __launch_bounds__(CUBIC_SHARDED_THREADS)
    cubic_sharded_ordered_kernel(
        const float* __restrict__ slab, const float* __restrict__ origin,
        const float* __restrict__ spacing, int nx, int ny, int nz, int x0,
        const float* __restrict__ own_points, const int* __restrict__ order,
        int n_own, const unsigned* __restrict__ mask, int n, int eval_blocks,
        float* __restrict__ value, float* __restrict__ grad) {
  if ((int)blockIdx.x >= eval_blocks) {
    const int i = (blockIdx.x - eval_blocks) * blockDim.x + threadIdx.x;
    if (i < n && !((__ldg(mask + (i >> 5)) >> (i & 31)) & 1u))
      store<kGrad>(value, grad, i, 0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const TableGrid g = table_grid(slab, origin, spacing, nx, ny, nz);
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  if (t >= n_own) return;  // with 4 lanes, a whole quad
  const float* p = own_points + 3 * (size_t)t;
  float m, gx, gy, gz;
  if (kLanes == 4) {
    const int sub = threadIdx.x & 3;
    eval_point_quad(g, p, x0, sub, m, gx, gy, gz);
    if (sub != 0) return;
  } else {
    eval_point(g, p, x0, m, gx, gy, gz);
  }
  store<kGrad>(value, grad, __ldg(order + t), m, gx, gy, gz);
}

template <bool kGrad, int kLanes>
int launch(const float* slab, const float* origin, const float* spacing,
           int nx, int ny, int nz, int x0, int loc, const float* points,
           int n, const int* order, int n_own, const unsigned* mask,
           float* value, float* grad, void* stream) {
  if (nx < 2 || ny < 2 || nz < 2 || loc < kHalo || x0 < 0 || x0 + loc > nx ||
      n_own < 0 || n_own > n)
    return (int)cudaErrorInvalidValue;
  const int threads = CUBIC_SHARDED_THREADS;
  if (order == nullptr) {
    cubic_sharded_kernel<kGrad><<<(n + threads - 1) / threads, threads, 0,
                                  (cudaStream_t)stream>>>(
        slab, origin, spacing, nx, ny, nz, x0, loc, points, n, value, grad);
    return (int)cudaGetLastError();
  }
  const long long threads_own = (long long)n_own * kLanes;
  const int eval_blocks = (int)((threads_own + threads - 1) / threads);
  const int blocks = eval_blocks + (n + threads - 1) / threads;
  cubic_sharded_ordered_kernel<kGrad, kLanes>
      <<<blocks, threads, 0, (cudaStream_t)stream>>>(
          slab, origin, spacing, nx, ny, nz, x0, points, order, n_own, mask,
          n, eval_blocks, value, grad);
  return (int)cudaGetLastError();
}

}  // namespace

// value (N,): the shard's tricubic value at the N points, 0 where it does
// not own the point. slab ((loc + 4) * ny, nz): the shard's planes x0 ..
// x0+loc-1 with 2 halo planes on either side; origin, spacing (3,) and
// nx, ny, nz: the GLOBAL grid. One-shot (order null): points (N, 3).
// Over the shard's order: points (n_own, 3) the owned points in the
// order, order (n_own,) their indices, mask ((N + 31) / 32,) a bit an
// owned point, lanes 1 or 4 a point.
extern "C" int ionotomo_cubic_sharded_value(
    const float* slab, const float* origin, const float* spacing, int nx,
    int ny, int nz, int x0, int loc, const float* points, int n,
    const int* order, int n_own, const unsigned* mask, int lanes,
    float* value, void* stream) {
  if (order != nullptr && lanes != 1 && lanes != 4)
    return (int)cudaErrorInvalidValue;
  return (lanes == 4 ? launch<false, 4> : launch<false, 1>)(
      slab, origin, spacing, nx, ny, nz, x0, loc, points, n, order, n_own,
      mask, value, nullptr, stream);
}

// value (N,) and physical gradient (N, 3) [1/km], as above; the ordered
// form four lanes a point.
extern "C" int ionotomo_cubic_sharded_value_grad(
    const float* slab, const float* origin, const float* spacing, int nx,
    int ny, int nz, int x0, int loc, const float* points, int n,
    const int* order, int n_own, const unsigned* mask, float* value,
    float* grad, void* stream) {
  return launch<true, 4>(slab, origin, spacing, nx, ny, nz, x0, loc, points,
                         n, order, n_own, mask, value, grad, stream);
}
