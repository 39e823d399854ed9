// K6q: triquadratic value and physical gradient at N points.
//
// Replaces: ionotomo_tpu/core/triquadratic.py, interp_rows_with_grad
// (:173-207, the 9-row gather contracted z-first against two dense
// quadratic z bands that the JAX package wrote below jnp). It is each rk4
// stage of a quadratic trace (geometry/fermat.py, field_evaluator's
// "quadratic" branch). The reference has no operator on this model.
//
// Bound on the H100: a gather. Each evaluation reads 9 rows x 3 z taps x
// 4 B = 108 B scattered over 9 rows of the (nx*ny, nz) table of
// prefiltered coefficients, against ~190 flops of weights and contraction.
// At 2^20 random points of a 256^3 table (64 MiB, past the 50 MB L2) the 9
// rows cost ~576 B of DRAM sectors a point, near the time the card takes.
// Where the table stays in L2, the L1's requests bind: a warp's load of
// one tap for 32 points touches some 32 lines, so one lane a point with
// scalar taps makes ~27 requests a point.
//
// Design: the evaluator is quad_eval.cuh, shared with the tracers K1q and
// K1r. Three lanes a point, ten points a warp, 128 threads a block: the
// warp's 30 coordinates are one coalesced load, shared by shuffles; lane l
// loads z tap l of the 9 rows, so a row's 3 taps are one request of 3
// neighbouring lanes (~11 requests a point); shuffles hand lane a the taps
// of x plane a, which it contracts (quad_plane), and each of the point's
// lanes sums the planes (quad_add_plane, quad_finish), the pieces of
// quad_contract, so the value and gradient are bitwise K1q's and K1r's
// evaluator; lane a writes
// gradient component a (30 contiguous words a warp), lane 0 the value.
// chip_smoke.py --e-study --parent (an NVIDIA H100 80GB HBM3 at 700 W),
// in turns with the first design (one lane, 32 a block, scalar taps): the
// bench trace's 262,144 points halfway 0.0150 ms against 0.0203, the
// 917,504 edge-case points 0.0622 against 0.0649 and 2^20 random points of
// 256^3 0.2118-0.2138 against 0.2197. Swept and removed: 32, 64 and 256
// threads a block (at most 0.0001 ms faster than 128 at any shape, 0.0184
// at 32 at the halfway points); one lane a point with a row's
// taps by 16-byte loads (0.0584 at the edge-case points and 0.2102-0.2115
// at the random ones, but 0.0171 at the halfway points and 0.0036 at
// 1,240 against 0.0019: no count of points an SM separated the two); a
// lane an x plane (0.0218, 0.0673) and the points through a shared-memory
// tile (0.0222).
//
// Determinism: no atomics and a fixed summation order per point, so the
// output is bitwise identical from run to run.
#include "quad_eval.cuh"

// Study only (chip_smoke.py builds a library with -DK6Q_LAUNCH_FLOOR=1):
// the launch with an empty body.
#ifndef K6Q_LAUNCH_FLOOR
#define K6Q_LAUNCH_FLOOR 0
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kPointsPerWarp = 10;  // three lanes a point, 30 of 32 lanes
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ size_t quad_row_at(const TableGrid& g,
                                              const QuadAxis& ax,
                                              const QuadAxis& ay,
                                              const QuadAxis& az, int a,
                                              int b) {
  return (size_t)((ax.b + a - 1) * g.ny + ay.b + b - 1) * (size_t)g.nz +
         (size_t)(az.b - 1);
}

__device__ __forceinline__ float pick3(int k, float x0, float x1, float x2) {
  return k == 0 ? x0 : k == 1 ? x1 : x2;
}

// Three lanes a point, ten points a warp; lanes 30 and 31 (and the lanes
// past the last point) shadow point 0's lane 0 for the shuffles and write
// nothing. Lane l of a point loads z tap l of its 9 rows, so a row's 3 taps
// lie in 3 neighbouring lanes of one load; two rounds of shuffles hand
// lane a the 9 taps of x plane a, which it contracts (quad_plane); the
// point's three lanes then sum the planes (quad_add_plane, quad_finish).
__global__ void __launch_bounds__(kThreads)
    quad_value_grad_lanes_kernel(const float* __restrict__ coef,
                                 const float* __restrict__ origin,
                                 const float* __restrict__ spacing, int nx,
                                 int ny, int nz,
                                 const float* __restrict__ points, int n,
                                 float* __restrict__ value,
                                 float* __restrict__ grad) {
#if K6Q_LAUNCH_FLOOR
  return;
#endif
  const int lane = threadIdx.x & 31;
  const size_t first =
      (((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * kPointsPerWarp;
  if (first >= (size_t)n) return;  // the whole warp
  const int count = min(kPointsPerWarp, (int)((size_t)n - first));
  const bool idle = lane >= 3 * count;
  const float f = idle ? 0.0f : __ldg(points + 3 * first + lane);
  const int q = idle ? 0 : lane;
  const int pt = q / 3, a = q - 3 * pt, l0 = 3 * pt;
  const float px = __shfl_sync(kFull, f, l0);
  const float py = __shfl_sync(kFull, f, l0 + 1);
  const float pz = __shfl_sync(kFull, f, l0 + 2);
  const TableGrid g = table_grid(coef, origin, spacing, nx, ny, nz);
  QuadAxis ax, ay, az;
  quad_axis(px, g.ox, g.sx, g.nx, ax);
  quad_axis(py, g.oy, g.sy, g.ny, ay);
  quad_axis(pz, g.oz, g.sz, g.nz, az);
  // own[pa][b]: tap a (this lane's) of row (pa, b)
  float own[3][3];
#pragma unroll
  for (int pa = 0; pa < 3; ++pa)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      own[pa][b] = __ldg(g.coef + quad_row_at(g, ax, ay, az, pa, b) + a);
  // t[b][l]: tap l of row (a, b), this lane's plane. In round r lane s
  // sends tap s of plane (s - r) mod 3, so lane a receives tap (a + r)
  // mod 3 of plane a.
  float t[3][3];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const float mine = pick3(a, own[0][b], own[1][b], own[2][b]);
    const float r1 = __shfl_sync(
        kFull, pick3((a + 2) % 3, own[0][b], own[1][b], own[2][b]),
        l0 + (a + 1) % 3);
    const float r2 = __shfl_sync(
        kFull, pick3((a + 1) % 3, own[0][b], own[1][b], own[2][b]),
        l0 + (a + 2) % 3);
    t[b][0] = a == 0 ? mine : a == 1 ? r2 : r1;
    t[b][1] = a == 1 ? mine : a == 2 ? r2 : r1;
    t[b][2] = a == 2 ? mine : a == 0 ? r2 : r1;
  }
  float czy, czy_dy, czy_dz;
  quad_plane(
      ay, az,
      [&](int, int b, float c[3]) {
#pragma unroll
        for (int l = 0; l < 3; ++l) c[l] = t[b][l];
      },
      a, czy, czy_dy, czy_dz);
  float v = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    quad_add_plane(ax, k, __shfl_sync(kFull, czy, l0 + k),
                   __shfl_sync(kFull, czy_dy, l0 + k),
                   __shfl_sync(kFull, czy_dz, l0 + k), v, dx, dy, dz);
  float m, gx, gy, gz;
  quad_finish(g, v, dx, dy, dz, m, gx, gy, gz);
  if (idle) return;
  if (a == 0) value[first + pt] = m;
  grad[3 * first + lane] = a == 0 ? gx : a == 1 ? gy : gz;
}

}  // namespace

extern "C" int ionotomo_quad_value_grad(const float* coef,
                                        const float* origin,
                                        const float* spacing, int nx, int ny,
                                        int nz, const float* points, int n,
                                        float* value, float* grad,
                                        void* stream) {
  if (nx < 3 || ny < 3 || nz < 3 || n < 1) return (int)cudaErrorInvalidValue;
  const long long all = 32LL * ((n + kPointsPerWarp - 1) / kPointsPerWarp);
  quad_value_grad_lanes_kernel<<<(unsigned)((all + kThreads - 1) / kThreads),
                                 kThreads, 0, (cudaStream_t)stream>>>(
      coef, origin, spacing, nx, ny, nz, points, n, value, grad);
  return (int)cudaGetLastError();
}
