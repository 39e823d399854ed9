// Catmull-Rom tricubic (separable cubic convolution, a = -1/2): value and
// physical gradient of the interpolated log-density at one point.
//
// Shared by K1c (trace_leapfrog_cubic.cu, over the z-tap-packed table),
// K5 (cubic_value_grad.cu), K5^T (cubic_value_grad_bwd.cu) and K7
// (cubic_sharded.cu, over an x-slab with halos). It is the
// per-point body of
// ionotomo_tpu/core/tricubic.py:
// _neighborhood -> _catmull_rom_weights/_dweights -> interp_rows_with_grad,
// contracted z first over each of the 16 pencils, then y, then x, as the
// reference does, and must stay in step with the plain PyTorch version in
// ionotomo_tpu_torch/core/tricubic.py. The table is the field itself
// reshaped to (nx*ny, nz): this model has no prefilter.
//
// Drift traps this code keeps as the reference has them:
// - floorf for the cell base (the zp model rounds to the nearest lattice
//   point; this one does not);
// - clamps in order: t to [0, n-1], base to [0, n-2], the four indices
//   base-1 .. base+2 to [0, n-1]; so the fraction stays in [0, 1] and edge
//   points repeat rows and taps;
// - the weights in the reference's operation order (u2 = u*u, u3 = u2*u).
#pragma once

#include <cuda_runtime.h>

#include "table_grid.cuh"

// One axis of a set-up point: the four clamped indices, the Catmull-Rom
// weights at offsets (-1, 0, 1, 2) and their d/du.
struct CubicAxis {
  int i[4];
  float w[4];
  float dw[4];
};

// tricubic._neighborhood, _catmull_rom_weights and _catmull_rom_dweights on
// one axis.
static __device__ __forceinline__ void cubic_axis(float p, float o, float s,
                                                  int n, CubicAxis& a) {
  float t = (p - o) / s;
  t = fminf(fmaxf(t, 0.0f), (float)(n - 1));
  const float base = fminf(fmaxf(floorf(t), 0.0f), (float)(n - 2));
  const float u = t - base;
  const int b = (int)base;
#pragma unroll
  for (int k = 0; k < 4; ++k) a.i[k] = min(max(b + k - 1, 0), n - 1);
  const float u2 = u * u;
  const float u3 = u2 * u;
  a.w[0] = 0.5f * (-u3 + 2.0f * u2 - u);
  a.w[1] = 0.5f * (3.0f * u3 - 5.0f * u2 + 2.0f);
  a.w[2] = 0.5f * (-3.0f * u3 + 4.0f * u2 + u);
  a.w[3] = 0.5f * (u3 - u2);
  a.dw[0] = 0.5f * (-3.0f * u2 + 4.0f * u - 1.0f);
  a.dw[1] = 0.5f * (9.0f * u2 - 10.0f * u);
  a.dw[2] = 0.5f * (-9.0f * u2 + 8.0f * u + 1.0f);
  a.dw[3] = 0.5f * (3.0f * u2 - 2.0f * u);
}

// Value m and physical gradient dm/dx [1/km] of set-up axes: 16 pencils x
// 4 taps, 64 loads, the pencil of x index i read at table row
// (i + x_shift) * ny + j. x_shift is 0 for a whole table; an x-slab of a
// sharded field (K7, cubic_sharded.cu) passes HALO - x0, so the stencil is
// set up in the global index space and read from the slab. The 16
// z-contracted pencils are folded into the y sums of their x index as they
// are formed, so no more than one pencil row of partial sums is live.
static __device__ __forceinline__ void cubic_value_grad_axes(
    const TableGrid& g, const CubicAxis& ax, const CubicAxis& ay,
    const CubicAxis& az, int x_shift, float& val, float& gx, float& gy,
    float& gz) {
  float v = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float czy = 0.0f, czy_dy = 0.0f, czy_dz = 0.0f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const size_t r = (size_t)((ax.i[a] + x_shift) * g.ny + ay.i[b]);
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
    v += czy * ax.w[a];
    dx += czy * ax.dw[a];
    dy += czy_dy * ax.w[a];
    dz += czy_dz * ax.w[a];
  }
  val = v;
  gx = dx / g.sx;
  gy = dy / g.sy;
  gz = dz / g.sz;
}

// Value m and physical gradient dm/dx [1/km] at (px, py, pz) of the whole
// (nx*ny, nz) table.
static __device__ __forceinline__ void cubic_value_grad_at(
    const TableGrid& g, float px, float py, float pz, float& val, float& gx,
    float& gy, float& gz) {
  CubicAxis ax, ay, az;
  cubic_axis(px, g.ox, g.sx, g.nx, ax);
  cubic_axis(py, g.oy, g.sy, g.ny, ay);
  cubic_axis(pz, g.oz, g.sz, g.nz, az);
  cubic_value_grad_axes(g, ax, ay, az, 0, val, gx, gy, gz);
}

// The packed evaluator's contraction: cubic_value_grad_at's loops and
// operations in the same order, with the four z taps of row (ax.i[a],
// ay.i[b]) given by taps(a, b) as a float4, so the two agree bit for bit
// (held on the card by tests/test_torch_cuda.py and chip_smoke.py).
template <class Taps>
static __device__ __forceinline__ void cubic_contract(
    const TableGrid& g, const CubicAxis& ax, const CubicAxis& ay,
    const CubicAxis& az, const Taps& taps, float& val, float& gx, float& gy,
    float& gz) {
  float v = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float czy = 0.0f, czy_dy = 0.0f, czy_dz = 0.0f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float4 q = taps(a, b);
      const float c[4] = {q.x, q.y, q.z, q.w};
      float cz = 0.0f, cz_d = 0.0f;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        cz += c[l] * az.w[l];
        cz_d += c[l] * az.dw[l];
      }
      czy += cz * ay.w[b];
      czy_dy += cz * ay.dw[b];
      czy_dz += cz_d * ay.w[b];
    }
    v += czy * ax.w[a];
    dx += czy * ax.dw[a];
    dy += czy_dy * ax.w[a];
    dz += czy_dz * ax.w[a];
  }
  val = v;
  gx = dx / g.sx;
  gy = dy / g.sy;
  gz = dz / g.sz;
}

// The z-tap-packed table: packed[base * nx*ny + row] = the four taps
// (row, clamp(base-1)), (row, base), (row, base+1), (row, clamp(base+2))
// for every cell base in [0, nz-2]. The taps of a row are a function of
// (row, base) alone (cubic_axis clamps the base before the taps), so one
// aligned 16-byte load, one sector, fetches what four scalar loads fetch
// from the table. Base-major: rays of a warp at one height read rows of
// one base, neighbours in y side by side.
static __device__ __forceinline__ void cubic_value_grad_packed_at(
    const TableGrid& g, const float4* __restrict__ packed, float px,
    float py, float pz, float& val, float& gx, float& gy, float& gz) {
  CubicAxis ax, ay, az;
  cubic_axis(px, g.ox, g.sx, g.nx, ax);
  cubic_axis(py, g.oy, g.sy, g.ny, ay);
  cubic_axis(pz, g.oz, g.sz, g.nz, az);
  // az.i[1] is the base itself: it lies in [0, nz-2], which the clamp keeps
  const float4* slab = packed + (size_t)az.i[1] * (size_t)(g.nx * g.ny);
  auto taps = [&](int a, int b) {
    return __ldg(slab + ax.i[a] * g.ny + ay.i[b]);
  };
  cubic_contract(g, ax, ay, az, taps, val, gx, gy, gz);
}
