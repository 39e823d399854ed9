// Triquadratic B-spline (the "quadratic" field model): value and physical
// gradient of the interpolated log-density at one point, from the table of
// its prefiltered coefficients.
//
// Shared by K1q (trace_leapfrog_quad.cu, over the z-tap-packed table of
// K1) and K6q (quad_value_grad.cu). It is the per-point body of
// ionotomo_tpu/core/triquadratic.py: _neighborhood -> _qb_weights/
// _qb_dweights -> interp_rows_with_grad (:173-207), contracted z first
// over each of the 9 rows, then over y, then over x, as the reference
// does, and must stay in step with the plain PyTorch version in
// ionotomo_tpu_torch/core/triquadratic.py.
//
// Drift traps this code keeps as the reference has them:
// - the nearest-lattice base on all three axes, rintf (round half to
//   even, like jnp.round/torch.round), never roundf;
// - clamps in order: t to [0, n-1], base to [1, n-2], so the three taps
//   base-1 .. base+1 always lie inside the axis and never share a lane;
//   at the boundary the fraction reaches +-1, so |u| <= 1/2 is not
//   assumed;
// - the weights as triquadratic._qb_weights writes them.
#pragma once

#include <cuda_runtime.h>

#include "table_grid.cuh"

// One axis of a set-up point: the base and the quadratic B-spline weights
// at offsets (-1, 0, 1) with their d/du.
struct QuadAxis {
  int b;
  float w[3];
  float dw[3];
};

static __device__ __forceinline__ void quad_axis(float p, float o, float s,
                                                 int n, QuadAxis& a) {
  float t = (p - o) / s;
  t = fminf(fmaxf(t, 0.0f), (float)(n - 1));
  const float base = fminf(fmaxf(rintf(t), 1.0f), (float)(n - 2));
  const float u = t - base;
  a.b = (int)base;
  a.w[0] = 0.5f * ((0.5f - u) * (0.5f - u));
  a.w[1] = 0.75f - u * u;
  a.w[2] = 0.5f * ((0.5f + u) * (0.5f + u));
  a.dw[0] = u - 0.5f;
  a.dw[1] = -2.0f * u;
  a.dw[2] = u + 0.5f;
}

// The contraction: taps(a, b, c) writes c[0..2], the table at row
// (ax.b + a - 1, ay.b + b - 1) and z taps az.b - 1 .. az.b + 1. Each
// row's z sums from zero, tap by tap; then y, then x, each a running sum
// from zero; the gradient divided by the spacing last.
template <class Taps>
static __device__ __forceinline__ void quad_contract(
    const TableGrid& g, const QuadAxis& ax, const QuadAxis& ay,
    const QuadAxis& az, const Taps& taps, float& val, float& gx, float& gy,
    float& gz) {
  float v = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float czy = 0.0f, czy_dy = 0.0f, czy_dz = 0.0f;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float c[3];
      taps(a, b, c);
      float cz = 0.0f, cz_d = 0.0f;
#pragma unroll
      for (int l = 0; l < 3; ++l) {
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

// Value m and physical gradient dm/dx [1/km] at (px, py, pz): 9 rows x 3
// taps, 27 scalar loads.
static __device__ __forceinline__ void quad_value_grad_at(
    const TableGrid& g, float px, float py, float pz, float& val, float& gx,
    float& gy, float& gz) {
  QuadAxis ax, ay, az;
  quad_axis(px, g.ox, g.sx, g.nx, ax);
  quad_axis(py, g.oy, g.sy, g.ny, ay);
  quad_axis(pz, g.oz, g.sz, g.nz, az);
  quad_contract(
      g, ax, ay, az,
      [&](int a, int b, float c[3]) {
        const float* row =
            g.coef + (size_t)((ax.b + a - 1) * g.ny + ay.b + b - 1) *
                         (size_t)g.nz + (size_t)(az.b - 1);
#pragma unroll
        for (int l = 0; l < 3; ++l) c[l] = __ldg(row + l);
      },
      val, gx, gy, gz);
}

// quad_value_grad_at reading the z-tap-packed table of K1 (pack_zp_taps in
// trace_leapfrog_zp.cu): packed[(b-1) * nx*ny + row] = (T[row, b-1],
// T[row, b], T[row, b+1], 0) for b in [1, nz-2], the very taps of base
// b = az.b (quadratic's z stencil is the zp one). One aligned 16-byte
// load a row; the same weights and contraction, so the same value and
// gradient bit for bit.
static __device__ __forceinline__ void quad_value_grad_packed_at(
    const TableGrid& g, const float4* __restrict__ packed, float px,
    float py, float pz, float& val, float& gx, float& gy, float& gz) {
  QuadAxis ax, ay, az;
  quad_axis(px, g.ox, g.sx, g.nx, ax);
  quad_axis(py, g.oy, g.sy, g.ny, ay);
  quad_axis(pz, g.oz, g.sz, g.nz, az);
  const float4* slab = packed + (size_t)(az.b - 1) * (size_t)(g.nx * g.ny);
  quad_contract(
      g, ax, ay, az,
      [&](int a, int b, float c[3]) {
        const float4 t = __ldg(slab + (ax.b + a - 1) * g.ny + ay.b + b - 1);
        c[0] = t.x;
        c[1] = t.y;
        c[2] = t.z;
      },
      val, gx, gy, gz);
}
