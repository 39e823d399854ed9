// Zwart-Powell box spline (x, y) x quadratic B-spline (z): value and
// physical gradient of the interpolated log-density at one point.
//
// Shared by K1 (trace_leapfrog_zp.cu), K1e and its member-axis form
// (zp_value_grad.cu) and K1e^T (zp_value_grad_bwd.cu). It is the
// per-point body of ionotomo_tpu/core/boxspline.py:
// _neighborhood -> _xy_weights -> _row_index -> interp_rows_with_grad,
// contracted xy-first as the reference does, and must stay in step with
// the plain PyTorch version in ionotomo_tpu_torch/core/boxspline.py.
//
// Drift traps this code keeps as the reference has them:
// - rintf (round half to even, like jnp.round/torch.round), never roundf;
// - clamps in order: t to [0, n-1], base to [1, n-2], rows to [0, n-1];
//   at the boundary the fraction reaches +-1, so |u| <= 1/2 is not assumed;
// - the piece is chosen by strict "> 0" tests on u+v and u-v;
// - the 8th translate of the canonical piece has weight 0 and is skipped.
#pragma once

#include <cuda_runtime.h>

#include "table_grid.cuh"

// Canonical piece 3 (u+v > 0, u-v > 0) of boxspline._ZP_CW, as the
// reference's _CW3 (6 monomials x 8 translates), _CU3 and _CV3 (d/du and
// d/dv over the monomials 1, u, v), _DX3 and _DY3. Exact rationals /16.
// tests/test_torch_slice.py checks these against the port's numpy tables.
static __constant__ float kZpCW3[6][8] = {
    {0.125f, 0.125f, 0.5f, 0.125f, 0.0f, 0.125f, 0.0f, 0.0f},
    {-0.5f, 0.0f, 0.0f, 0.0f, 0.0f, 0.5f, 0.0f, 0.0f},
    {0.0f, -0.5f, 0.0f, 0.5f, 0.0f, 0.0f, 0.0f, 0.0f},
    {0.5f, -0.25f, -0.5f, -0.25f, 0.25f, 0.0f, 0.25f, 0.0f},
    {0.0f, 0.5f, 0.0f, -0.5f, -0.5f, 0.0f, 0.5f, 0.0f},
    {0.0f, 0.25f, -0.5f, 0.25f, 0.25f, -0.5f, 0.25f, 0.0f},
};
static __constant__ float kZpCU3[3][8] = {
    {-0.5f, 0.0f, 0.0f, 0.0f, 0.0f, 0.5f, 0.0f, 0.0f},
    {1.0f, -0.5f, -1.0f, -0.5f, 0.5f, 0.0f, 0.5f, 0.0f},
    {0.0f, 0.5f, 0.0f, -0.5f, -0.5f, 0.0f, 0.5f, 0.0f},
};
static __constant__ float kZpCV3[3][8] = {
    {0.0f, -0.5f, 0.0f, 0.5f, 0.0f, 0.0f, 0.0f, 0.0f},
    {0.0f, 0.5f, 0.0f, -0.5f, -0.5f, 0.0f, 0.5f, 0.0f},
    {0.0f, 0.5f, -1.0f, 0.5f, 0.5f, -1.0f, 0.5f, 0.0f},
};
static __constant__ float kZpDX3[8] = {-1.f, 0.f, 0.f, 0.f, 1.f, 1.f, 1.f, 0.f};
static __constant__ float kZpDY3[8] = {0.f, -1.f, 0.f, 1.f, -1.f, 0.f, 1.f, 0.f};

// boxspline._neighborhood on one axis: clamped nearest-lattice base and
// signed offset.
static __device__ __forceinline__ void zp_axis(float p, float o, float s,
                                               int n, int& b, float& frac) {
  float t = (p - o) / s;
  t = fminf(fmaxf(t, 0.0f), (float)(n - 1));
  float base = fminf(fmaxf(rintf(t), 1.0f), (float)(n - 2));
  frac = t - base;
  b = (int)base;
}

// The per-point part of a zp evaluation: lattice base, the map T onto the
// canonical piece, the canonical monomials and the quadratic z taps.
struct ZpPoint {
  int bx, by, bz;
  float a11, a12, a21;
  float mon[6];  // 1, uc, vc, uc^2, uc*vc, vc^2
  float wz[3];   // quadratic B-spline z taps at bz-1, bz, bz+1
  float dwz[3];  // their d/dw
};

static __device__ __forceinline__ void zp_setup(const TableGrid& g, float px,
                                                float py, float pz,
                                                ZpPoint& q) {
  float u, v, w;
  zp_axis(px, g.ox, g.sx, g.nx, q.bx, u);
  zp_axis(py, g.oy, g.sy, g.ny, q.by, v);
  zp_axis(pz, g.oz, g.sz, g.nz, q.bz, w);

  // _xy_weights: map (u, v) onto the canonical piece by T = [[a11, a12],
  // [a21, a11]] with entries in {-1, 0, 1}.
  const float s1 = (u + v > 0.0f) ? 1.0f : 0.0f;
  const float s2 = (u - v > 0.0f) ? 1.0f : 0.0f;
  const float ne = fabsf(s1 - s2);
  const float sg = 2.0f * s1 - 1.0f;
  q.a11 = (1.0f - ne) * sg;
  q.a12 = ne * sg;
  q.a21 = -q.a12;
  const float uc = q.a11 * u + q.a12 * v;
  const float vc = q.a21 * u + q.a11 * v;
  q.mon[0] = 1.0f;
  q.mon[1] = uc;
  q.mon[2] = vc;
  q.mon[3] = uc * uc;
  q.mon[4] = uc * vc;
  q.mon[5] = vc * vc;
  q.wz[0] = 0.5f * ((0.5f - w) * (0.5f - w));
  q.wz[1] = 0.75f - w * w;
  q.wz[2] = 0.5f * ((0.5f + w) * (0.5f + w));
  q.dwz[0] = w - 0.5f;
  q.dwz[1] = -2.0f * w;
  q.dwz[2] = w + 0.5f;
}

// Translate k (0..6; 7 is the zero-weight pad) of a set-up point: its
// table row and its weight, d/du weight and d/dv weight.
static __device__ __forceinline__ void zp_translate(const TableGrid& g,
                                                    const ZpPoint& q, int k,
                                                    int& row, float& wk,
                                                    float& wu, float& wv) {
  wk = 0.0f;
#pragma unroll
  for (int c = 0; c < 6; ++c) wk += q.mon[c] * kZpCW3[c][k];
  float wuc = 0.0f, wvc = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    wuc += q.mon[c] * kZpCU3[c][k];
    wvc += q.mon[c] * kZpCV3[c][k];
  }
  wu = q.a11 * wuc + q.a21 * wvc;
  wv = q.a12 * wuc + q.a11 * wvc;
  const int dx = (int)(q.a11 * kZpDX3[k] + q.a21 * kZpDY3[k]);
  const int dy = (int)(q.a12 * kZpDX3[k] + q.a11 * kZpDY3[k]);
  const int ix = min(max(q.bx + dx, 0), g.nx - 1);
  const int iy = min(max(q.by + dy, 0), g.ny - 1);
  row = ix * g.ny + iy;
}

// The contraction of a set-up point over M tables at once (the members of
// an ensemble sharing one set-up): value m and physical gradient dm/dx
// [1/km] of each from the 3 z taps of each live row, which
//   taps(row, bz, c)
// writes into c[0..2][m] (T_m[row, bz-1], T_m[row, bz], T_m[row, bz+1]).
// Every member's sums are formed term for term as M = 1 forms them, so
// member m is bitwise the single-table contraction of table m.
template <int M, class Taps>
static __device__ __forceinline__ void zp_value_grad_members_from(
    const TableGrid& g, const ZpPoint& q, const Taps& taps, float (&val)[M],
    float (&gx)[M], float (&gy)[M], float (&gz)[M]) {
  float s[3][M], su[3][M], sv[3][M];
#pragma unroll
  for (int l = 0; l < 3; ++l)
#pragma unroll
    for (int m = 0; m < M; ++m) s[l][m] = su[l][m] = sv[l][m] = 0.0f;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    int r;
    float wk, wu, wv;
    zp_translate(g, q, k, r, wk, wu, wv);
    float c[3][M];
    taps(r, q.bz, c);
#pragma unroll
    for (int l = 0; l < 3; ++l)
#pragma unroll
      for (int m = 0; m < M; ++m) {
        s[l][m] += wk * c[l][m];
        su[l][m] += wu * c[l][m];
        sv[l][m] += wv * c[l][m];
      }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    val[m] = q.wz[0] * s[0][m] + q.wz[1] * s[1][m] + q.wz[2] * s[2][m];
    const float du =
        q.wz[0] * su[0][m] + q.wz[1] * su[1][m] + q.wz[2] * su[2][m];
    const float dv =
        q.wz[0] * sv[0][m] + q.wz[1] * sv[1][m] + q.wz[2] * sv[2][m];
    const float dw =
        q.dwz[0] * s[0][m] + q.dwz[1] * s[1][m] + q.dwz[2] * s[2][m];
    gx[m] = du / g.sx;
    gy[m] = dv / g.sy;
    gz[m] = dw / g.sz;
  }
}

// The contraction of a set-up point over one table: taps(row, bz, c)
// writes c[0..2] (T[row, bz-1], T[row, bz], T[row, bz+1]).
template <class Taps>
static __device__ __forceinline__ void zp_value_grad_from(
    const TableGrid& g, const ZpPoint& q, const Taps& taps, float& val,
    float& gx, float& gy, float& gz) {
  float v[1], x[1], y[1], z[1];
  zp_value_grad_members_from<1>(
      g, q,
      [&](int r, int bz, float (&c)[3][1]) {
        float t[3];
        taps(r, bz, t);
#pragma unroll
        for (int l = 0; l < 3; ++l) c[l][0] = t[l];
      },
      v, x, y, z);
  val = v[0];
  gx = x[0];
  gy = y[0];
  gz = z[0];
}

// Value m and physical gradient dm/dx [1/km] at (px, py, pz).
static __device__ __forceinline__ void zp_value_grad_at(
    const TableGrid& g, float px, float py, float pz, float& val, float& gx,
    float& gy, float& gz) {
  ZpPoint q;
  zp_setup(g, px, py, pz, q);
  zp_value_grad_from(
      g, q,
      [&](int r, int bz, float c[3]) {
        const float* row = g.coef + (size_t)r * (size_t)g.nz + (size_t)(bz - 1);
#pragma unroll
        for (int l = 0; l < 3; ++l) c[l] = __ldg(row + l);
      },
      val, gx, gy, gz);
}

// zp_value_grad_at reading the z-tap-packed table of K1 (trace_leapfrog_
// zp.cu, pack_zp_taps_kernel): packed[(b-1) * nx*ny + row] = (T[row, b-1],
// T[row, b], T[row, b+1], 0) for b in [1, nz-2], so a row's 3 taps are one
// aligned 16-byte load, one sector. The same weights and contraction, so
// the same value and gradient bit for bit.
static __device__ __forceinline__ void zp_value_grad_packed_at(
    const TableGrid& g, const float4* __restrict__ packed, float px,
    float py, float pz, float& val, float& gx, float& gy, float& gz) {
  ZpPoint q;
  zp_setup(g, px, py, pz, q);
  const size_t n_rows = (size_t)g.nx * (size_t)g.ny;
  zp_value_grad_from(
      g, q,
      [&](int r, int bz, float c[3]) {
        const float4 t = __ldg(packed + (size_t)(bz - 1) * n_rows + (size_t)r);
        c[0] = t.x;
        c[1] = t.y;
        c[2] = t.z;
      },
      val, gx, gy, gz);
}
