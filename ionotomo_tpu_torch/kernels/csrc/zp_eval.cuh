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
// d/dv over the monomials 1, u, v), and _DX3 and _DY3 (zp_dxy's axes 0
// and 1). Exact rationals /16. Each is read as a constant of the code where
// the translate is known as the code is made (zp_translate_unrolled), and
// copied into constant memory for the rest (kZp). tests/test_torch_slice.py
// checks them against the port's numpy tables.
static __host__ __device__ __forceinline__ constexpr float zp_cw3(int c,
                                                                 int k) {
  constexpr float t[6][8] = {
      {0.125f, 0.125f, 0.5f, 0.125f, 0.0f, 0.125f, 0.0f, 0.0f},
      {-0.5f, 0.0f, 0.0f, 0.0f, 0.0f, 0.5f, 0.0f, 0.0f},
      {0.0f, -0.5f, 0.0f, 0.5f, 0.0f, 0.0f, 0.0f, 0.0f},
      {0.5f, -0.25f, -0.5f, -0.25f, 0.25f, 0.0f, 0.25f, 0.0f},
      {0.0f, 0.5f, 0.0f, -0.5f, -0.5f, 0.0f, 0.5f, 0.0f},
      {0.0f, 0.25f, -0.5f, 0.25f, 0.25f, -0.5f, 0.25f, 0.0f},
  };
  return t[c][k];
}
static __host__ __device__ __forceinline__ constexpr float zp_cu3(int c,
                                                                 int k) {
  constexpr float t[3][8] = {
      {-0.5f, 0.0f, 0.0f, 0.0f, 0.0f, 0.5f, 0.0f, 0.0f},
      {1.0f, -0.5f, -1.0f, -0.5f, 0.5f, 0.0f, 0.5f, 0.0f},
      {0.0f, 0.5f, 0.0f, -0.5f, -0.5f, 0.0f, 0.5f, 0.0f},
  };
  return t[c][k];
}
static __host__ __device__ __forceinline__ constexpr float zp_cv3(int c,
                                                                 int k) {
  constexpr float t[3][8] = {
      {0.0f, -0.5f, 0.0f, 0.5f, 0.0f, 0.0f, 0.0f, 0.0f},
      {0.0f, 0.5f, 0.0f, -0.5f, -0.5f, 0.0f, 0.5f, 0.0f},
      {0.0f, 0.5f, -1.0f, 0.5f, 0.5f, -1.0f, 0.5f, 0.0f},
  };
  return t[c][k];
}
static __host__ __device__ __forceinline__ constexpr int zp_dxy(int axis,
                                                               int k) {
  constexpr int t[2][8] = {{-1, 0, 0, 0, 1, 1, 1, 0},
                           {0, -1, 0, 1, -1, 0, 1, 0}};
  return t[axis][k];
}

// The same tables in constant memory, for a translate chosen at run time
// (zp_translate: K1e^T and K6z^T index it so).
struct ZpTables {
  float cw3[6][8];
  float cu3[3][8];
  float cv3[3][8];
  float dx3[8];
  float dy3[8];
};

static __host__ __device__ constexpr ZpTables zp_tables() {
  ZpTables t{};
  for (int k = 0; k < 8; ++k) {
    for (int c = 0; c < 6; ++c) t.cw3[c][k] = zp_cw3(c, k);
    for (int c = 0; c < 3; ++c) {
      t.cu3[c][k] = zp_cu3(c, k);
      t.cv3[c][k] = zp_cv3(c, k);
    }
    t.dx3[k] = (float)zp_dxy(0, k);
    t.dy3[k] = (float)zp_dxy(1, k);
  }
  return t;
}

static __constant__ ZpTables kZp = zp_tables();

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
  for (int c = 0; c < 6; ++c) wk += q.mon[c] * kZp.cw3[c][k];
  float wuc = 0.0f, wvc = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    wuc += q.mon[c] * kZp.cu3[c][k];
    wvc += q.mon[c] * kZp.cv3[c][k];
  }
  wu = q.a11 * wuc + q.a21 * wvc;
  wv = q.a12 * wuc + q.a11 * wvc;
  const int dx = (int)(q.a11 * kZp.dx3[k] + q.a21 * kZp.dy3[k]);
  const int dy = (int)(q.a12 * kZp.dx3[k] + q.a11 * kZp.dy3[k]);
  const int ix = min(max(q.bx + dx, 0), g.nx - 1);
  const int iy = min(max(q.by + dy, 0), g.ny - 1);
  row = ix * g.ny + iy;
}

// zp_translate for translate k of an unrolled loop (k known where the code
// is made), bitwise its result with fewer instructions: the tables are
// read as constants of the code (zp_cw3, zp_cu3, zp_cv3, zp_dxy), a term of
// a zero coefficient is not formed (each sum starts at +0 and can never
// reach -0, so adding a zero leaves it as it is), every coefficient is a
// power of two or zero (so a product is exact and contracting it into an
// FMA changes nothing), and the lattice offsets are integer sums of the
// piece map's entries (ia: a11, a12, a21 as ints, each -1, 0 or 1, whose
// float sum zp_translate truncates exactly). K6z and K1z and K1r on zpc
// and the batched K1e take it; K1, K1e and K1r on zp keep zp_translate.
static __device__ __forceinline__ void zp_translate_unrolled(
    const TableGrid& g, const ZpPoint& q, const int (&ia)[3], int k,
    int& row, float& wk, float& wu, float& wv) {
  wk = 0.0f;
#pragma unroll
  for (int c = 0; c < 6; ++c)
    if (zp_cw3(c, k) != 0.0f) wk += q.mon[c] * zp_cw3(c, k);
  float wuc = 0.0f, wvc = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (zp_cu3(c, k) != 0.0f) wuc += q.mon[c] * zp_cu3(c, k);
    if (zp_cv3(c, k) != 0.0f) wvc += q.mon[c] * zp_cv3(c, k);
  }
  wu = q.a11 * wuc + q.a21 * wvc;
  wv = q.a12 * wuc + q.a11 * wvc;
  const int dx = ia[0] * zp_dxy(0, k) + ia[2] * zp_dxy(1, k);
  const int dy = ia[1] * zp_dxy(0, k) + ia[0] * zp_dxy(1, k);
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
// member m is bitwise the single-table contraction of table m. UNROLLED:
// each translate by zp_translate_unrolled (bitwise zp_translate's).
template <int M, bool UNROLLED = false, class Taps>
static __device__ __forceinline__ void zp_value_grad_members_from(
    const TableGrid& g, const ZpPoint& q, const Taps& taps, float (&val)[M],
    float (&gx)[M], float (&gy)[M], float (&gz)[M]) {
  float s[3][M], su[3][M], sv[3][M];
#pragma unroll
  for (int l = 0; l < 3; ++l)
#pragma unroll
    for (int m = 0; m < M; ++m) s[l][m] = su[l][m] = sv[l][m] = 0.0f;
  const int ia[3] = {(int)q.a11, (int)q.a12, (int)q.a21};
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    int r;
    float wk, wu, wv;
    if (UNROLLED)
      zp_translate_unrolled(g, q, ia, k, r, wk, wu, wv);
    else
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
