// ZP box spline (x, y) x Catmull-Rom cubic (z): value and physical
// gradient of the interpolated log-density at one point (the "zpc" field
// model).
//
// Shared by K1z (trace_leapfrog_zpc.cu, over the z-tap-packed table of
// K1c), K6z (zpc_value_grad.cu) and K6z^T (zpc_value_grad_bwd.cu). It is
// the per-point body of ionotomo_tpu/core/zpcubic.py:
// _neighborhood -> _xy_weights -> _row_index -> interp_rows_with_grad
// (:108-129), contracted xy-first as the reference does, and must stay in
// step with the plain PyTorch version in
// ionotomo_tpu_torch/core/zpcubic.py.
//
// The xy half is the zp model's set-up (zp_eval.cuh: zp_setup and
// zp_translate, with rintf, the clamp order and the skipped 8th
// translate); the z half is the tricubic model's floor-based 4-tap axis
// (cubic_eval.cuh: cubic_axis). zp_setup also sets up a quadratic z axis,
// which nothing here reads (the compiler drops it).
//
// Drift trap of this model: at the bottom and top cell bases the clamped
// z taps land on one lane (base 0: taps 0, 0, 1, 2; base nz-2: nz-3, nz-2,
// nz-1, nz-1). The reference's dense band (_z_band) adds the two weights
// on that lane before it contracts, so the evaluator does the same: the
// second tap's weight moves onto the first, and the second is weighted 0.
#pragma once

#include <cuda_runtime.h>

#include "cubic_eval.cuh"
#include "zp_eval.cuh"

// A set-up point: the zp xy set-up and the Catmull-Rom z axis with the
// weights of clamped taps on one lane merged.
struct ZpcPoint {
  ZpPoint q;    // xy: base, piece map, monomials (its z half unused)
  CubicAxis az; // z: the four clamped taps and their merged weights
};

static __device__ __forceinline__ void zpc_setup(const TableGrid& g, float px,
                                                 float py, float pz,
                                                 ZpcPoint& p) {
  zp_setup(g, px, py, pz, p.q);
  cubic_axis(pz, g.oz, g.sz, g.nz, p.az);
  // _z_band: band = 0; band += w[o] at lane i[o], o = 0..3, so a lane of
  // two taps holds (0 + w[o]) + w[o+1] = w[o] + w[o+1]
  if (p.az.i[1] == p.az.i[0]) {
    p.az.w[0] += p.az.w[1];
    p.az.dw[0] += p.az.dw[1];
    p.az.w[1] = 0.0f;
    p.az.dw[1] = 0.0f;
  }
  if (p.az.i[3] == p.az.i[2]) {
    p.az.w[2] += p.az.w[3];
    p.az.dw[2] += p.az.dw[3];
    p.az.w[3] = 0.0f;
    p.az.dw[3] = 0.0f;
  }
}

// The contraction of a set-up point: taps(row, c) writes c[0..3], the
// table's row at the four z taps p.az.i[0..3]. xy first: s, s_u and s_v
// of each tap summed over the 7 live translates from zero, translate by
// translate; then each against the z weights, tap by tap from zero; the
// gradient divided by the spacing last.
template <class Taps>
static __device__ __forceinline__ void zpc_value_grad_from(
    const TableGrid& g, const ZpcPoint& p, const Taps& taps, float& val,
    float& gx, float& gy, float& gz) {
  float s[4], su[4], sv[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) s[l] = su[l] = sv[l] = 0.0f;
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    int r;
    float wk, wu, wv;
    zp_translate(g, p.q, k, r, wk, wu, wv);
    float c[4];
    taps(r, c);
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      s[l] += wk * c[l];
      su[l] += wu * c[l];
      sv[l] += wv * c[l];
    }
  }
  float v = 0.0f, du = 0.0f, dv = 0.0f, dw = 0.0f;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    v += p.az.w[l] * s[l];
    du += p.az.w[l] * su[l];
    dv += p.az.w[l] * sv[l];
    dw += p.az.dw[l] * s[l];
  }
  val = v;
  gx = du / g.sx;
  gy = dv / g.sy;
  gz = dw / g.sz;
}

// Value m and physical gradient dm/dx [1/km] at (px, py, pz): 7 rows x 4
// taps, 28 scalar loads.
static __device__ __forceinline__ void zpc_value_grad_at(
    const TableGrid& g, float px, float py, float pz, float& val, float& gx,
    float& gy, float& gz) {
  ZpcPoint p;
  zpc_setup(g, px, py, pz, p);
  zpc_value_grad_from(
      g, p,
      [&](int r, float c[4]) {
        const float* row = g.coef + (size_t)r * (size_t)g.nz;
#pragma unroll
        for (int l = 0; l < 4; ++l) c[l] = __ldg(row + p.az.i[l]);
      },
      val, gx, gy, gz);
}

// zpc_value_grad_at reading the z-tap-packed table of K1c (pack_z_taps in
// trace_leapfrog_cubic.cu): packed[b * nx*ny + row] = (T[row, clamp(b-1)],
// T[row, b], T[row, b+1], T[row, clamp(b+2)]) for every cell base b in
// [0, nz-2], the very taps p.az.i[0..3] of base b = p.az.i[1] (zpc's z
// stencil is the tricubic one). One aligned 16-byte load a row; the same
// weights and contraction, so the same value and gradient bit for bit.
static __device__ __forceinline__ void zpc_value_grad_packed_at(
    const TableGrid& g, const float4* __restrict__ packed, float px,
    float py, float pz, float& val, float& gx, float& gy, float& gz) {
  ZpcPoint p;
  zpc_setup(g, px, py, pz, p);
  const float4* slab = packed + (size_t)p.az.i[1] * (size_t)(g.nx * g.ny);
  zpc_value_grad_from(
      g, p,
      [&](int r, float c[4]) {
        const float4 t = __ldg(slab + r);
        c[0] = t.x;
        c[1] = t.y;
        c[2] = t.z;
        c[3] = t.w;
      },
      val, gx, gy, gz);
}
