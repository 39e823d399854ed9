// The leapfrog (velocity Verlet) bent-ray integrator with the Hermite TEC
// quadrature, for one ray in one thread, over any field evaluator, and the
// launch that K1 (trace_leapfrog_zp.cu, the zp model) and K1c
// (trace_leapfrog_cubic.cu, the tricubic model) share.
//
// It is ionotomo_tpu/geometry/fermat.py, _trace_impl's leapfrog branch
// (:204-227) fused with _rhs (:61) and log_field_ne_vg: the initial
// momentum p0 = n(x0) d and _rhs at the origin are computed here too. The
// state x, p, grad n, n_e, dn_e/ds and tau stays in registers for the whole
// integration. With a path the thread writes its n_steps+1 samples, origin
// first, exactly as fermat.py builds `pts`.
//
// Numerics follow the reference: the two f32 values of w = KAPPA/f^2
// (refractive_index's f64-then-f32, and _rhs's f32 KAPPA * inv_f2) are
// passed in separately, the over-dense clip (1 - w n_e <= 1e-6) zeroes
// grad n, and h, h*h/12 and the TEC unit are f32. nvcc contracts a*b+c
// into FMA where the plain PyTorch version rounds twice, so the two differ
// in the last bits, growing over the steps (tolerances in chip_smoke.py).
#pragma once

#include <cuda_runtime.h>

#include "table_grid.cuh"

struct TraceConsts {
  float h;         // step [km]
  float hh12;      // h*h/12
  float w_n;       // KAPPA/f^2 as refractive_index rounds it
  float w_rhs;     // KAPPA * inv_f2 as _rhs rounds it
  float k_ne;      // K_NE
  float tec_unit;  // KM_TO_M / TEC_SCALE
};

// fermat._rhs given the field at x: grad n (zeroed under the over-dense
// clip) and the path derivative dn_e/ds = grad n_e . p/|p|.
static __device__ __forceinline__ void trace_rhs(const TraceConsts& c,
                                                 float ne, const float gne[3],
                                                 const float p[3],
                                                 float gn[3], float& dne) {
  const float a = 1.0f - c.w_rhs * ne;
  const bool clipped = a <= 1e-6f;
  const float n = sqrtf(fmaxf(a, 1e-6f));
  const float k = -0.5f * c.w_rhs / n;
#pragma unroll
  for (int d = 0; d < 3; ++d) gn[d] = clipped ? 0.0f : k * gne[d];
  const float pn = sqrtf(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]);
  dne = gne[0] * (p[0] / pn) + gne[1] * (p[1] / pn) + gne[2] * (p[2] / pn);
}

// Ray r of the batch, all n_steps. ValueGrad is a functor
//   void operator()(const TableGrid&, float x, float y, float z, float& m,
//                   float& gx, float& gy, float& gz) const
// giving the log-density m and its physical gradient [1/km]; n_e = K_NE e^m
// and grad n_e = n_e grad m (fermat.log_field_ne_vg). path may be null.
template <class ValueGrad>
static __device__ __forceinline__ void trace_leapfrog_ray(
    const ValueGrad& value_grad, const TableGrid& g, const TraceConsts& c,
    const float* __restrict__ origins, const float* __restrict__ directions,
    int r, int n_steps, float* __restrict__ x_end,
    float* __restrict__ tau_out, float* __restrict__ path) {
  auto ne_vg = [&](const float x[3], float& ne, float gne[3]) {
    float m, gm[3];
    value_grad(g, x[0], x[1], x[2], m, gm[0], gm[1], gm[2]);
    ne = c.k_ne * expf(m);
    gne[0] = ne * gm[0];
    gne[1] = ne * gm[1];
    gne[2] = ne * gm[2];
  };

  float x[3], p[3], gn[3], gne[3], ne, dne;
#pragma unroll
  for (int d = 0; d < 3; ++d) x[d] = origins[3 * r + d];

  // p0 = n(x0) d with refractive_index's w
  ne_vg(x, ne, gne);
  const float n0 = sqrtf(fmaxf(1.0f - c.w_n * ne, 1e-6f));
#pragma unroll
  for (int d = 0; d < 3; ++d) p[d] = n0 * directions[3 * r + d];
  trace_rhs(c, ne, gne, p, gn, dne);

  float* my_path = path ? path + (size_t)r * (size_t)(n_steps + 1) * 3 : nullptr;
  if (my_path) {
#pragma unroll
    for (int d = 0; d < 3; ++d) my_path[d] = x[d];
  }

  const float half_h = 0.5f * c.h;
  float tau = 0.0f;
  for (int s = 0; s < n_steps; ++s) {
    float ph[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) ph[d] = p[d] + half_h * gn[d];
    const float pn = sqrtf(ph[0] * ph[0] + ph[1] * ph[1] + ph[2] * ph[2]);
#pragma unroll
    for (int d = 0; d < 3; ++d) x[d] = x[d] + c.h * (ph[d] / pn);

    float ne1, gne1[3], gn1[3], dne1;
    ne_vg(x, ne1, gne1);
    trace_rhs(c, ne1, gne1, ph, gn1, dne1);
#pragma unroll
    for (int d = 0; d < 3; ++d) p[d] = ph[d] + half_h * gn1[d];
    tau = tau + (half_h * (ne + ne1) + c.hh12 * (dne - dne1)) * c.tec_unit;
    ne = ne1;
    dne = dne1;
#pragma unroll
    for (int d = 0; d < 3; ++d) gn[d] = gn1[d];
    if (my_path) {
#pragma unroll
      for (int d = 0; d < 3; ++d) my_path[3 * (s + 1) + d] = x[d];
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) x_end[3 * r + d] = x[d];
  tau_out[r] = tau;
}

// The launch of K1 and K1c: one thread per ray, `threads` a block, over
// an evaluator that may carry its own data (the packed table). Thread t
// traces ray order[t] (order null: ray t) and writes that ray's outputs at
// its own index, so an order changes which rays share a warp and nothing
// else.
template <class ValueGrad>
__global__ void trace_leapfrog_ordered_kernel(
    ValueGrad value_grad, const float* __restrict__ table,
    const float* __restrict__ origin, const float* __restrict__ spacing,
    int nx, int ny, int nz, const float* __restrict__ origins,
    const float* __restrict__ directions, const int* __restrict__ order,
    int n_rays, int n_steps, TraceConsts c, float* __restrict__ x_end,
    float* __restrict__ tau_out, float* __restrict__ path) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rays) return;
  const int r = order ? __ldg(order + t) : t;
  const TableGrid g = table_grid(table, origin, spacing, nx, ny, nz);
  trace_leapfrog_ray(value_grad, g, c, origins, directions, r, n_steps, x_end,
                     tau_out, path);
}

// threads: a multiple of 32 up to 1024.
template <class ValueGrad>
static int launch_trace_leapfrog_ordered(
    const ValueGrad& value_grad, const float* table, const float* origin,
    const float* spacing, int nx, int ny, int nz, const float* origins,
    const float* directions, const int* order, int n_rays, int n_steps,
    const TraceConsts& c, int threads, float* x_end, float* tau_out,
    float* path, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + threads - 1) / threads;
  trace_leapfrog_ordered_kernel<ValueGrad><<<blocks, threads, 0,
                                             (cudaStream_t)stream>>>(
      value_grad, table, origin, spacing, nx, ny, nz, origins, directions,
      order, n_rays, n_steps, c, x_end, tau_out, path);
  return (int)cudaGetLastError();
}
