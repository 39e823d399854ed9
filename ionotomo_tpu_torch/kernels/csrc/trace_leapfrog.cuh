// The bent-ray integrators for one ray in one thread, over any field
// evaluator, and the launches the tracers share: leapfrog (velocity Verlet)
// with the Hermite TEC quadrature (K1, K1c, K1z, K1q and K1s's leapfrog)
// and classic rk4 (K1r, and K1s's rk4).
//
// They are ionotomo_tpu/geometry/fermat.py, _trace_impl's leapfrog branch
// (:204-227) and rk4 branch (:182-202), fused with _rhs (:61): the initial
// momentum p0 = n(x0) d is computed here too. The state stays in
// registers for the whole integration. With a path the thread writes its
// n_steps+1 samples, origin first, exactly as fermat.py builds `pts`.
//
// The integrators take an evaluator at the n_e level, as _trace_impl's
// ne_vg: LogNe wraps a log-density evaluator as log_field_ne_vg (:46)
// does (n_e = K_NE e^m, grad n_e = n_e grad m), and the split-field tracer
// (trace_split.cu) gives n_e directly.
//
// Numerics follow the reference: the two f32 values of w = KAPPA/f^2
// (refractive_index's f64-then-f32, and _rhs's f32 KAPPA * inv_f2) are
// passed in separately, the over-dense clip (1 - w n_e <= 1e-6) zeroes
// grad n, and h, h*h/12 and the TEC unit are f32. rk4 keeps the plain
// loop's association (x + (h/2) k1, sixth = h/6, ((k1 + 2 k2) + 2 k3) + k4
// as a running sum in that order) and its roundings. Elsewhere nvcc
// contracts a*b+c into FMA where the plain PyTorch version rounds twice,
// so the two differ in the last bits, growing over the steps (tolerances
// in chip_smoke.py).
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

// An evaluator at the n_e level is a functor
//   void operator()(const TableGrid&, const TraceConsts&, const float x[3],
//                   float& ne, float gne[3]) const
// giving n_e [m^-3] and its physical gradient [m^-3/km] at x.
//
// LogNe: fermat.log_field_ne_vg over a log-density evaluator ValueGrad,
//   void operator()(const TableGrid&, float x, float y, float z, float& m,
//                   float& gx, float& gy, float& gz) const
// giving m and its physical gradient [1/km].
template <class ValueGrad>
struct LogNe {
  ValueGrad value_grad;
  __device__ __forceinline__ void operator()(const TableGrid& g,
                                             const TraceConsts& c,
                                             const float x[3], float& ne,
                                             float gne[3]) const {
    float m, gm[3];
    value_grad(g, x[0], x[1], x[2], m, gm[0], gm[1], gm[2]);
    ne = c.k_ne * expf(m);
    gne[0] = ne * gm[0];
    gne[1] = ne * gm[1];
    gne[2] = ne * gm[2];
  }
};

// The initial momentum p0 = n(x0) d with refractive_index's w, from n_e at
// the origin.
static __device__ __forceinline__ void trace_p0(const TraceConsts& c,
                                                float ne,
                                                const float* __restrict__ dir,
                                                float p[3]) {
  const float n0 = sqrtf(fmaxf(1.0f - c.w_n * ne, 1e-6f));
#pragma unroll
  for (int d = 0; d < 3; ++d) p[d] = n0 * dir[d];
}

// Ray r of the batch, all n_steps of leapfrog, over an n_e-level evaluator.
// path may be null.
template <class NeField>
static __device__ __forceinline__ void trace_leapfrog_ray(
    const NeField& field, const TableGrid& g, const TraceConsts& c,
    const float* __restrict__ origins, const float* __restrict__ directions,
    int r, int n_steps, float* __restrict__ x_end,
    float* __restrict__ tau_out, float* __restrict__ path) {
  float x[3], p[3], gn[3], gne[3], ne, dne;
#pragma unroll
  for (int d = 0; d < 3; ++d) x[d] = origins[3 * r + d];

  field(g, c, x, ne, gne);
  trace_p0(c, ne, directions + 3 * r, p);
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
    field(g, c, x, ne1, gne1);
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

// _rhs at a stage point without dn_e/ds (rk4 never reads it): dx/ds =
// p/|p| into kx, dp/ds = grad n (zeroed under the over-dense clip) into kp,
// n_e into kne. Rounded as the plain loop rounds (no contraction).
template <class NeField>
static __device__ __forceinline__ void trace_rk4_stage(
    const NeField& field, const TableGrid& g, const TraceConsts& c,
    const float x[3], const float p[3], float kx[3], float kp[3],
    float& kne) {
  float gne[3];
  field(g, c, x, kne, gne);
  const float a = __fsub_rn(1.0f, __fmul_rn(c.w_rhs, kne));
  const bool clipped = a <= 1e-6f;
  const float n = sqrtf(fmaxf(a, 1e-6f));
  const float k = -0.5f * c.w_rhs / n;
  const float pn = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(p[0], p[0]),
                                             __fmul_rn(p[1], p[1])),
                                   __fmul_rn(p[2], p[2])));
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    kp[d] = clipped ? 0.0f : k * gne[d];
    kx[d] = p[d] / pn;
  }
}

// x + s k as the plain loop rounds it: the product, then the sum.
static __device__ __forceinline__ float rk4_axpy(float x, float s, float k) {
  return __fadd_rn(x, __fmul_rn(s, k));
}

// Ray r of the batch, all n_steps of rk4 (four evaluations a step), over an
// n_e-level evaluator. The running sums sx, sp, sne hold ((k1 + 2 k2) +
// 2 k3) + k4 as the plain loop associates it, and every update rounds its
// product and its sum apart, as the plain loop does: contracted into FMAs,
// the 4 x n_steps stages drift from it by ~1e-3 km at 64 steps. path may
// be null.
template <class NeField>
static __device__ __forceinline__ void trace_rk4_ray(
    const NeField& field, const TableGrid& g, const TraceConsts& c,
    const float* __restrict__ origins, const float* __restrict__ directions,
    int r, int n_steps, float* __restrict__ x_end,
    float* __restrict__ tau_out, float* __restrict__ path) {
  float x[3], p[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) x[d] = origins[3 * r + d];
  {
    float ne, gne[3];
    field(g, c, x, ne, gne);
    trace_p0(c, ne, directions + 3 * r, p);
  }

  float* my_path = path ? path + (size_t)r * (size_t)(n_steps + 1) * 3 : nullptr;
  if (my_path) {
#pragma unroll
    for (int d = 0; d < 3; ++d) my_path[d] = x[d];
  }

  const float half_h = 0.5f * c.h;
  const float sixth = c.h / 6.0f;
  float tau = 0.0f;
  for (int s = 0; s < n_steps; ++s) {
    float kx[3], kp[3], kne, xs[3], ps[3], sx[3], sp[3], sne;
    trace_rk4_stage(field, g, c, x, p, kx, kp, kne);
    sne = kne;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      sx[d] = kx[d];
      sp[d] = kp[d];
      xs[d] = rk4_axpy(x[d], half_h, kx[d]);
      ps[d] = rk4_axpy(p[d], half_h, kp[d]);
    }
    trace_rk4_stage(field, g, c, xs, ps, kx, kp, kne);
    sne = rk4_axpy(sne, 2.0f, kne);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      sx[d] = rk4_axpy(sx[d], 2.0f, kx[d]);
      sp[d] = rk4_axpy(sp[d], 2.0f, kp[d]);
      xs[d] = rk4_axpy(x[d], half_h, kx[d]);
      ps[d] = rk4_axpy(p[d], half_h, kp[d]);
    }
    trace_rk4_stage(field, g, c, xs, ps, kx, kp, kne);
    sne = rk4_axpy(sne, 2.0f, kne);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      sx[d] = rk4_axpy(sx[d], 2.0f, kx[d]);
      sp[d] = rk4_axpy(sp[d], 2.0f, kp[d]);
      xs[d] = rk4_axpy(x[d], c.h, kx[d]);
      ps[d] = rk4_axpy(p[d], c.h, kp[d]);
    }
    trace_rk4_stage(field, g, c, xs, ps, kx, kp, kne);
    sne = __fadd_rn(sne, kne);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      x[d] = rk4_axpy(x[d], sixth, __fadd_rn(sx[d], kx[d]));
      p[d] = rk4_axpy(p[d], sixth, __fadd_rn(sp[d], kp[d]));
    }
    tau = rk4_axpy(tau, __fmul_rn(sixth, sne), c.tec_unit);
    if (my_path) {
#pragma unroll
      for (int d = 0; d < 3; ++d) my_path[3 * (s + 1) + d] = x[d];
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) x_end[3 * r + d] = x[d];
  tau_out[r] = tau;
}

// The launch of every tracer: one thread per ray, `threads` a block, over
// an n_e-level evaluator that may carry its own data (a packed table, a
// background's parameters). Thread t traces ray order[t] (order null: ray
// t) and writes that ray's outputs at its own index, so an order changes
// which rays share a warp and nothing else. kRk4 selects the integrator
// (rk4, else leapfrog). kMinBlocks > 0 bounds the launch at
// kBudgetMaxThreads a block with the registers of kMinBlocks such blocks
// an SM (65536 / (kBudgetMaxThreads * kMinBlocks) a thread): the budget
// each source names for its model (K1R_BUDGET, chip_smoke.py --rk4-study;
// K1_BUDGET, --k1zq-study). kMinBlocks = 0 sets no bound
// (__launch_bounds__(0, 0) emits none) and the compiler picks the
// registers: K1's, K1c's and K1s's leapfrog.
constexpr int kBudgetMaxThreads = 256;

template <bool kRk4, int kMinBlocks, class NeField>
__global__ void __launch_bounds__(kMinBlocks > 0 ? kBudgetMaxThreads : 0,
                                  kMinBlocks)
    trace_ordered_kernel(
        NeField field, const float* __restrict__ table,
        const float* __restrict__ origin, const float* __restrict__ spacing,
        int nx, int ny, int nz, const float* __restrict__ origins,
        const float* __restrict__ directions, const int* __restrict__ order,
        int n_rays, int n_steps, TraceConsts c, float* __restrict__ x_end,
        float* __restrict__ tau_out, float* __restrict__ path) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rays) return;
  const int r = order ? __ldg(order + t) : t;
  const TableGrid g = table_grid(table, origin, spacing, nx, ny, nz);
  if constexpr (kRk4)
    trace_rk4_ray(field, g, c, origins, directions, r, n_steps, x_end,
                  tau_out, path);
  else
    trace_leapfrog_ray(field, g, c, origins, directions, r, n_steps, x_end,
                       tau_out, path);
}

// A study build's register budget for K1z's and K1q's leapfrog over the
// packed table (-DK1_MIN_BLOCKS=n, chip_smoke.py --k1zq-study), else the
// model's own.
#ifdef K1_MIN_BLOCKS
#define K1_BUDGET(model_default) (K1_MIN_BLOCKS)
#else
#define K1_BUDGET(model_default) (model_default)
#endif

// A study build's register budget for every model's K1r
// (-DK1R_MIN_BLOCKS=n, chip_smoke.py --rk4-study), else the model's own.
#ifdef K1R_MIN_BLOCKS
#define K1R_BUDGET(model_default) (K1R_MIN_BLOCKS)
#else
#define K1R_BUDGET(model_default) (model_default)
#endif

// threads: a multiple of 32 up to 1024, up to kBudgetMaxThreads at a
// budget; kRk4 the integrator, kBudget its register budget as
// trace_ordered_kernel takes it.
template <bool kRk4, int kBudget, class NeField>
static int launch_trace_ordered(
    const NeField& field, const float* table, const float* origin,
    const float* spacing, int nx, int ny, int nz, const float* origins,
    const float* directions, const int* order, int n_rays, int n_steps,
    const TraceConsts& c, int threads, float* x_end, float* tau_out,
    float* path, void* stream) {
  constexpr int kMaxThreads = kBudget > 0 ? kBudgetMaxThreads : 1024;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + threads - 1) / threads;
  trace_ordered_kernel<kRk4, kBudget, NeField>
      <<<blocks, threads, 0, (cudaStream_t)stream>>>(
          field, table, origin, spacing, nx, ny, nz, origins, directions,
          order, n_rays, n_steps, c, x_end, tau_out, path);
  return (int)cudaGetLastError();
}

// The entry of a log-density tracer (K1, K1c, K1z, K1q and their rk4, K1r):
// packed, the model's z-tap pack of `table`, which the tracer reads in its
// place (Packed's evaluator), or null (Plain's); order: (n_rays,) ray of
// each thread, or null; threads: the block size; path may be null
// (keep_path=False); kRk4 the integrator, kBudget its register budget (the
// entries name theirs; 0: the compiler's registers). Over the unpacked
// table leapfrog keeps the compiler's registers: the wrappers read the
// table as it is only at batches too small to fill the card
// (kernels.SORT_AND_PACK), where a budget that fills the card costs each
// ray's latency.
template <bool kRk4, int kBudget, class Plain, class Packed>
static int trace_log_density(
    const float* table, const float* packed, const float* origin,
    const float* spacing, int nx, int ny, int nz, const float* origins,
    const float* directions, const int* order, int n_rays, int n_steps,
    float h, float hh12, float w_n, float w_rhs, float k_ne, float tec_unit,
    int threads, float* x_end, float* tau, float* path, void* stream) {
  const TraceConsts c{h, hh12, w_n, w_rhs, k_ne, tec_unit};
  if (packed == nullptr)
    return launch_trace_ordered<kRk4, kRk4 ? kBudget : 0>(
        LogNe<Plain>{Plain{}}, table, origin, spacing, nx, ny, nz, origins,
        directions, order, n_rays, n_steps, c, threads, x_end, tau, path,
        stream);
  return launch_trace_ordered<kRk4, kBudget>(
      LogNe<Packed>{Packed{reinterpret_cast<const float4*>(packed)}}, table,
      origin, spacing, nx, ny, nz, origins, directions, order, n_rays,
      n_steps, c, threads, x_end, tau, path, stream);
}
