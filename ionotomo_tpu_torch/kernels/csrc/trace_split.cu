// K1s: the split-field bent-ray tracer, leapfrog or rk4, all n_steps in one
// launch: n_e = a closed-form Chapman background + the tricubic model of a
// gridded perturbation.
//
// Replaces: ionotomo_tpu/geometry/fermat.py, trace_rays_split (:243), whose
// ne_vg (:290-293) sums the tricubic value + gradient of the perturbation
// table (core/tricubic.py:529, interp_rows_with_grad) and the background
// evaluator of models/chapman.py:background_ne_fn (:164, value and gradient
// by jax autodiff), under _trace_impl's leapfrog or rk4 branch with _rhs.
//
// The background here is analytic, n_e and its gradient in closed form (its
// plain twin: ionotomo_tpu_torch/models/chapman.py,
// ChapmanBackground.value_and_grad_analytic):
// - each layer l: m_l n_peak exp(0.5 (1 - z - e^{-z})), z = (h - h_peak)/H,
//   dn_e/dh = n_e 0.5 (e^{-z} - 1)/H, with m_l = factor^sens (the solar
//   factor, 1 without cos chi; a single layer has sens 1), summed in layer
//   order from 0;
// - with a plasmasphere (n0 != 0): + n0 exp(-max(dh, 0)/H_p) sigmoid(dh/60),
//   dh = h - h_top;
// - curved Earth: h = |(x, y, zc0 + z)| - R, whose gradient is that vector
//   over its length; flat: h = z.
// It comes in two forms, chosen by the wrapper from what the background is
// (kernels.split_form): ChapmanLayer, one layer of sensitivity 1 over the
// flat Earth without a plasmasphere (background_ne_fn() and its cos chi
// variants: the main path's), its parameters held in the functor; and
// ChapmanBackground, any other, reading its layers from L1. The first is
// the second's operations on that case in the same order, so both give
// the same bits.
//
// Bound on the H100: the perturbation's gather, as K1c's (16 one-sector
// loads a step over the z-tap pack of the perturbation table); the
// background adds two exps, two divisions and a few multiply-adds a layer.
//
// Design: K1c's evaluator (cubic_eval.cuh) over the perturbation packed by
// K1c's pack_z_taps, in the ordered launch of trace_leapfrog.cuh
// (SplitNe<pert, background>, at the n_e level: no exp of m), with a
// launch of its own: the leapfrog over the packed table at a register
// budget of 3 blocks of 256 an SM (K1S_BUDGET), rk4 at K1r on cubic's, and
// the leapfrog call's thresholds and blocks in kernels (SORT_AND_PACK,
// SPLIT_PACKED_RAYS_PER_SM). From chip_smoke.py --k1zq-study (NVIDIA H100
// 80GB HBM3, 700 W, the tracer alone, packed and sorted, 262,144 rays):
// the one-layer form runs 648 SASS instructions a leapfrog step against
// the general form's 918, and its tracer 0.2784-0.2791 ms at @32 against
// 0.3058-0.3072 (256 a block); at budget 3 (80 registers, no spill)
// 0.2683-0.2709, while budgets 1 and 2 (128-132 registers) take 15-68 %
// longer than that and 4 (64 registers) spills and takes 8-9 % longer. At rk4@64 the one-layer form takes
// 1.8783-1.8814 ms against 2.0662-2.0880, and cubic's budget of 3 stays
// the fastest. Every ray's output is bitwise what the unpacked evaluator
// gives in ray order.
//
// Determinism: no atomics and a fixed order of operations per thread.
#include "cubic_eval.cuh"
#include "trace_leapfrog.cuh"

#include <type_traits>

// Types of this file alone (global scope: a __global__ template takes them).
struct PertValueGrad {
  __device__ __forceinline__ void operator()(const TableGrid& g, float x,
                                             float y, float z, float& v,
                                             float& gx, float& gy,
                                             float& gz) const {
    cubic_value_grad_at(g, x, y, z, v, gx, gy, gz);
  }
};

struct PertValueGradPacked {
  const float4* __restrict__ packed;
  __device__ __forceinline__ void operator()(const TableGrid& g, float x,
                                             float y, float z, float& v,
                                             float& gx, float& gy,
                                             float& gz) const {
    cubic_value_grad_packed_at(g, packed, x, y, z, v, gx, gy, gz);
  }
};

struct ChapmanBackground {
  const float4* __restrict__ layers;  // (n_peak, h_peak, scale, sens)
  int n_layers;
  float factor;     // solar factor, 1 without cos chi
  int curved;       // altitude over the curved Earth
  float zc0;        // R + site height [km]
  float r_earth;    // R [km]
  float ps_n0;      // plasmasphere density at h_top; 0: none
  float ps_scale;   // its scale height [km]
  float h_top;      // the topmost layer's peak [km]

  // n_e and its physical gradient at x.
  __device__ __forceinline__ void operator()(const float x[3], float& ne,
                                             float gne[3]) const {
    float h, r = 1.0f, zc = 0.0f;
    if (curved) {
      zc = zc0 + x[2];
      r = sqrtf(x[0] * x[0] + x[1] * x[1] + zc * zc);
      h = r - r_earth;
    } else {
      h = x[2];
    }
    float total = 0.0f, dtotal = 0.0f;
    for (int l = 0; l < n_layers; ++l) {
      const float4 p = __ldg(layers + l);
      const float mult = p.w == 1.0f ? factor : powf(factor, p.w);
      const float z = (h - p.y) / p.z;
      const float e = expf(-z);
      const float nl = mult * (p.x * expf(0.5f * (1.0f - z - e)));
      total = total + nl;
      dtotal = dtotal + nl * 0.5f * (e - 1.0f) / p.z;
    }
    if (ps_n0 != 0.0f) {
      const float dh = h - h_top;
      const float tail = ps_n0 * expf(-fmaxf(dh, 0.0f) / ps_scale);
      const float s = 1.0f / (1.0f + expf(-(dh / 60.0f)));
      total = total + tail * s;
      const float dtail = dh > 0.0f ? -tail / ps_scale : 0.0f;
      dtotal = dtotal + (dtail * s + tail * (s * (1.0f - s)) / 60.0f);
    }
    ne = total;
    if (curved) {
      gne[0] = dtotal * (x[0] / r);
      gne[1] = dtotal * (x[1] / r);
      gne[2] = dtotal * (zc / r);
    } else {
      gne[0] = 0.0f;
      gne[1] = 0.0f;
      gne[2] = dtotal;
    }
  }
};

// ChapmanBackground on one layer of sensitivity 1 over the flat Earth
// without a plasmasphere, its parameters in registers: no layer loop, no
// load, no powf, no curved-Earth or plasmasphere branch. Each sum still
// starts from +0 as ChapmanBackground's does (0 + nl, 0 + dnl), and the
// flat gradient's x and y are +0 (SplitNe adds the perturbation's to them).
struct ChapmanLayer {
  float n_peak;  // m^-3
  float h_peak;  // km
  float scale;   // km
  float factor;  // solar factor, 1 without cos chi

  __device__ __forceinline__ void operator()(const float x[3], float& ne,
                                             float gne[3]) const {
    const float z = (x[2] - h_peak) / scale;
    const float e = expf(-z);
    const float nl = factor * (n_peak * expf(0.5f * (1.0f - z - e)));
    ne = 0.0f + nl;
    gne[0] = 0.0f;
    gne[1] = 0.0f;
    gne[2] = 0.0f + nl * 0.5f * (e - 1.0f) / scale;
  }
};

// fermat.trace_rays_split's ne_vg: background + perturbation, value and
// gradient, summed as (nb + d, gb + gd).
template <class Pert, class Background>
struct SplitNe {
  Pert pert;
  Background bg;
  __device__ __forceinline__ void operator()(const TableGrid& g,
                                             const TraceConsts&,
                                             const float x[3], float& ne,
                                             float gne[3]) const {
    float d, gd[3], nb, gb[3];
    pert(g, x[0], x[1], x[2], d, gd[0], gd[1], gd[2]);
    bg(x, nb, gb);
    ne = nb + d;
#pragma unroll
    for (int k = 0; k < 3; ++k) gne[k] = gb[k] + gd[k];
  }
};

// The register budget of K1s's leapfrog over the packed table, in blocks
// of 256 an SM, as K1_BUDGET reads it (a block of at most 256: the
// wrapper's _check_threads).
#define K1S_BUDGET K1_BUDGET(3)

// Both forms' launch: rk4 on K1r on cubic's register budget, 3 blocks of
// 256 an SM; leapfrog over the packed table at K1S_BUDGET, over the table
// as it is at the compiler's registers.
template <class Background>
static int trace_split_launch(
    const Background& bg, const float* pert, const float* packed,
    const float* origin, const float* spacing, int nx, int ny, int nz,
    const float* origins, const float* directions, const int* order,
    int n_rays, int n_steps, int rk4, const TraceConsts& c, int threads,
    float* x_end, float* tau, float* path, void* stream) {
  auto launch = [&](const auto& field, auto budget) {
    constexpr int kLeapfrogBudget = decltype(budget)::value;
    return rk4 != 0
               ? launch_trace_ordered<true, K1R_BUDGET(3)>(
                     field, pert, origin, spacing, nx, ny, nz, origins,
                     directions, order, n_rays, n_steps, c, threads, x_end,
                     tau, path, stream)
               : launch_trace_ordered<false, kLeapfrogBudget>(
                     field, pert, origin, spacing, nx, ny, nz, origins,
                     directions, order, n_rays, n_steps, c, threads, x_end,
                     tau, path, stream);
  };
  if (packed == nullptr)
    return launch(SplitNe<PertValueGrad, Background>{{}, bg},
                  std::integral_constant<int, 0>{});
  return launch(SplitNe<PertValueGradPacked, Background>{
                    {reinterpret_cast<const float4*>(packed)}, bg},
                std::integral_constant<int, K1S_BUDGET>{});
}

// pert: the (nx*ny, nz) perturbation table; packed: its K1c pack
// (ionotomo_pack_z_taps) or null (the unpacked evaluator); order: (n_rays,)
// ray of each thread, or null; rk4: 1 for rk4, 0 for leapfrog; threads:
// the block size (launch_trace_ordered: at most 256 at a budget); path may
// be null. The general form: layers, (n_layers, 4) f32 (n_peak, h_peak,
// scale, sensitivity), 16-byte aligned.
extern "C" int ionotomo_trace_split(
    const float* pert, const float* packed, const float* origin,
    const float* spacing, int nx, int ny, int nz, const float* origins,
    const float* directions, const int* order, int n_rays, int n_steps,
    int rk4, float h, float hh12, float w_n, float w_rhs, float tec_unit,
    const float* layers, int n_layers, float factor, int curved, float zc0,
    float r_earth, float ps_n0, float ps_scale, float h_top, int threads,
    float* x_end, float* tau, float* path, void* stream) {
  if (nx < 2 || ny < 2 || nz < 2 || n_layers < 1)
    return (int)cudaErrorInvalidValue;
  const TraceConsts c{h, hh12, w_n, w_rhs, 0.0f, tec_unit};
  const ChapmanBackground bg{reinterpret_cast<const float4*>(layers),
                             n_layers, factor, curved, zc0, r_earth, ps_n0,
                             ps_scale, h_top};
  return trace_split_launch(bg, pert, packed, origin, spacing, nx, ny, nz,
                            origins, directions, order, n_rays, n_steps, rk4,
                            c, threads, x_end, tau, path, stream);
}

// The one-layer form (ChapmanLayer): the layer's n_peak, h_peak and scale
// and the solar factor as f32, the other arguments as ionotomo_trace_split
// takes them.
extern "C" int ionotomo_trace_split_layer(
    const float* pert, const float* packed, const float* origin,
    const float* spacing, int nx, int ny, int nz, const float* origins,
    const float* directions, const int* order, int n_rays, int n_steps,
    int rk4, float h, float hh12, float w_n, float w_rhs, float tec_unit,
    float n_peak, float h_peak, float scale, float factor, int threads,
    float* x_end, float* tau, float* path, void* stream) {
  if (nx < 2 || ny < 2 || nz < 2) return (int)cudaErrorInvalidValue;
  const TraceConsts c{h, hh12, w_n, w_rhs, 0.0f, tec_unit};
  return trace_split_launch(ChapmanLayer{n_peak, h_peak, scale, factor},
                            pert, packed, origin, spacing, nx, ny, nz,
                            origins, directions, order, n_rays, n_steps, rk4,
                            c, threads, x_end, tau, path, stream);
}
