// K1s: the split-field bent-ray tracer, leapfrog or rk4, all n_steps in one
// launch: n_e = a closed-form Chapman background + the tricubic model of a
// gridded perturbation.
//
// Replaces: ionotomo_tpu/geometry/fermat.py, trace_rays_split (:243), whose
// ne_vg (:290-293) sums the tricubic value + gradient of the perturbation
// table (core/tricubic.py:529, interp_rows_with_grad) and the background
// evaluator of models/chapman.py:background_ne_fn (:200, value and gradient
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
//
// Bound on the H100: the perturbation's gather, as K1c's (16 one-sector
// loads a step over the z-tap pack of the perturbation table); the
// background adds two exps, a division and, per layer, a few multiply-adds,
// and reads its (n_layers, 4) parameters from L1.
//
// Design: K1c's (trace_leapfrog_cubic.cu) over the evaluator
// SplitNe<pert, ChapmanBackground>, at the n_e level of trace_leapfrog.cuh
// (no exp of m): the perturbation table packed by K1c's pack_z_taps, the
// rays sorted by kernels.ray_order when the batch fills the card, K1c's
// block sizes. Every ray's output is bitwise what the unpacked evaluator
// gives in ray order.
//
// Determinism: no atomics and a fixed order of operations per thread.
#include "cubic_eval.cuh"
#include "trace_leapfrog.cuh"

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

// fermat.trace_rays_split's ne_vg: background + perturbation, value and
// gradient, summed as (nb + d, gb + gd).
template <class Pert>
struct SplitNe {
  Pert pert;
  ChapmanBackground bg;
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

// pert: the (nx*ny, nz) perturbation table; packed: its K1c pack
// (ionotomo_pack_z_taps) or null (the unpacked evaluator); order: (n_rays,)
// ray of each thread, or null; rk4: 1 for rk4, 0 for leapfrog; layers:
// (n_layers, 4) f32 (n_peak, h_peak, scale, sensitivity), 16-byte aligned;
// threads: the block size (launch_trace_ordered, at most 256 for rk4);
// path may be null. rk4 takes K1r's launch with K1r on cubic's register
// budget, 3 blocks of 256 an SM.
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
  auto launch = [&](const auto& field) {
    return rk4 != 0
               ? launch_trace_ordered<true, K1R_BUDGET(3)>(
                     field, pert, origin, spacing, nx, ny, nz, origins,
                     directions, order, n_rays, n_steps, c, threads, x_end,
                     tau, path, stream)
               : launch_trace_ordered<false, 0>(
                     field, pert, origin, spacing, nx, ny, nz, origins,
                     directions, order, n_rays, n_steps, c, threads, x_end,
                     tau, path, stream);
  };
  if (packed == nullptr) return launch(SplitNe<PertValueGrad>{{}, bg});
  return launch(SplitNe<PertValueGradPacked>{
      {reinterpret_cast<const float4*>(packed)}, bg});
}
