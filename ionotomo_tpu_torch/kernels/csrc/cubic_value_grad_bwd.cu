// K5^T: transpose of K5 (tricubic value + physical gradient at points) with
// respect to the table. Given a value cotangent cv (N,) and a gradient
// cotangent cg (N, 3), it scatters into the 16 rows (a, b) x 4 z taps l of
// each point
//   cv wx_a wy_b wz_l + cg_x/h_x dwx_a wy_b wz_l + cg_y/h_y wx_a dwy_b wz_l
//                     + cg_z/h_z wx_a wy_b dwz_l.
//
// Replaces: the transpose XLA derives from the gather in
// ionotomo_tpu/core/tricubic.py, interp_rows_with_grad (:529-562), which
// jax.linear_transpose reaches through the Hermite endpoint terms of the
// linearised dTEC operator (inversion/solvers.py:88-121). At config 4 it
// carries 2R = 20,000 endpoints into a (65536, 256) table.
//
// Bound on the H100: bytes, mostly the table it writes (64 MiB at 256^3);
// the pairs are few (320,000 at config 4), each ~30 flops after ~135 of
// point set-up.
//
// Design: the plan-and-reduce scheme of K3 and K1e^T (row_reduce.cuh) over
// the (endpoint, pencil) pairs, ids n*16 + 4a + b, sorted by row and cell
// base once per operator, in one launch. All 16 rows are live. A lane
// recomputes the weights of its pair's point with the evaluator that K5
// and K1c use (cubic_eval.cuh), so no per-point weights are stored. The
// row comes from the plan, which the wrapper builds from the same index
// arithmetic; where the edge clamp repeats a row or a tap, the repeated
// pairs and taps each add their share, as the reference's scatter does. No
// float atomics: bitwise reproducible.
#include "cubic_eval.cuh"
#include "row_reduce.cuh"

namespace {

struct CubicPair {
  TableGrid g;
  const float* __restrict__ points;
  const float* __restrict__ cv;
  const float* __restrict__ cg;
  struct In {
    int k;  // pencil 4a + b; -1: no pair
    float x, y, z, v, gx, gy, gz;
  };
  __device__ __forceinline__ In load(int p) const {
    In in;
    if (p < 0) {
      in.k = -1;
      in.x = in.y = in.z = in.v = in.gx = in.gy = in.gz = 0.0f;
      return in;
    }
    const int n = p >> 4;
    in.k = p & 15;
    in.x = __ldg(points + 3 * (size_t)n + 0);
    in.y = __ldg(points + 3 * (size_t)n + 1);
    in.z = __ldg(points + 3 * (size_t)n + 2);
    in.v = __ldg(cv + n);
    in.gx = __ldg(cg + 3 * (size_t)n + 0);
    in.gy = __ldg(cg + 3 * (size_t)n + 1);
    in.gz = __ldg(cg + 3 * (size_t)n + 2);
    return in;
  }
  __device__ __forceinline__ void contributions(const In& in, int (&z)[4],
                                                float (&c)[4]) const {
    if (in.k < 0) {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        z[l] = INT_MAX;
        c[l] = 0.0f;
      }
      return;
    }
    CubicAxis ax, ay, az;
    cubic_axis(in.x, g.ox, g.sx, g.nx, ax);
    cubic_axis(in.y, g.oy, g.sy, g.ny, ay);
    cubic_axis(in.z, g.oz, g.sz, g.nz, az);
    const int a = in.k >> 2, b = in.k & 3;
    float wx = 0.0f, dwx = 0.0f, wy = 0.0f, dwy = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // select without indexing registers
      if (k == a) {
        wx = ax.w[k];
        dwx = ax.dw[k];
      }
      if (k == b) {
        wy = ay.w[k];
        dwy = ay.dw[k];
      }
    }
    const float wxy = wx * wy;
    // the value-weight part and the dz part of the cotangent
    const float s = in.v * wxy + (in.gx / g.sx) * (dwx * wy)
                    + (in.gy / g.sy) * (wx * dwy);
    const float sz = (in.gz / g.sz) * wxy;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      z[l] = az.i[l];
      c[l] = s * az.w[l] + sz * az.dw[l];
    }
  }
};

__global__ void cubic_value_grad_bwd_kernel(
    const float* __restrict__ origin, const float* __restrict__ spacing,
    int nx, int ny, int nz, const float* __restrict__ points,
    const float* __restrict__ cv, const float* __restrict__ cg,
    row_reduce::Plan plan, float* __restrict__ out) {
  extern __shared__ float smem[];
  const CubicPair pair{table_grid(nullptr, origin, spacing, nx, ny, nz),
                       points, cv, cg};
  row_reduce::reduce_segment<4>(plan, nz, smem + (threadIdx.x >> 5) * nz,
                                out, pair);
}

}  // namespace

// points (N, 3); cv (N,); cg (N, 3); the plan over the flat (point, pencil)
// pair ids n*16 + k: order (16 N,), offsets and row_seg (nx*ny+1,), seg_row
// (n_seg_max,), counters (nx*ny,) at zero; partials (n_seg_max, nz)
// scratch; out (nx*ny, nz), fully written.
extern "C" int ionotomo_cubic_value_grad_bwd(
    const float* origin, const float* spacing, int nx, int ny, int nz,
    const float* points, const float* cv, const float* cg, const int* order,
    const int* offsets, const int* seg_row, const int* row_seg, int* counters,
    int n_seg_max, int chunk, float* partials, float* out, void* stream) {
  if (nx < 2 || ny < 2 || nz < 2 || n_seg_max < nx * ny || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const row_reduce::Plan plan{order,    offsets, seg_row,   row_seg, counters,
                              partials, nx * ny, n_seg_max, chunk};
  cubic_value_grad_bwd_kernel<<<row_reduce::blocks_for(n_seg_max),
                                32 * row_reduce::kWarpsPerBlock,
                                row_reduce::smem_bytes(nz),
                                (cudaStream_t)stream>>>(
      origin, spacing, nx, ny, nz, points, cv, cg, plan, out);
  return (int)cudaGetLastError();
}
