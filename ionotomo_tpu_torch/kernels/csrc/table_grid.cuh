// A field model's (nx*ny, nz) row-gather table and the grid it lives on,
// shared by the zp evaluator (zp_eval.cuh) and the tricubic evaluator
// (cubic_eval.cuh).
#pragma once

#include <cuda_runtime.h>

struct TableGrid {
  const float* __restrict__ coef;  // (nx*ny, nz) table; null where unused
  float ox, oy, oz;                // origin [km]
  float sx, sy, sz;                // spacing [km]
  int nx, ny, nz;
};

// Reads origin and spacing from two (3,) device vectors.
static __device__ __forceinline__ TableGrid table_grid(const float* coef,
                                                       const float* origin,
                                                       const float* spacing,
                                                       int nx, int ny,
                                                       int nz) {
  TableGrid g;
  g.coef = coef;
  g.ox = __ldg(origin + 0);
  g.oy = __ldg(origin + 1);
  g.oz = __ldg(origin + 2);
  g.sx = __ldg(spacing + 0);
  g.sy = __ldg(spacing + 1);
  g.sz = __ldg(spacing + 2);
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  return g;
}
