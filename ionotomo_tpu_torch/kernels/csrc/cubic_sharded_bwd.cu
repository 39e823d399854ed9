// K7^T: the transposes of K7 (cubic_sharded.cu) with respect to one shard's
// halo-extended x-slab: a value cotangent cv (N,), and for the value +
// gradient entry a physical-gradient cotangent cg (N, 3), scattered into
// the slab ((loc + 4) * ny, nz) through the 64 taps of every point the
// shard owns, added into the slab it is given.
//
// Replaces: the transpose XLA derives from the shard_map of
// ionotomo_tpu/parallel/grid_sharding.py, interp_sharded and
// interp_sharded_with_grad (:138, :164; the docstring at :194-210): the
// gather's transpose, a scatter into the shard's extended slab; the
// reverse ppermute-add of the halos that follows is plain tensor adds in
// grid_sharding.py.
//
// Contributions: point n, taps a, b, l (x, y, z), with the Catmull-Rom
// weights w* and d/du weights dw* of its global stencil:
//   value:          c = (cv * (wx_a * wy_b)) * wz_l
//   value + grad:   s = (cv * wxy + cgx * (dwx_a * wy_b))
//                       + cgy * (wx_a * dwy_b)
//                   c = s * wz_l + (cgz * wxy) * dwz_l,
//                   wxy = wx_a * wy_b,  cg* = cg / spacing
// The weights are recomputed from the point's position for each entry, as
// K5^T forms them in its body: u = t - base of tricubic._neighborhood,
// then the one weight of each axis the entry needs, in
// _catmull_rom_weights' and _catmull_rom_dweights' operation order (a
// first launch writing each owned point's 24 weights to scratch measured
// slower on the main path's shapes). Each product, sum and quotient
// is rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn,
// never contracted to an fma), so the plain PyTorch version
// (parallel/grid_sharding.py:sharded_transpose_ref), which does the same
// operations one tensor op at a time, forms the same numbers.
//
// Design: plan and reduce, as K3 and K5^T are, without float atomics. The
// plan (grid_sharding.py:sharded_plan, built once per point set and shard,
// on the shard's device) lists the owned points (own (N_own,)) and every
// (owned point, tap) entry e = j * 64 + 16a + 4b + l sorted by its slab
// cell, stable, so a cell's entries are in entry order; cells (U,) are the
// occupied cells, and each cell's entries are cut into blocks of at most
// 2^b (SHARD_BLOCK) from its first. A cell's sum is a fixed pairwise tree
// over its entries in plan order (a binary counter: two partial sums of
// 2^k entries merge as soon as both exist, what is left merges from the
// right), formed in two launches of one entry point: one thread a block
// forms the tree of its entries, then one thread a cell the tree of its
// blocks' sums, and adds it into the slab, slab[cell] = slab[cell] + sum.
// A block of 2^b entries is one of the tree's aligned subtrees, so the two
// passes form the one tree, and the plain version forms it in log2(most
// entries a cell) passes over all entries at once: the two agree bit for
// bit. The blocks bound a thread's serial chain where many stencils meet
// one cell (a corner where points outside the grid are clamped: ~10^5
// entries).
//
// Bound on the H100: bytes. The function reads each owned point's
// cotangents once and reads and writes each touched cell once; the kernel
// also reads the plan (4 B an entry) and the entry's point (12 B), and
// recomputes the entry's weights and product. A cell whose entries are
// many (a stencil clamped at a grid edge or corner, where points outside
// the grid pile up) is one thread's serial chain: the kernel is simple
// first.
#include <cuda_runtime.h>

#ifndef CUBIC_SHARDED_BWD_THREADS
#define CUBIC_SHARDED_BWD_THREADS 128
#endif

namespace {

// Deep enough for 2^32 entries a cell.
constexpr int kStack = 33;

// The global grid: origin and spacing [km] (device pointers) and shape.
struct Geom {
  const float* __restrict__ points;
  const float* __restrict__ origin;
  const float* __restrict__ spacing;
  int nx, ny, nz;
};

// u of one axis: tricubic._neighborhood's t, clamped, less its base.
__device__ __forceinline__ float axis_u(float p, float o, float s, int n) {
  float t = __fdiv_rn(__fsub_rn(p, o), s);
  t = fminf(fmaxf(t, 0.0f), (float)(n - 1));
  const float base = fminf(fmaxf(floorf(t), 0.0f), (float)(n - 2));
  return __fsub_rn(t, base);
}

// The Catmull-Rom weight of offset k - 1 at u (tricubic._catmull_rom_weights).
__device__ __forceinline__ float cr_w(float u, int k) {
  const float u2 = __fmul_rn(u, u);
  const float u3 = __fmul_rn(u2, u);
  float q;
  if (k == 0)
    q = __fsub_rn(__fadd_rn(-u3, __fmul_rn(2.0f, u2)), u);
  else if (k == 1)
    q = __fadd_rn(__fsub_rn(__fmul_rn(3.0f, u3), __fmul_rn(5.0f, u2)), 2.0f);
  else if (k == 2)
    q = __fadd_rn(__fadd_rn(__fmul_rn(-3.0f, u3), __fmul_rn(4.0f, u2)), u);
  else
    q = __fsub_rn(u3, u2);
  return __fmul_rn(0.5f, q);
}

// Its d/du (tricubic._catmull_rom_dweights).
__device__ __forceinline__ float cr_dw(float u, int k) {
  const float u2 = __fmul_rn(u, u);
  float q;
  if (k == 0)
    q = __fsub_rn(__fadd_rn(__fmul_rn(-3.0f, u2), __fmul_rn(4.0f, u)), 1.0f);
  else if (k == 1)
    q = __fsub_rn(__fmul_rn(9.0f, u2), __fmul_rn(10.0f, u));
  else if (k == 2)
    q = __fadd_rn(__fadd_rn(__fmul_rn(-9.0f, u2), __fmul_rn(8.0f, u)), 1.0f);
  else
    q = __fsub_rn(__fmul_rn(3.0f, u2), __fmul_rn(2.0f, u));
  return __fmul_rn(0.5f, q);
}

// The u of each axis at point n.
__device__ __forceinline__ void point_u(const Geom& g, int n, float& ux,
                                        float& uy, float& uz) {
  const float* p = g.points + 3 * (size_t)n;
  ux = axis_u(__ldg(p + 0), __ldg(g.origin + 0), __ldg(g.spacing + 0), g.nx);
  uy = axis_u(__ldg(p + 1), __ldg(g.origin + 1), __ldg(g.spacing + 1), g.ny);
  uz = axis_u(__ldg(p + 2), __ldg(g.origin + 2), __ldg(g.spacing + 2), g.nz);
}

// An entry's contribution, its weights formed from its point's position.
struct ValueEntry {
  Geom g;
  const float* __restrict__ cv;
  __device__ __forceinline__ float operator()(int n, int t) const {
    const int a = t >> 4, b = (t >> 2) & 3, l = t & 3;
    float ux, uy, uz;
    point_u(g, n, ux, uy, uz);
    const float wxy = __fmul_rn(cr_w(ux, a), cr_w(uy, b));
    return __fmul_rn(__fmul_rn(__ldg(cv + n), wxy), cr_w(uz, l));
  }
};

struct ValueGradEntry {
  Geom g;
  const float* __restrict__ cv;
  const float* __restrict__ cg;
  __device__ __forceinline__ float operator()(int n, int t) const {
    const int a = t >> 4, b = (t >> 2) & 3, l = t & 3;
    float ux, uy, uz;
    point_u(g, n, ux, uy, uz);
    const float wx = cr_w(ux, a), wy = cr_w(uy, b);
    const float* c = cg + 3 * (size_t)n;
    const float cgx = __fdiv_rn(__ldg(c + 0), __ldg(g.spacing + 0));
    const float cgy = __fdiv_rn(__ldg(c + 1), __ldg(g.spacing + 1));
    const float cgz = __fdiv_rn(__ldg(c + 2), __ldg(g.spacing + 2));
    const float wxy = __fmul_rn(wx, wy);
    const float dxy = __fmul_rn(cr_dw(ux, a), wy);
    const float xdy = __fmul_rn(wx, cr_dw(uy, b));
    const float s = __fadd_rn(
        __fadd_rn(__fmul_rn(__ldg(cv + n), wxy), __fmul_rn(cgx, dxy)),
        __fmul_rn(cgy, xdy));
    const float sz = __fmul_rn(cgz, wxy);
    return __fadd_rn(__fmul_rn(s, cr_w(uz, l)), __fmul_rn(sz, cr_dw(uz, l)));
  }
};

// The pairwise tree of a run of values, as a binary counter: value(i) for
// i in [0, n) in order; two partial sums of 2^k values merge as soon as
// both exist, and what is left merges from the right. Its result is the
// plain version's tree (sharded_transpose_ref's passes) over the run.
template <class Value>
__device__ __forceinline__ float tree_sum(int n, const Value& value) {
  float stack[kStack];
  int top = 0;
  for (int i = 0; i < n; ++i) {
    stack[top++] = value(i);
    for (unsigned k = (unsigned)i + 1u; (k & 1u) == 0u; k >>= 1) {
      stack[top - 2] = __fadd_rn(stack[top - 2], stack[top - 1]);
      --top;
    }
  }
  float acc = stack[top - 1];
  for (int q = top - 2; q >= 0; --q) acc = __fadd_rn(stack[q], acc);
  return acc;
}

// Pass 1, one thread a block of at most 2^b entries of one cell (the
// plan's blocks start at each cell's first entry and every 2^b entries
// after it): the tree of its entries into partial[block].
template <class Entry>
__global__ void __launch_bounds__(CUBIC_SHARDED_BWD_THREADS)
    block_sums_kernel(const int* __restrict__ order,
                      const int* __restrict__ blocks, int n_blocks,
                      const int* __restrict__ own, Entry entry,
                      float* __restrict__ partial) {
  const int blk = blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= n_blocks) return;
  const int begin = __ldg(blocks + blk);
  partial[blk] = tree_sum(__ldg(blocks + blk + 1) - begin, [&](int i) {
    const int e = __ldg(order + begin + i);
    return entry(__ldg(own + (e >> 6)), e & 63);
  });
}

// Pass 2, one thread an occupied cell: the tree of its blocks' sums, which
// is the tree of its entries (the blocks are the tree's aligned subtrees
// of 2^b leaves), added into the slab.
__global__ void __launch_bounds__(CUBIC_SHARDED_BWD_THREADS)
    cell_sums_kernel(const int* __restrict__ cells,
                     const int* __restrict__ cell_blocks, int n_cells,
                     const float* __restrict__ partial,
                     float* __restrict__ slab) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= n_cells) return;
  const int first = __ldg(cell_blocks + u);
  const float acc = tree_sum(__ldg(cell_blocks + u + 1) - first,
                             [&](int i) { return partial[first + i]; });
  const int c = __ldg(cells + u);
  slab[c] = __fadd_rn(slab[c], acc);
}

struct Plan {
  const int* order;
  const int* cells;
  const int* cell_blocks;
  int n_cells;
  const int* blocks;
  int n_blocks;
  const int* own;
};

template <class Entry>
int launch(const Plan& p, Entry entry, float* partial, float* slab,
           void* stream) {
  if (p.n_cells < 0 || p.n_blocks < p.n_cells)
    return (int)cudaErrorInvalidValue;
  if (p.n_cells == 0) return (int)cudaSuccess;
  const int threads = CUBIC_SHARDED_BWD_THREADS;
  block_sums_kernel<Entry><<<(p.n_blocks + threads - 1) / threads, threads,
                             0, (cudaStream_t)stream>>>(
      p.order, p.blocks, p.n_blocks, p.own, entry, partial);
  cell_sums_kernel<<<(p.n_cells + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(p.cells, p.cell_blocks,
                                             p.n_cells, partial, slab);
  return (int)cudaGetLastError();
}

}  // namespace

// slab += K7^T(cv) over the plan: order (M,) entry ids; cells (U,) and
// cell_blocks (U + 1,) each occupied cell and where its blocks begin;
// blocks (NB + 1,) where each block's entries begin (and M); own (N_own,)
// point ids; points (N, 3); origin, spacing (3,) and nx, ny, nz the global
// grid; cv (N,); partial (NB,) scratch; slab ((loc + 4) * ny * nz,), read
// and written at the plan's cells only.
extern "C" int ionotomo_cubic_sharded_value_bwd(
    const int* order, const int* cells, const int* cell_blocks, int n_cells,
    const int* blocks, int n_blocks, const int* own, const float* points,
    const float* origin, const float* spacing, int nx, int ny, int nz,
    const float* cv, float* partial, float* slab, void* stream) {
  const Plan p{order, cells, cell_blocks, n_cells, blocks, n_blocks, own};
  const Geom g{points, origin, spacing, nx, ny, nz};
  return launch(p, ValueEntry{g, cv}, partial, slab, stream);
}

// slab += K7^T(cv, cg) over the plan, as above; cg (N, 3) the
// physical-gradient cotangent.
extern "C" int ionotomo_cubic_sharded_value_grad_bwd(
    const int* order, const int* cells, const int* cell_blocks, int n_cells,
    const int* blocks, int n_blocks, const int* own, const float* points,
    const float* origin, const float* spacing, int nx, int ny, int nz,
    const float* cv, const float* cg, float* partial, float* slab,
    void* stream) {
  const Plan p{order, cells, cell_blocks, n_cells, blocks, n_blocks, own};
  const Geom g{points, origin, spacing, nx, ny, nz};
  return launch(p, ValueGradEntry{g, cv, cg}, partial, slab, stream);
}
