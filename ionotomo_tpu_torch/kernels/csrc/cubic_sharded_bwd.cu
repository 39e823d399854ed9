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
// The weights are formed for each entry from its point's u (u = t - base
// of tricubic._neighborhood, which the plan keeps: 16 bytes a point, one
// load), the one weight of each axis the entry needs, in
// _catmull_rom_weights' and _catmull_rom_dweights' operation order (u
// read from the plan measured faster than u formed from the point's
// position, and a first launch writing each owned point's 24 weights to
// scratch slower, on the main path's shapes). The four weights of an
// axis differ in their coefficients only, so a lane forms its tap's
// weight from selected coefficients with no branch on the tap (the lanes
// of a warp hold different taps); a coefficient of -1 or 1 and an added -0 are
// exact, so each weight is the plain version's. Each product, sum and
// quotient is rounded on its own (__fmul_rn / __fadd_rn / __fdiv_rn, never
// contracted to an fma), so the plain PyTorch version
// (parallel/grid_sharding.py:sharded_transpose_ref), which does the same
// operations one tensor op at a time, forms the same numbers.
//
// Summation: the plan (grid_sharding.py:sharded_plan, built once per point
// set and shard, on the shard's device) lists every (owned point, tap)
// entry, as point * 64 + 16a + 4b + l, sorted by its slab cell, stable,
// so a cell's entries are in entry order. A cell's sum
// is a fixed pairwise tree over its entries in plan order: at level k the
// entry of rank r, r = 0 mod 2^(k+1), takes the partial sum of rank
// r + 2^k when r + 2^k < size. The plain version forms it one level at a
// time over all entries at once; here levels 0-4 are shuffles inside a
// warp, and the levels above them the same rule over the cell's aligned
// 32-entry subtree sums, so the two agree bit for bit.
//
// Design (a warp a task, shuffles, no float atomics): the plan's task list
// gives each warp at most 32 consecutive entries, lane i entry i, so the
// reads of the plan are coalesced and every lane forms its term at once.
// A task is either whole cells of at most 32 entries, packed greedily (a
// bit a lane marks the first entry of each cell), whose first lanes add
// their cell's sum into the slab, slab[c] = slab[c] + sum; or one aligned
// 32-entry subtree of a larger cell (the pile-ups where an antenna's rays
// share their first sample, the corner where points outside the grid
// clamp: ~10^5 entries), whose sum goes to scratch. The warp that finishes
// a large cell last (an int atomicAdd on the cell's counter after a
// __threadfence, as in row_reduce.cuh) forms the levels above 4 over its
// subtree sums, 32 a round, adds the cell's sum into the slab and puts the
// counter back to zero: an integer atomic decides who sums, never the
// order of the float adds. The large cells' tasks come first, the cells
// of most subtrees first, so their last warps start early. A warp takes
// one task, or two in a row (tasks_per_warp), whose loads it issues
// before it sums any. One launch.
//
// Bound on the H100: bytes. The function reads each owned point's
// cotangents once and reads and writes each touched cell once; the kernel
// also reads the plan (4 B an entry) and gathers each entry's u (16 B)
// and cotangents, and forms the entry's weights and product.
#include <cuda_runtime.h>

#ifndef CUBIC_SHARDED_BWD_WARPS
#define CUBIC_SHARDED_BWD_WARPS 8
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Subtree sums of a large cell one lane loads at once in a round.
constexpr int kRoundLoads = 8;

// Each point's u and a pad (N, 4), and the grid's spacing [km].
struct Geom {
  const float* __restrict__ u;
  const float* __restrict__ spacing;
};

// The Catmull-Rom weight of offset k - 1 at u (tricubic._catmull_rom_weights:
// 0.5 * ((A u3 + B u2) + C) with (A, B, C) = (-1, 2, -u), (3, -5, 2),
// (-3, 4, u), (1, -1, -0)).
__device__ __forceinline__ float cr_w(float u, int k) {
  const float u2 = __fmul_rn(u, u);
  const float u3 = __fmul_rn(u2, u);
  const float a = k == 0 ? -1.0f : k == 1 ? 3.0f : k == 2 ? -3.0f : 1.0f;
  const float b = k == 0 ? 2.0f : k == 1 ? -5.0f : k == 2 ? 4.0f : -1.0f;
  const float c = k == 0 ? -u : k == 1 ? 2.0f : k == 2 ? u : -0.0f;
  return __fmul_rn(
      0.5f, __fadd_rn(__fadd_rn(__fmul_rn(a, u3), __fmul_rn(b, u2)), c));
}

// Its d/du (tricubic._catmull_rom_dweights: 0.5 * ((A u2 + B u) + C) with
// (A, B, C) = (-3, 4, -1), (9, -10, -0), (-9, 8, 1), (3, -2, -0)).
__device__ __forceinline__ float cr_dw(float u, int k) {
  const float u2 = __fmul_rn(u, u);
  const float a = k == 0 ? -3.0f : k == 1 ? 9.0f : k == 2 ? -9.0f : 3.0f;
  const float b = k == 0 ? 4.0f : k == 1 ? -10.0f : k == 2 ? 8.0f : -2.0f;
  const float c = k == 0 ? -1.0f : k == 2 ? 1.0f : -0.0f;
  return __fmul_rn(
      0.5f, __fadd_rn(__fadd_rn(__fmul_rn(a, u2), __fmul_rn(b, u)), c));
}

// The u of each axis at point n.
__device__ __forceinline__ void point_u(const Geom& g, int n, float& ux,
                                        float& uy, float& uz) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(g.u) + n);
  ux = q.x;
  uy = q.y;
  uz = q.z;
}

// An entry's contribution, its weights formed from its point's u.
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

// Levels 0-4 of the pairwise tree over the lanes: the lane of rank r in
// its run of `size` lanes takes the value of rank r + 2^k at level k when
// r = 0 mod 2^(k+1) and r + 2^k < size. Rank 0 ends with the run's sum.
__device__ __forceinline__ float warp_levels(float v, int rank, int size) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int step = 1 << k;
    const float other = __shfl_down_sync(kFull, v, step);
    if ((rank & (2 * step - 1)) == 0 && rank + step < size)
      v = __fadd_rn(v, other);
  }
  return v;
}

// The levels above 4 of a large cell's tree over its n subtree sums in
// buf (scratch other warps wrote: read through L2): the same rule over
// aligned groups of 32, a round a group of 32 at a time, each round's sums
// written back in place at the group's index (a group's index is below
// every index a later group of the round reads), until one is left. The
// whole warp calls it; lane 0 returns the sum.
__device__ float large_cell_sum(float* buf, int n, int lane) {
  while (n > 32) {
    const int groups = (n + 31) >> 5;
    for (int g0 = 0; g0 < groups; g0 += kRoundLoads) {
      float x[kRoundLoads];
#pragma unroll
      for (int q = 0; q < kRoundLoads; ++q) {
        const int i = (g0 + q) * 32 + lane;
        x[q] = i < n ? __ldcg(buf + i) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kRoundLoads; ++q)
        x[q] = warp_levels(x[q], lane, n - (g0 + q) * 32);
      __syncwarp();  // every lane's loads of the round are done
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < kRoundLoads; ++q)
          if (g0 + q < groups) __stcg(buf + g0 + q, x[q]);
      }
      __syncwarp();
    }
    n = groups;
  }
  return warp_levels(lane < n ? __ldcg(buf + lane) : 0.0f, lane, n);
}

// The plan's task list and large cells (grid_sharding.py:sharded_plan).
// A task (int4): x, y its entries [x, y) in plan order; for whole cells
// z >= 0 the first cell's index among the occupied cells and w a bit a
// lane, set where the lane's entry is a cell's first; for a subtree of a
// large cell z = -1 - l, l the large cell, and w the subtree's index j
// (its entries are the cell's ranks 32j .. 32j + 31).
struct Plan {
  const int* __restrict__ entry;     // (M,) point * 64 + tap
  const int* __restrict__ cells;
  const int4* __restrict__ tasks;
  int n_tasks;
  const int* __restrict__ big_cell;  // (L,) each large cell's slab cell
  const int* __restrict__ big_sub;   // (L + 1,) its first subtree sum
  int* counters;                     // (L,) at zero, left at zero
};

// A task's subtree of large cell l (task.z = -1 - l) done: its sum v
// (lane 0's) to scratch, and the warp that completes the cell sums it.
__device__ __forceinline__ void subtree_done(const Plan& p, int4 task,
                                             float v, float* partial,
                                             float* slab, int lane) {
  const int l = -1 - task.z;
  const int first = __ldg(p.big_sub + l);
  const int n_sub = __ldg(p.big_sub + l + 1) - first;
  if (lane == 0) {
    __stcg(partial + first + task.w, v);
    __threadfence();
  }
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(p.counters + l, 1);
  ticket = __shfl_sync(kFull, ticket, 0);
  if (ticket != n_sub - 1) return;
  __threadfence();
  const float sum = large_cell_sum(partial + first, n_sub, lane);
  if (lane == 0) {
    const int c = __ldg(p.big_cell + l);
    slab[c] = __fadd_rn(slab[c], sum);
    p.counters[l] = 0;
  }
}

// A warp takes kTasks consecutive tasks and issues all their loads before
// it sums any: the tasks, each lane's entry and its point's u and
// cotangents, and, for a lane that begins a whole cell, the cell's slab
// value (no other warp touches that cell). Each task's chain (task ->
// entry -> u -> term -> tree -> slab) is latency; two tasks a warp keep
// more loads in flight but fewer warps resident (the plan picks,
// kernels.k7t_tasks).
template <class Entry, int kTasks>
__global__ void __launch_bounds__(32 * CUBIC_SHARDED_BWD_WARPS)
    cubic_sharded_bwd_kernel(Plan p, Entry entry, float* partial,
                             float* __restrict__ slab) {
  const int lane = threadIdx.x & 31;
  const int q0 =
      (blockIdx.x * CUBIC_SHARDED_BWD_WARPS + (threadIdx.x >> 5)) * kTasks;
  if (q0 >= p.n_tasks) return;  // a whole warp
  int4 task[kTasks];
  float v[kTasks], old[kTasks];
  int cell[kTasks];
#pragma unroll
  for (int k = 0; k < kTasks; ++k)
    task[k] = q0 + k < p.n_tasks ? __ldg(p.tasks + q0 + k)
                                 : make_int4(0, 0, 0, 0);
#pragma unroll
  for (int k = 0; k < kTasks; ++k) {
    const int n = task[k].y - task[k].x;
    const unsigned heads = (unsigned)task[k].w;
    cell[k] = -1;
    old[k] = 0.0f;
    if (task[k].z >= 0 && lane < n && ((heads >> lane) & 1u)) {
      cell[k] = __ldg(p.cells + task[k].z +
                      __popc(heads & ((1u << lane) - 1u)));
      old[k] = slab[cell[k]];
    }
    v[k] = 0.0f;
    if (lane < n) {
      const int e = __ldg(p.entry + task[k].x + lane);
      v[k] = entry(e >> 6, e & 63);
    }
  }
#pragma unroll
  for (int k = 0; k < kTasks; ++k) {
    const int n = task[k].y - task[k].x;
    if (n == 0) continue;  // past the last task: the whole warp
    if (task[k].z < 0) {   // a subtree of a large cell
      subtree_done(p, task[k], warp_levels(v[k], lane, n), partial, slab,
                   lane);
      continue;
    }
    const unsigned heads = (unsigned)task[k].w;
    const unsigned upto = kFull >> (31 - lane);  // lanes 0 .. lane
    const int h = 31 - __clz(heads & upto);      // the cell's first lane
    const unsigned later = heads & ~upto;
    const int end = later ? __ffs(later) - 1 : n;
    const float sum = warp_levels(v[k], lane - h, end - h);
    if (cell[k] >= 0) slab[cell[k]] = __fadd_rn(old[k], sum);
  }
}

template <class Entry>
int launch(const Plan& p, Entry entry, int tasks_per_warp, float* partial,
           float* slab, void* stream) {
  if (p.n_tasks < 1) return (int)cudaErrorInvalidValue;
  const int per_block = CUBIC_SHARDED_BWD_WARPS * tasks_per_warp;
  const int blocks = (p.n_tasks + per_block - 1) / per_block;
  const int threads = 32 * CUBIC_SHARDED_BWD_WARPS;
  cudaStream_t s = (cudaStream_t)stream;
  if (tasks_per_warp == 1)
    cubic_sharded_bwd_kernel<Entry, 1>
        <<<blocks, threads, 0, s>>>(p, entry, partial, slab);
  else if (tasks_per_warp == 2)
    cubic_sharded_bwd_kernel<Entry, 2>
        <<<blocks, threads, 0, s>>>(p, entry, partial, slab);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// slab += K7^T(cv) over the plan: entry (M,) the entries, point * 64 +
// tap, in plan order; cells (U,) the occupied cells; tasks (n_tasks, 4)
// the task list; big_cell (L,), big_sub (L + 1,) and counters (L,) at zero
// (left at zero) the large cells; u (N, 4) each point's u and a pad;
// spacing (3,) the global grid's; cv (N,); tasks_per_warp 1 or 2; partial
// (big_sub[L],) scratch; slab ((loc + 4) * ny * nz,), read and written at
// the plan's cells only.
extern "C" int ionotomo_cubic_sharded_value_bwd(
    const int* entry, const int* cells, const int* tasks, int n_tasks,
    const int* big_cell, const int* big_sub, int* counters, const float* u,
    const float* spacing, const float* cv, int tasks_per_warp,
    float* partial, float* slab, void* stream) {
  const Plan p{entry,    cells,    reinterpret_cast<const int4*>(tasks),
               n_tasks,  big_cell, big_sub, counters};
  return launch(p, ValueEntry{Geom{u, spacing}, cv}, tasks_per_warp, partial,
                slab, stream);
}

// slab += K7^T(cv, cg) over the plan, as above; cg (N, 3) the
// physical-gradient cotangent.
extern "C" int ionotomo_cubic_sharded_value_grad_bwd(
    const int* entry, const int* cells, const int* tasks, int n_tasks,
    const int* big_cell, const int* big_sub, int* counters, const float* u,
    const float* spacing, const float* cv, const float* cg,
    int tasks_per_warp, float* partial, float* slab, void* stream) {
  const Plan p{entry,    cells,    reinterpret_cast<const int4*>(tasks),
               n_tasks,  big_cell, big_sub, counters};
  return launch(p, ValueGradEntry{Geom{u, spacing}, cv, cg}, tasks_per_warp,
                partial, slab, stream);
}
