// K4 dens_advect: the last density sweep and the advection gather in one
// launch.
//
// Replaces the TPU kernel _dens_fused_kernel
// (fluidsimulationcuda_tpu/kernels/pallas_ops.py:1211, pallas_call at
// :1480; wrapper fused_dens_advect :1424), the whole dens_step of
// FluidSequential.c:176-186.  The wrapper runs the first iters-1 sweeps
// with K1; this kernel evaluates the last sweep (with the Chebyshev combine
// and the derived border rule at ghost and corner points) at the gather
// points of each cell's departure point and blends them.  The diffused
// field is never written to device memory, which is what the TPU fusion
// (pallas_ops.py:1219-1234) existed for.  The departure point is exact for
// cmax <= 0 and window-clamped to cmax cells otherwise, as K3's
// (fsc_common.cuh: departure).  A launch takes a batch of grids, one per
// grid layer, as K1 does.
//
// Bound: not HBM (5 field passes, 6 with Chebyshev) but loads, their
// latency, and stencil work.  Evaluated at each of its four gather points,
// the last sweep costs a cell ~26 loads (x_{K-1}'s four neighbours, rhs,
// src in the first sweep, x_{K-2} with Chebyshev) and four stencil
// evaluations, and the neighbouring cells' gather points overlap, so a
// block loads each x_{K-1} value ~16 times and sweeps each cell ~4 times.
//
// The staging sweeps each cell once per block.  Phase 1: every thread finds
// its departure (coalesced u, v) and the block reduces the lower gather
// corners to a box, the footprint of the block's gathers (block_max).
// Phase 2: if the box fits kBoxCap, the block sweeps each box cell once
// into shared memory, consecutive threads on consecutive cells of a box row
// (coalesced x_{K-1}, rhs, src, x_{K-2}).  Phase 3: each thread blends its
// four points from shared memory.  In the window (cmax >= 1) the box is at
// most (8 + 2*cmax + 1) x (32 + 2*cmax + 1), which fits for cmax <= 6; an
// exact gather's box is what the flow gives.  A block whose box exceeds the
// cap (one astride a jump of the flow) sweeps at its gather points as
// before, in the same launch.  Both paths evaluate the same float
// expressions in the same order (--fmad=false), so the result is the same
// bit for bit whichever path a block takes.
//
// What the design keeps from measurement on the H100 (PERF.md): the barrier
// between phases leaves latency to hide, so the kernel is held to 32
// registers for eight resident blocks (__launch_bounds__), and a thread
// sweeps one box cell at a time (sweeping two or three at once, for more
// loads in flight, took registers and was slower); the box's row index is
// a float product, not an integer division, and the reduction two
// redux.sync a value, not a scan of the warps' maxima (the two together
// took 29% off).  A 32 x 16 or 32 x 4 tile was slower, as was a box fixed
// by the window in place of the reduction.
//
// Measured on the H100, staging pays where the sweep divides: -9% a launch
// in the 2048² step, -21% on the datagen batch, and faster on a density
// blob with zeros and subnormals far from it, but not on random fields.
// The likely cause is the IEEE division's slow path on such values, which
// staging takes ~1.2 times a cell instead of 4.  The fast mode's sweep is
// one fmaf and does not divide; there the staging's barriers cost more
// than it saves (+8% in both steps), so fsc_dens_advect launches today's
// kernel, without the staging, for it.
//
// The cap is 4 x the tile: at that size staging sweeps as many cells as
// the direct path's four evaluations per cell, so a larger box gains
// nothing.  It takes 4 KB of shared memory, which leaves a full SM's eight
// blocks resident.
#include "fsc_common.cuh"

namespace {

constexpr int kRows = 8;  // the tile: kBlockX columns by kRows rows
constexpr int kThreads = fsc::kBlockX * kRows;
constexpr int kWarps = kThreads / 32;
constexpr int kBoxCap = 4 * kThreads;
// A thread with no cell to gather gives this to every block_max.
constexpr int kNoCell = -(1 << 30);

// The CPU rehearsal (dev/rehearse_kernels_cpu.py) defines this hook to count
// the blocks that stage their footprint and those that take the direct
// path; on the card it is empty.
#ifndef FSC_BLOCK_PATH
#define FSC_BLOCK_PATH(direct)
#endif

// Each v[q] replaced by its maximum over the block (a minimum is the
// maximum of the negated values): one redux.sync per warp, the warps'
// maxima through scratch, and a second redux.sync over them.  Every thread
// of the block must call it.
template <int N>
__device__ __forceinline__ void block_max(int (&v)[N],
                                          int (&scratch)[N][kWarps]) {
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  for (int q = 0; q < N; ++q) v[q] = __reduce_max_sync(0xffffffffu, v[q]);
  if (lane == 0)
    for (int q = 0; q < N; ++q) scratch[q][warp] = v[q];
  __syncthreads();
  for (int q = 0; q < N; ++q)
    v[q] = __reduce_max_sync(0xffffffffu, scratch[q][lane % kWarps]);
}

// The last sweep's value at padded cell (gi, gj) of the grid that starts at
// cell off of the batch, border derived.
__device__ __forceinline__ float swept_at(const fsc::SweepParams& p,
                                          int off, int gi, int gj,
                                          int side, int b) {
  const int c = off + fsc::interior_of(gi, gj, side);
  const float val = fsc::sweep_at(p, c, side, fsc::rhs_at(p, c));
  return fsc::border_value(val, gi, gj, side, b);
}

// Today's kernel without the staging: each thread sweeps at its four
// gather points.  The fast mode takes it (see fsc_dens_advect).
__global__ void dens_advect_kernel(fsc::SweepParams p,
                                   const float* __restrict__ u,
                                   const float* __restrict__ v,
                                   float* __restrict__ out, int side, int b,
                                   float dt0, int cmax) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= side || j >= side) return;
  const int n = side - 2;
  const int off = fsc::grid_offset(side);
  const fsc::Departure d =
      fsc::departure(u + off, v + off, fsc::clampi(i, 1, n),
                     fsc::clampi(j, 1, n), side, dt0, cmax);
  const float g00 = swept_at(p, off, d.i0, d.j0, side, b);
  const float g10 = swept_at(p, off, d.i0 + 1, d.j0, side, b);
  const float g01 = swept_at(p, off, d.i0, d.j0 + 1, side, b);
  const float g11 = swept_at(p, off, d.i0 + 1, d.j0 + 1, side, b);
  out[off + i * side + j] =
      fsc::border_value(fsc::blend(d, g00, g10, g01, g11), i, j, side, b);
}

__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
    dens_advect_staged_kernel(fsc::SweepParams p, const float* __restrict__ u,
                              const float* __restrict__ v,
                              float* __restrict__ out, int side, int b,
                              float dt0, int cmax) {
  __shared__ float staged[kBoxCap];
  __shared__ int scratch[4][kWarps];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const bool live = i < side && j < side;
  const int n = side - 2;
  const int off = fsc::grid_offset(side);
  fsc::Departure d = {};
  if (live)
    d = fsc::departure(u + off, v + off, fsc::clampi(i, 1, n),
                       fsc::clampi(j, 1, n), side, dt0, cmax);
  // The box: rows [r0, r0 + h), columns [c0, c0 + w).
  int lim[4] = {kNoCell, kNoCell, kNoCell, kNoCell};
  if (live) {
    lim[0] = -d.i0;
    lim[1] = d.i0;
    lim[2] = -d.j0;
    lim[3] = d.j0;
  }
  block_max(lim, scratch);
  const int r0 = -lim[0];
  const int c0 = -lim[2];
  const int h = lim[1] + 2 - r0;
  const int w = lim[3] + 2 - c0;
  float val;
  if (h * w <= kBoxCap) {
    FSC_BLOCK_PATH(false);
    // Box cell q (row-major) is thread q % kThreads's.  Its row is
    // (q + 0.5) / w rounded down, in float: q and w are at most kBoxCap, so
    // the float error stays under the distance 0.5 / w to an integer.
    const float inv_w = 1.0f / static_cast<float>(w);
    for (int q = threadIdx.y * blockDim.x + threadIdx.x; q < h * w;
         q += kThreads) {
      const int r = static_cast<int>((static_cast<float>(q) + 0.5f) * inv_w);
      staged[q] = swept_at(p, off, r0 + r, c0 + q - r * w, side, b);
    }
    __syncthreads();
    if (!live) return;
    const float* g = staged + (d.i0 - r0) * w + (d.j0 - c0);
    val = fsc::blend(d, g[0], g[w], g[1], g[w + 1]);
  } else {
    FSC_BLOCK_PATH(true);
    if (!live) return;
    val = fsc::blend(d, swept_at(p, off, d.i0, d.j0, side, b),
                     swept_at(p, off, d.i0 + 1, d.j0, side, b),
                     swept_at(p, off, d.i0, d.j0 + 1, side, b),
                     swept_at(p, off, d.i0 + 1, d.j0 + 1, side, b));
  }
  out[off + i * side + j] = fsc::border_value(val, i, j, side, b);
}

}  // namespace

// The sweep arguments (x .. flags) are those of fsc_jacobi_sweep for the
// last sweep; every pointer holds nb grids of side^2 cells; cmax <= 0
// gathers exactly.  Returns cudaGetLastError() after the launch.
extern "C" int fsc_dens_advect(const float* x, const float* rhs,
                               const float* src, const float* xm, float alpha,
                               float beta, float ab, float inv_b, float src_dt,
                               float w, int flags, const float* u,
                               const float* v, float* out, int side, int nb,
                               int b, float dt0, int cmax, void* stream) {
  const fsc::SweepParams p = fsc::make_sweep_params(
      x, rhs, src, xm, alpha, beta, ab, inv_b, src_dt, w, flags);
  const auto launch = static_cast<cudaStream_t>(stream);
  if (flags & fsc::kFast) {
    dens_advect_kernel<<<fsc::grid_dim(side, nb), fsc::block_dim(), 0,
                         launch>>>(p, u, v, out, side, b, dt0, cmax);
  } else {
    const dim3 grid((side + fsc::kBlockX - 1) / fsc::kBlockX,
                    (side + kRows - 1) / kRows, nb);
    dens_advect_staged_kernel<<<grid, dim3(fsc::kBlockX, kRows), 0,
                                launch>>>(p, u, v, out, side, b, dt0, cmax);
  }
  return static_cast<int>(cudaGetLastError());
}
