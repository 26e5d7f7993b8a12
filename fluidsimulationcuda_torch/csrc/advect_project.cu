// K17 advect_project: the tail of vel_step (FluidSequential.c:232-240) in
// one cooperative launch: the u/v self-advection pair under the gather
// window, then the second projection (divergence, pressure sweeps from
// zero, gradient).
//
// Replaces the TPU kernel _ap_kernel
// (fluidsimulationcuda_tpu/kernels/pallas_step.py:95, pallas_call at :299;
// wrapper fused_advect_project :264).  The TPU kernel runs the whole tail
// strip by strip in VMEM, each strip recomputing an iters+3-row margin, so
// that the advected pair, the divergence and the pressure iterates never
// reach HBM.  Here one cooperative launch runs the stages in order, with a
// grid-wide barrier (cooperative_groups grid.sync()) after the gather,
// after the divergence and after each pressure sweep, in one of two forms
// that the launch chooses from the grid's size and the card:
//
// - The resident form keeps the pressure iterate on chip, as the TPU kernel
//   does.  One block per SM owns a fixed band of whole rows of the grid (or
//   of the batch's grids stacked, 16 rows of 2048^2 on 132 SMs), and holds
//   the band's iterate in shared memory, with one halo row above and below,
//   from the first sweep to the gradient.  A sweep reads x_k from shared
//   memory and the rhs from L2: each lane owns two columns of the band and
//   walks down its rows alone, holding x_k of the rows above and at the
//   current one in registers, so it can overwrite each row with x_{k+1} at
//   once; its horizontal neighbours come from the lanes beside it (a
//   shuffle) or, at a warp's edge, from a copy of the neighbouring warps'
//   edge columns taken before the sweep.  So a sweep has no barrier of the
//   block but the copy's.  (A thread cannot hold its share of the band's
//   x_{k+1} until the block has read x_k: 32K values an SM are half the
//   register file, and spilled; a block barrier after each group of rows
//   left the sweep waiting on its loads.)  Blocks exchange only their
//   first and last rows, through a small global buffer in two sets (the
//   set a sweep writes is read after the barrier, and rewritten only two
//   barriers later).  Chebyshev's x_{k-1} does not fit beside x_k on chip,
//   so it stays in a global buffer that each lane reads and rewrites at
//   its own cells (an L2 round trip per sweep).  A band never separates a
//   grid's ghost row from the interior row it derives from (band_start), so
//   a ghost cell reads only its own block's cells.  The form takes a grid
//   of even side up to 2 x kResThreads whose band, with its halo rows and
//   edge columns, fits the block's shared memory.
// - The streaming form keeps the iterates in device memory, where a grid
//   (or batch) too large for the SMs' shared memory must keep them: the
//   1024 x 256^2 datagen batch, 8192^2.  Every block walks 32 x 8 tiles,
//   its tile origins found once and stepped by the grid's stride, never
//   divided out again per cell; at 2048^2 the rhs and the live iterates
//   (3 x 16.8 MB) fit the 50 MB L2 across sweeps.
//
// In both forms the first sweep, from the zero guess, is pointwise,
// (r + 1*0)/4 at each cell's interior cell, so it runs in the divergence
// stage: iters+1 barriers for iters sweeps.
//
// Every stage evaluates the expressions of the kernels it fuses, in their
// order: the gather of K3 (fsc::departure, fsc::blend; border modes 1 and
// 2), the divergence of K2 (mode 0), the sweep of K1 (alpha=1, beta=4 from
// the zero guess, the neighbour sum ((L+R)+U)+D; Chebyshev: the first sweep
// plain, then w from cheby_omegas), the gradient of K2 (modes 1 and 2,
// corners derived).  So in parity mode either form equals advect_windowed
// on the pair followed by fused_project bit for bit.
//
// Bound: device memory.  The function reads u and v once and writes the
// projected pair once (4 field passes); everything between is the launch's
// own traffic, which the roofline does not count.
//
// A grid barrier needs every block resident: the streaming form sizes its
// grid from cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count,
// the resident form launches one block per band, at most one per SM.  A
// launch that cannot be made is refused, never shrunk to a non-cooperative
// one, and a resident launch never falls back to the streaming form.
#include <cooperative_groups.h>

#include "fsc_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxSweeps = 256;  // weights passed by value in the params
constexpr int kThreads = fsc::kBlockX * fsc::kBlockY;  // streaming form
constexpr int kResThreads = 1024;                      // resident form
// Resident sweep: rows whose rhs (and, for Chebyshev, x_{k-1}) are in
// flight, as many as 64 registers a thread hold without spilling.
constexpr int kAheadJacobi = 4;
constexpr int kAheadCheby = 2;
constexpr int kGatherRows = 4;  // resident gather: rows a loop step

enum Form { kAuto = 0, kStreaming = 1, kResident = 2 };

struct ApParams {
  float* uo;   // the projected pair
  float* vo;
  float* au;   // the advected pair
  float* av;
  float* rhs;  // the divergence
  // Streaming: the pressure iterates (p[2] only for Chebyshev).  Resident:
  // p[0] holds x_{k-1} (Chebyshev only).
  float* p[3];
  float* edges;  // resident: two sets of each band's first and last rows
  int side, plane, rows, iters, cmax, nbuf, cheby;
  // Streaming: tiles per row and per grid and in all; a block's stride of
  // gridDim.x tiles as whole grids (sg), tile rows (sty) and tiles (stx).
  int tiles_x, tiles_y, tiles, sg, sty, stx;
  // Resident: the band height before band_start's shift, and the bands.
  int band, bands;
  float dt0, coef, h;
  float w[kMaxSweeps];  // Chebyshev weight of sweep k >= 1 at w[k-1]
};

// ---------------------------------------------------------------------------
// The stages at one cell (i, j) of the grid whose first cell is base
// ---------------------------------------------------------------------------

// Stage 1: the self-advected pair at cell (i, j) (*a, *e, borders
// applied); one backtrace from the pre-advection velocity for both fields
// (FluidSequential.c:232,237).
__device__ __forceinline__ void gather_pair(const float* __restrict__ u,
                                            const float* __restrict__ v,
                                            const ApParams& P, int base,
                                            int i, int j, float* a,
                                            float* e) {
  const int side = P.side, n = side - 2;
  const fsc::Departure d =
      fsc::departure(u + base, v + base, fsc::clampi(i, 1, n),
                     fsc::clampi(j, 1, n), side, P.dt0, P.cmax);
  const int g = base + d.i0 * side + d.j0;
  *a = fsc::border_value(
      fsc::blend(d, u[g], u[g + side], u[g + 1], u[g + side + 1]), i, j,
      side, 1);
  *e = fsc::border_value(
      fsc::blend(d, v[g], v[g + side], v[g + 1], v[g + side + 1]), i, j,
      side, 2);
}

__device__ __forceinline__ void gather_at(const float* __restrict__ u,
                                          const float* __restrict__ v,
                                          const ApParams& P, int base, int i,
                                          int j) {
  float a, e;
  gather_pair(u, v, P, base, i, j, &a, &e);
  const int c = base + i * P.side + j;
  P.au[c] = a;
  P.av[c] = e;
}

// The sweep parameters of pressure sweep k (0-based) from the zero guess;
// xm is x_{k-1} where the Chebyshev combine reads one.
__device__ __forceinline__ fsc::SweepParams sweep_params(const ApParams& P,
                                                         int k,
                                                         const float* xm) {
  const bool combine = P.cheby && k >= 1;
  fsc::SweepParams sp;
  sp.x = nullptr;  // the neighbour sum is taken by the caller
  sp.rhs = P.rhs;
  sp.src = nullptr;
  sp.xm = (combine && k >= 2) ? xm : nullptr;
  sp.alpha = 1.0f;
  sp.beta = 4.0f;
  sp.ab = 0.25f;
  sp.inv_b = 0.25f;
  sp.src_dt = 0.0f;
  sp.w = combine ? P.w[k - 1] : 0.0f;
  sp.flags = combine ? fsc::kCheby : 0;
  return sp;
}

// Stage 2: the divergence of the advected pair at interior cell q (mode 0
// at cell c), and the first pressure sweep from the zero guess at c, which
// needs nothing but the rhs at q.  Returns x_1 at c.
__device__ __forceinline__ float divergence_at(const ApParams& P, int q, int c,
                                               int i, int j) {
  const int side = P.side;
  const float d =
      P.coef * ((P.au[q + 1] - P.au[q - 1]) + (P.av[q + side] - P.av[q - side]));
  P.rhs[c] = fsc::border_value(d, i, j, side, 0);
  const fsc::SweepParams sp = sweep_params(P, 0, nullptr);
  return fsc::border_value(fsc::sweep_update(sp, q, 0.0f, d), i, j, side, 0);
}

// Sweep k >= 1 at cell (i, j): x is x_k indexed so that x[ql] is its value
// at interior cell q.
__device__ __forceinline__ float sweep_at(const fsc::SweepParams& sp,
                                          const float* x, int ql, int q,
                                          int i, int j, int side) {
  const float neigh =
      ((x[ql - 1] + x[ql + 1]) + x[ql - side]) + x[ql + side];
  return fsc::border_value(fsc::sweep_update(sp, q, neigh, sp.rhs[q]), i, j,
                           side, 0);
}

// Last stage: the pressure gradient subtracted from the advected pair at
// cell c, border modes 1 and 2; p[ql] is the pressure at interior cell q.
__device__ __forceinline__ void gradient_at(const ApParams& P, const float* p,
                                            int ql, int q, int c, int i,
                                            int j) {
  const int side = P.side;
  const float un = P.au[q] - (0.5f * (p[ql + 1] - p[ql - 1])) / P.h;
  const float vn = P.av[q] - (0.5f * (p[ql + side] - p[ql - side])) / P.h;
  P.uo[c] = fsc::border_value(un, i, j, side, 1);
  P.vo[c] = fsc::border_value(vn, i, j, side, 2);
}

// The interior cell q that cell (i, j) of the grid at base derives from.
__device__ __forceinline__ int interior_at(int base, int i, int j, int side) {
  return base + fsc::interior_of(i, j, side);
}

// ---------------------------------------------------------------------------
// The streaming form
// ---------------------------------------------------------------------------

// Block b's tiles are b, b + gridDim.x, ...: the first one's grid, tile row
// and tile column are divided out once, then stepped by (sg, sty, stx).
struct TileWalk {
  int g, ty, tx;
};

template <class F>
__device__ __forceinline__ void for_each_tile_cell(const ApParams& P,
                                                   TileWalk w, F&& f) {
  for (int t = blockIdx.x; t < P.tiles; t += gridDim.x) {
    const int i = w.ty * fsc::kBlockY + threadIdx.y;
    const int j = w.tx * fsc::kBlockX + threadIdx.x;
    if (i < P.side && j < P.side) f(w.g * P.plane, i, j);
    w.tx += P.stx;
    if (w.tx >= P.tiles_x) {
      w.tx -= P.tiles_x;
      ++w.ty;
    }
    w.ty += P.sty;
    if (w.ty >= P.tiles_y) {
      w.ty -= P.tiles_y;
      ++w.g;
    }
    w.g += P.sg;
  }
}

// u and v are never written in the launch, so they load through the
// read-only path; the intermediates are written and read back across grid
// barriers, which order them, and are not __restrict__.
__global__ void __launch_bounds__(kThreads, 8)
    advect_project_streaming(const float* __restrict__ u,
                             const float* __restrict__ v, ApParams P) {
  cg::grid_group grid = cg::this_grid();
  const int per_grid = P.tiles_x * P.tiles_y;
  TileWalk w0;
  w0.g = blockIdx.x / per_grid;
  const int r = blockIdx.x - w0.g * per_grid;
  w0.ty = r / P.tiles_x;
  w0.tx = r - w0.ty * P.tiles_x;
  const int side = P.side;
  for_each_tile_cell(P, w0, [&](int base, int i, int j) {
    gather_at(u, v, P, base, i, j);
  });
  grid.sync();
  for_each_tile_cell(P, w0, [&](int base, int i, int j) {
    const int c = base + i * side + j;
    P.p[0][c] = divergence_at(P, interior_at(base, i, j, side), c, i, j);
  });
  grid.sync();
  for (int k = 1; k < P.iters; ++k) {
    const float* x = P.p[(k - 1) % P.nbuf];
    float* out = P.p[k % P.nbuf];
    const fsc::SweepParams sp =
        sweep_params(P, k, k >= 2 ? P.p[(k - 2) % P.nbuf] : nullptr);
    for_each_tile_cell(P, w0, [&](int base, int i, int j) {
      const int q = interior_at(base, i, j, side);
      out[base + i * side + j] = sweep_at(sp, x, q, q, i, j, side);
    });
    grid.sync();
  }
  const float* p = P.p[(P.iters - 1) % P.nbuf];
  for_each_tile_cell(P, w0, [&](int base, int i, int j) {
    const int q = interior_at(base, i, j, side);
    gradient_at(P, p, q, q, base + i * side + j, i, j);
  });
}

// ---------------------------------------------------------------------------
// The resident form
// ---------------------------------------------------------------------------

// The first row of band b among the batch's stacked rows: b * band, moved
// by one where it would part a grid's ghost row from the interior row it
// derives from (a boundary after row 0, or before row side-1, of a grid).
// With band >= 3 no band is empty but perhaps the last, which the host
// drops.
__host__ __device__ __forceinline__ int band_start(int b, int band, int bands,
                                                   int rows, int side) {
  if (b >= bands) return rows;
  const int s = b * band;
  const int i = s % side;
  return i == 1 ? s - 1 : (i == side - 1 ? s + 1 : s);
}

// Thread t of a band's block holds columns j = t + h*kResThreads (h <
// kCols) of every row of the band.  A cell on a grid's ghost ring
// evaluates every stage at its interior cell, which lies a fixed shift
// away: a column (+1 at column 0, -1 at side-1) and a row (+side at a
// grid's row 0, -side at its row side-1), and the border rule follows
// from which shifts are not 0.  A column past the grid's (ok false)
// repeats the last column's loads and stores nothing.
template <int kCols>
struct Cols {
  int j[kCols], dc[kCols];
  bool ok[kCols];
  __device__ explicit Cols(int side) {
#pragma unroll
    for (int h = 0; h < kCols; ++h) {
      const int col = threadIdx.x + h * kResThreads;
      ok[h] = col < side;
      j[h] = ok[h] ? col : side - 1;
      dc[h] = j[h] == 0 ? 1 : (j[h] == side - 1 ? -1 : 0);
    }
  }
};

// The row shift of a cell in row i of its grid.
__device__ __forceinline__ int row_shift(int i, int side) {
  return i == 0 ? side : (i == side - 1 ? -side : 0);
}

// The band's halo rows of the iterate whose edge rows are in set `set`:
// row r0-1 from the band above's last row, row r0+rows from the band
// below's first.
__device__ __forceinline__ void load_halos(const ApParams& P, float* x,
                                           int set, int rows) {
  const int side = P.side, b = blockIdx.x;
  const float* e = P.edges + static_cast<size_t>(set) * P.bands * 2 * side;
  const int below = (rows + 1) * side;
  for (int j = threadIdx.x; j < side; j += kResThreads) {
    if (b > 0) x[j] = e[(2 * b - 1) * side + j];
    if (b + 1 < P.bands) x[below + j] = e[(2 * b + 2) * side + j];
  }
  __syncthreads();
}

// Stores value `val` of band row lr, column j, into the band (row lr at
// shared row lr+1) and, for the band's first and last rows, into edge set
// `set`.
__device__ __forceinline__ void store_band(const ApParams& P, float* x,
                                           int set, int rows, int lr, int j,
                                           float val) {
  const int side = P.side;
  x[(lr + 1) * side + j] = val;
  float* e = P.edges + static_cast<size_t>(set) * P.bands * 2 * side;
  if (lr == 0) e[2 * blockIdx.x * side + j] = val;
  if (lr == rows - 1) e[(2 * blockIdx.x + 1) * side + j] = val;
}

// The row of its grid that band row lr (from band row 0 at grid row i0)
// lies in.
__device__ __forceinline__ int grid_row(int i0, int lr, int side) {
  int i = i0 + lr;
  while (i >= side) i -= side;
  return i;
}

// A sweep: lane l of warp w owns columns c0 = 2*(32w + l) and c0+1 and
// rolls down the band alone, without the block: it holds x_k of rows lr-1
// and lr of its columns in registers, loads row lr+1 from shared memory,
// takes its horizontal neighbours from the lanes beside it (a shuffle of
// their registers) or, at the warp's edges, from a copy of the
// neighbouring warps' edge columns taken before the sweep, and overwrites
// row lr with x_{k+1} at once (no other lane reads its columns' shared
// memory during the sweep).  A grid's ghost row side-1 takes its interior
// row's value, the row before; a ghost row 0 waits for its interior row,
// the row after; ghost columns take their interior column's, the lane's
// other column.  The rhs (and x_{k-1}) of the rows kAhead ahead are in
// flight while a row computes.
struct Lane {
  int c0;      // the lane's first column (even), c0+1 its second
  bool ok;     // c0 < side
  bool gx0;    // c0 is a ghost column (0)
  bool gx1;    // c0+1 is a ghost column (side-1)
};

template <int kCols, bool kCheby>
__global__ void __launch_bounds__(kResThreads, 1)
    advect_project_resident(const float* __restrict__ u,
                            const float* __restrict__ v, ApParams P) {
  constexpr int kAhead = kCheby ? kAheadCheby : kAheadJacobi;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float band[];  // rows r0-1 .. r0+rows of the iterate
  const int side = P.side;
  const int r0 = band_start(blockIdx.x, P.band, P.bands, P.rows, side);
  const int rows =
      band_start(blockIdx.x + 1, P.band, P.bands, P.rows, side) - r0;
  const int i0 = r0 % side;  // band row 0's row in its grid
  const Cols<kCols> C(side);
  // After the band: each warp's left and right neighbour columns, per row.
  float* const edge_cols = band + (rows + 2) * side;

  // The gather: loads for every cell, stores for the grid's (a branch
  // around each cell would hold its loads back).
#pragma unroll kGatherRows
  for (int lr = 0; lr < rows; ++lr) {
    const int i = grid_row(i0, lr, side);
#pragma unroll
    for (int h = 0; h < kCols; ++h) {
      float a, e;
      gather_pair(u, v, P, (r0 + lr - i) * side, i, C.j[h], &a, &e);
      if (C.ok[h]) {
        P.au[(r0 + lr) * side + C.j[h]] = a;
        P.av[(r0 + lr) * side + C.j[h]] = e;
      }
    }
  }
  grid.sync();
  {
    const fsc::SweepParams sp = sweep_params(P, 0, nullptr);
#pragma unroll 4
    for (int lr = 0; lr < rows; ++lr) {
      const int dr = row_shift(grid_row(i0, lr, side), side);
#pragma unroll
      for (int h = 0; h < kCols; ++h) {
        const int g = (r0 + lr) * side + C.j[h];
        const int q = g + dr + C.dc[h];
        const float d = P.coef * ((P.au[q + 1] - P.au[q - 1]) +
                                  (P.av[q + side] - P.av[q - side]));
        const bool gx = C.dc[h] != 0, gy = dr != 0;
        if (C.ok[h]) {
          P.rhs[g] = fsc::border_rule(d, gx, gy, 0);
          store_band(P, band, 0, rows, lr, C.j[h],
                     fsc::border_rule(fsc::sweep_update(sp, q, 0.0f, d), gx,
                                      gy, 0));
        }
      }
    }
  }
  grid.sync();
  load_halos(P, band, 0, rows);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Lane L;
  L.c0 = 2 * static_cast<int>(threadIdx.x);
  L.ok = L.c0 < side;
  if (!L.ok) L.c0 = side - 2;  // repeats the last columns, stores nothing
  L.gx0 = L.c0 == 0;
  L.gx1 = L.c0 + 1 == side - 1;
  const int wfirst = 64 * warp, wlast = wfirst + 63;  // the warp's columns
  float* xm = P.p[0];
  const fsc::SweepParams sp = sweep_params(P, 0, nullptr);
  float2* const band2 = reinterpret_cast<float2*>(band);
  const int side2 = side / 2, c2 = L.c0 / 2;
  for (int k = 1; k < P.iters; ++k) {
    constexpr bool combine = kCheby;
    const bool prev = combine && k >= 2;
    const float w = combine ? P.w[k - 1] : 0.0f;
    float2* const edges2 = reinterpret_cast<float2*>(
        P.edges + (static_cast<size_t>(k % 2) * P.bands + blockIdx.x) * 2 *
                      side);
    // x_{k+1} of band row lr into the band and, for its first and last
    // rows, the edge set.
    auto put = [&](int lr, float2 val) {
      band2[(lr + 1) * side2 + c2] = val;
      if (lr == 0) edges2[c2] = val;
      if (lr == rows - 1) edges2[side2 + c2] = val;
    };
    // The warps' edge columns of x_k, before any lane overwrites them.
    for (int e = threadIdx.x; e < 64 * rows; e += kResThreads) {
      const int wr = e / (2 * rows), side_of = e / rows % 2, lr = e % rows;
      const int col = side_of == 0 ? 64 * wr - 1 : 64 * wr + 64;
      if (col >= 0 && col < side)
        edge_cols[e] = band[(lr + 1) * side + col];
    }
    __syncthreads();
    if (wfirst < side) {
      float2 up = band2[c2];
      float2 cur = band2[side2 + c2];
      float2 raw_b = make_float2(0.0f, 0.0f);  // the row before's raw
      float2 rr[kAhead], mm[kCheby ? kAhead : 1];
      auto fetch = [&](int lr, float2& r, float2& m) {
        const int q = (r0 + lr) * side + L.c0;
        r = *reinterpret_cast<const float2*>(P.rhs + q);
        if (kCheby)
          m = prev ? *reinterpret_cast<const float2*>(xm + q)
                   : make_float2(0.0f, 0.0f);
      };
#pragma unroll
      for (int a = 0; a < kAhead; ++a)
        if (a < rows) fetch(a, rr[a], mm[kCheby ? a : 0]);
      bool held_top = false;  // a ghost row 0 waiting for its row 1
      int i = i0;
      for (int lr0 = 0; lr0 < rows; lr0 += kAhead) {
#pragma unroll
        for (int a = 0; a < kAhead; ++a) {
          const int lr = lr0 + a;
          if (lr >= rows) break;
          const float2 down = band2[(lr + 2) * side2 + c2];
          // Horizontal neighbours of row lr: the lanes beside, or the copy.
          float left = __shfl_up_sync(0xffffffffu, cur.y, 1);
          float right = __shfl_down_sync(0xffffffffu, cur.x, 1);
          if (lane == 0 && wfirst > 0) left = edge_cols[(2 * warp) * rows + lr];
          if (lane == 31 && wlast + 1 < side)
            right = edge_cols[(2 * warp + 1) * rows + lr];
          const float2 r = rr[a], m = mm[kCheby ? a : 0];
          if (lr + kAhead < rows) fetch(lr + kAhead, rr[a], mm[kCheby ? a : 0]);
          float2 raw;
          if (i == side - 1) {  // a grid's ghost row side-1: the row before's
            raw = raw_b;
          } else {
            raw.x = fsc::sweep_update(sp, 0, ((left + cur.y) + up.x) + down.x,
                                      r.x);
            raw.y = fsc::sweep_update(sp, 0, ((cur.x + right) + up.y) + down.y,
                                      r.y);
            if (combine) {
              raw.x = fsc::cheby_combine(w, raw.x, m.x);
              raw.y = fsc::cheby_combine(w, raw.y, m.y);
            }
            // A ghost column evaluates at its interior column, the lane's
            // other one.
            if (L.gx0) raw.x = raw.y;
            if (L.gx1) raw.y = raw.x;
          }
          if (i != 0 && L.ok) {
            if (held_top) {  // the ghost row 0 above takes this row's value
              if (combine)
                *reinterpret_cast<float2*>(xm + (r0 + lr - 1) * side +
                                           L.c0) = up;
              put(lr - 1, make_float2(fsc::border_rule(raw.x, L.gx0, true, 0),
                                      fsc::border_rule(raw.y, L.gx1, true,
                                                       0)));
            }
            if (combine)
              *reinterpret_cast<float2*>(xm + (r0 + lr) * side + L.c0) = cur;
            const bool gy = i == side - 1;
            put(lr, make_float2(fsc::border_rule(raw.x, L.gx0, gy, 0),
                                fsc::border_rule(raw.y, L.gx1, gy, 0)));
          }
          held_top = i == 0;
          raw_b = raw;
          up = cur;
          cur = down;
          i = i + 1 == side ? 0 : i + 1;
        }
      }
    }
    grid.sync();
    load_halos(P, band, k % 2, rows);
  }
#pragma unroll 4
  for (int lr = 0; lr < rows; ++lr) {
    const int dr = row_shift(grid_row(i0, lr, side), side);
#pragma unroll
    for (int h = 0; h < kCols; ++h) {
      const int g = (r0 + lr) * side + C.j[h];
      const int q = g + dr + C.dc[h];
      const int l = (lr + 1) * side + C.j[h] + dr + C.dc[h];
      const float un = P.au[q] - (0.5f * (band[l + 1] - band[l - 1])) / P.h;
      const float vn =
          P.av[q] - (0.5f * (band[l + side] - band[l - side])) / P.h;
      const bool gx = C.dc[h] != 0, gy = dr != 0;
      if (C.ok[h]) {
        P.uo[g] = fsc::border_rule(un, gx, gy, 1);
        P.vo[g] = fsc::border_rule(vn, gx, gy, 2);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

struct Resident {
  int band, bands, max_rows, cols;
  size_t smem;
  bool fits;
};

// The resident form's bands for nb grids of side on `sms` SMs with
// `smem_optin` bytes of shared memory a block: it fits where the block's
// lanes hold a grid's columns two each (side even, at most 2 *
// kResThreads) and the band, with its two halo rows, fits the block's
// shared memory.
Resident plan_resident(int side, int nb, int sms, int smem_optin) {
  Resident r;
  const int rows = nb * side;
  r.cols = side <= kResThreads ? 1 : 2;
  r.band = (rows + sms - 1) / sms;
  if (r.band < 3) r.band = 3;
  r.bands = (rows + r.band - 1) / r.band;
  while (r.bands > 1 &&
         band_start(r.bands - 1, r.band, r.bands, rows, side) >= rows)
    --r.bands;
  r.max_rows = 0;
  for (int b = 0; b < r.bands; ++b) {
    const int len = band_start(b + 1, r.band, r.bands, rows, side) -
                    band_start(b, r.band, r.bands, rows, side);
    if (len > r.max_rows) r.max_rows = len;
  }
  // The band with its halo rows, then each warp's two edge columns.
  r.smem = (static_cast<size_t>(r.max_rows + 2) * side +
            64 * static_cast<size_t>(r.max_rows)) * sizeof(float);
  r.fits = side % 2 == 0 && side <= 2 * kResThreads &&
           r.smem <= static_cast<size_t>(smem_optin) && r.bands <= sms;
  return r;
}

int device_limits(int* sms, int* smem_optin) {
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0)
    err = static_cast<int>(
        cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev));
  if (err == 0)
    err = static_cast<int>(cudaDeviceGetAttribute(
        smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  if (err == 0 && *sms < 1) err = static_cast<int>(cudaErrorInvalidValue);
  return err;
}

// The form of a launch on nb grids of side: `want` kAuto takes the resident
// form where its band fits, kStreaming or kResident asks for that form
// (cudaErrorInvalidValue where the resident band does not fit).  Fills the
// plan's grid and shared memory.
int choose_form(int side, int nb, int want, int* form, Resident* res) {
  int sms = 0, smem_optin = 0;
  const int err = device_limits(&sms, &smem_optin);
  if (err != 0) return err;
  *res = plan_resident(side, nb, sms, smem_optin);
  if (want == kStreaming || (want == kAuto && !res->fits)) {
    *form = kStreaming;
  } else if (want == kResident || want == kAuto) {
    if (!res->fits) return static_cast<int>(cudaErrorInvalidValue);
    *form = kResident;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// The form fsc_advect_project takes for nb grids of side (`want`: 0 the
// launch's choice, 1 streaming, 2 resident): *form is 1 or 2, and
// *edge_floats the floats of the resident form's edge buffer (0 for the
// streaming form).  Returns a cudaError_t: cudaErrorInvalidValue for a
// resident form asked for that does not fit.
extern "C" int fsc_advect_project_form(int side, int nb, int want, int* form,
                                       int* edge_floats) {
  Resident res;
  const int err = choose_form(side, nb, want, form, &res);
  if (err != 0) return err;
  *edge_floats = *form == kResident ? 2 * res.bands * 2 * side : 0;
  return 0;
}

// u, v: nb pre-advection (side, side) velocity grids; uo, vo: the result;
// au, av, rhs: scratch of the same shape; the streaming form also takes p0
// and p1 (and p2 with cheby) of that shape, the resident form p0 (with
// cheby only) and `edges` of fsc_advect_project_form's edge_floats; none
// aliases another.  dt0 = dt*n, coef = -0.5*h and h = 1/n in float32;
// cmax <= 0 gathers exactly.  omegas: the iters-1 Chebyshev weights
// (cheby_omegas) on the host, read only with cheby.  `form` as `want` of
// fsc_advect_project_form, whose answer the caller allocated for.  Returns
// the cudaError_t of the launch.
extern "C" int fsc_advect_project(const float* u, const float* v, float* uo,
                                  float* vo, float* au, float* av, float* rhs,
                                  float* p0, float* p1, float* p2,
                                  float* edges, int side, int nb, int iters,
                                  int cmax, float dt0, float coef, float h,
                                  const float* omegas, int cheby, int form,
                                  void* stream) {
  if (iters < 1 || iters > kMaxSweeps || nb < 1 || side < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  Resident res;
  int chosen = 0;
  int err = choose_form(side, nb, form, &chosen, &res);
  if (err != 0) return err;
  const bool resident = chosen == kResident;
  if (resident ? (edges == nullptr || (cheby && p0 == nullptr))
               : (p0 == nullptr || p1 == nullptr || (cheby && p2 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  ApParams P;
  P.uo = uo;
  P.vo = vo;
  P.au = au;
  P.av = av;
  P.rhs = rhs;
  P.p[0] = p0;
  P.p[1] = p1;
  P.p[2] = p2;
  P.edges = edges;
  P.side = side;
  P.plane = side * side;
  P.rows = nb * side;
  P.iters = iters;
  P.cmax = cmax;
  P.nbuf = cheby ? 3 : 2;
  P.cheby = cheby;
  P.dt0 = dt0;
  P.coef = coef;
  P.h = h;
  for (int k = 0; k < kMaxSweeps; ++k)
    P.w[k] = (cheby && k < iters - 1) ? omegas[k] : 0.0f;
  P.tiles_x = (side + fsc::kBlockX - 1) / fsc::kBlockX;
  P.tiles_y = (side + fsc::kBlockY - 1) / fsc::kBlockY;
  P.tiles = P.tiles_x * P.tiles_y * nb;
  P.band = res.band;
  P.bands = res.bands;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {&u, &v, &P};
  if (resident) {
    const auto kernel =
        cheby ? (res.cols == 1 ? advect_project_resident<1, true>
                               : advect_project_resident<2, true>)
              : (res.cols == 1 ? advect_project_resident<1, false>
                               : advect_project_resident<2, false>);
    int per_sm = 0;
    err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(res.smem)));
    if (err == 0)
      err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kResThreads, res.smem));
    if (err != 0) return err;
    if (per_sm < 1)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    err = static_cast<int>(cudaLaunchCooperativeKernel(
        (void*)kernel, dim3(res.bands), dim3(kResThreads), args, res.smem,
        s));
  } else {
    int sms = 0, smem_optin = 0, per_sm = 0;
    err = device_limits(&sms, &smem_optin);
    if (err == 0)
      err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, advect_project_streaming, kThreads, 0));
    if (err != 0) return err;
    if (per_sm < 1)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const int blocks = P.tiles < per_sm * sms ? P.tiles : per_sm * sms;
    const int per_grid = P.tiles_x * P.tiles_y;
    P.sg = blocks / per_grid;
    P.sty = (blocks - P.sg * per_grid) / P.tiles_x;
    P.stx = blocks - P.sg * per_grid - P.sty * P.tiles_x;
    err = static_cast<int>(cudaLaunchCooperativeKernel(
        (void*)advect_project_streaming, dim3(blocks), fsc::block_dim(), args,
        0, s));
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
