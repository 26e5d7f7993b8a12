// K1 jacobi_sweeps: up to kMaxSweeps Jacobi (or Chebyshev) sweeps of one
// solve per launch, in shared-memory tiles, on a batch of padded grids.
//
// Replaces the TPU kernel _jacobi_kernel
// (fluidsimulationcuda_tpu/kernels/pallas_ops.py:301, pallas_call at :645 in
// _fused_jacobi_call), which runs up to max_fused = 20 sweeps per VMEM
// round-trip on row strips with margins max_fused deep (fused_jacobi
// :514-600).  It is the sweep engine of fused_jacobi, fused_jacobi_pair,
// fused_project's pressure solve and the density step before K4 (or before
// K3 in bf16).  The per-sweep K1 (jacobi.cu) computes the same sweeps one
// launch each; this kernel computes what `count` of its launches compute,
// bit for bit: the same expressions in the same order (--fmad=false, fmaf
// only in fast mode), the border derived from the interior neighbour's new
// value in the same sweep, x_{k-1} read only at its own cell.
//
// Bound: a solve must read its guess (none for the zero guess) and its rhs
// or base (the folded source is the guess) and write its result once, 8-12
// bytes a float32 cell (6 in bf16), and do 6-12 float operations a cell
// each sweep (kernels/checks.py, _sweeps_cost): at 20 sweeps on 2048^2
// bytes bind in float32 (0.0150 ms), operations in bf16 (0.0076 ms).  One
// launch a sweep (jacobi.cu) moves x, rhs and x_{k-1} through L2 or HBM
// every sweep, 10-16 bytes a cell, and runs such a solve at 1-5% of that
// bound.
//
// Design: a block of 32 x 16 threads owns an output tile and loads it with
// a halo `margin` cells deep into a 128 x 64 tile of shared memory, two
// float32 buffers (x_k is read while x_{k+1} is written); two blocks fit an
// SM.  A thread keeps the rhs of its 16 cells (4 columns 32 apart, 4 rows
// 16 apart) in registers, and for Chebyshev their x_{k-1}, so a sweep
// reads four neighbours from shared memory and writes one value a cell, a
// warp one row.  The loads come in one pass an operand with addresses
// clamped into the grid, free of branches that depend on the cell, so a
// thread's loads are in flight together (branching on each cell, as a
// first form did, left them one at a time: 0.222 against 0.190 ms for the
// 2048^2 20-sweep solve, PERF.md).  Each sweep leaves one more ring of the
// halo stale, so after `count` sweeps the tile less `count` cells on each
// side is exact; rows past the valid band are skipped.  A ghost cell of
// the grid takes the border rule of its interior neighbour's new value
// after a barrier, in the blocks whose tile holds a ghost row or column
// only.  The launch writes its output tile: x_count (bf16 only where it
// ends a bf16 solve), x_{count-1} as float32 where a Chebyshev chain goes
// on, and in the first launch of a folded or fast solve the rhs it built,
// for the launches after it (the trap of pallas_ops.py:550-559).  A solve
// of `iters` sweeps takes ceil(iters / T) launches (cuda_ops.sweep_plan,
// T = cuda_ops.SWEEPS_PER_LAUNCH = 10 by measurement).  The halo costs
// loads and sweeps: 128 x 64 / ((128 - 2T)(64 - 2T)) = 1.72 cells a cell
// kept at T = 10; a 128 x 128 tile (one block an SM) measured slower at
// 2048^2 and on the 256^2 batch and 4% faster at 8192^2 (PERF.md), and a
// thread owning 4 consecutive rows of a column with its own values in
// registers (two shared-memory reads a cell in place of four) measured
// slower: it spills at the 64 registers two blocks an SM allow (0.224
// against 0.192 ms).
//
// K9 jacobi_slab_sweeps: the same tiles on a row slab's (rows, side)
// halo-extended buffer (fsc_jacobi_slab_sweeps).  Replaces the TPU kernel
// _jacobi_slab_kernel (fluidsimulationcuda_tpu/kernels/pallas_sharded.py:
// 131, pallas_call at :290 in fused_jacobi_slab), which runs every sweep of
// a halo exchange in VMEM, strip by strip, each strip with its whole K-row
// margin, and is the sweep engine of the slab projection (B9b, :700), the
// slab density step (B9c, :1010) and the sweeps after the first of the
// split-operand slab Jacobi (B13, :506).  The per-sweep K9 (jacobi_slab.cu)
// computes the same sweeps one launch each; a launch here computes what
// `count` of its launches compute, bit for bit on the rows they leave
// exact: sweep k of the solve (from 1) computes buffer rows [k, rows - k),
// so after `done` sweeps x is exact on [done, rows - done) and a launch
// writes the band [done + count, rows - done - count).  The wall ghost rows
// gtop and gbot (-1 when absent) and the ghost columns take the border rule
// of their interior neighbour's new value in the same sweep, as the
// per-sweep K9 derives them (fsc::slab_row_of, slab_border_value); rows
// beyond a wall never reach a valid cell.  Loads clamp into the buffer; a
// tile row past the band is not written.  Float32 only, as the slab route
// of the JAX package.
//
// Bound: as K1's, a solve reads its guess (none for the zero guess) and
// its rhs once over the buffer and writes the band of its last sweep once
// (kernels/checks.py, _slab_sweeps_cost): 0.0021 ms for the 20-sweep solve
// on a 304-row buffer of 2048^2 (bytes), 0.061 ms on a 2096-row buffer of
// 8192^2.  One launch a sweep moves x, rhs and x_{k-1} through L2 or HBM
// every sweep and leaves the thin buffers of the 8-slab step to the launch
// latency: 3-5% of the bound.  Here a launch of T sweeps loads each tile
// once with a T-row and T-column halo, so a solve's launches fall by T and
// its traffic to about 1/T; the tiles start at the band's first row.  A
// buffer of a few slab rows (304 x 2048) is one partial wave of K1's
// 128 x 64 tiles, one block an SM, so the tile's height is a template
// parameter: 32 rows at T = 5 there (twice the blocks: 1.68x the
// per-sweep chain against 1.33x), 64 at T = 8 from 2 M buffer cells
// (3.33x at 8192^2, 11.6% of the bound), as cuda_ops.slab_tiling picks by
// measurement (PERF.md).  A wall row at the last output row of a tile
// (gtop) or at the first (gbot), like a ghost column at a tile's first
// output column, would derive from a row the tile's halo leaves stale:
// such a launch takes a halo one cell deeper, as K1 does for its last
// ghost line (plan_slab).
//
// K1-damp jacobi_damped_sweeps: the multigrid smoother, damped Jacobi
// x <- (1-w)*x + w*S(x) (w = 0.8, ops/multigrid.py), on the same tiles
// (fsc_jacobi_sweeps_damp).  Replaces the damped mode of the TPU kernel
// (pallas_ops.py:432-459, the smooth of ops/multigrid.py:232-239 there,
// fused_jacobi with `damp`), which runs a smooth's sweeps in one fused
// call.  The per-sweep K1's damped form (jacobi.cu, jacobi_sweep_kernel
// <true>) computes the same sweeps one launch each; a launch here computes
// what `count` of its launches compute, bit for bit: each sweep takes
// omw*x_k + w*val in that order, x_k the cell's own value in the tile (0
// for the zero guess), omw = 1-w rounded once on the host from the double
// 1 - 0.8, and a ghost cell takes the border rule of its interior
// neighbour's damped value.  No fold, fast mode or Chebyshev, as the
// smoother calls it.  Float32, and two bf16-rhs forms for the finest level
// of a bf16 multigrid solve (fsc_jacobi_sweeps_damp_bf16; JAX smooths that
// level in jnp, ops/multigrid.py:266 there): the rhs read as bf16, the
// iterate float32 in the tile.  From zero or a bf16 guess, w and 1-w
// rounded to bf16 on the host (JAX's _smooth takes them in p's dtype) and
// the result rounded to bf16 once, at the store, where JAX's jnp sweeps
// round every operation (ROADMAP §C); from a float32 guess, the float32
// arithmetic of JAX's _smooth on it, bit for bit.  A solve split over
// launches keeps its iterate float32 between them.  The per-sweep form
// has no bf16 one.
//
// Bound: a smooth reads its guess (none from zero) and its rhs and writes
// its result once, 8-12 bytes a cell, and does 9 float operations a cell
// a sweep: 0.0150 ms for a 2-sweep smooth at 2048^2 (bytes), where the
// per-sweep form's two launches each read x and rhs and write x; the bf16
// forms 4 bytes a cell from zero (0.0050 ms) and 10 from a float32 guess
// (0.0125 ms).  Below
// 1024^2 a level's smooth is latency, a launch and a few dependent passes
// through a block, and 40 launches of the per-sweep form for the coarsest
// 16^2 solve are latency alone.
//
// Design, by measurement on the H100 (PERF.md, dev/bench_smooth.py; the
// route is cuda_ops.damped_plan).  A smooth of 2 sweeps is one launch on
// tiles with a halo 2 deep: 128 x 64 tiles from 2 M cells a launch
// (2048^2, 64 x 256^2: 1.1-1.9x the per-sweep pair), 128 x 16 below (4
// cells a thread: the 64-row tile's 16 a thread made a level's few blocks
// the whole launch's latency, 8 us at 512^2 and below against the pair's
// 3-5; 1.1-1.3x the pair at 1024^2 and 512^2, 0.71-0.98x from 256^2 down,
// where one launch still beats two in the eager step; 128 x 32 tiles
// measured between the two and are not built).  A small level's
// tiles reach past its grid, so K1-damp sweeps only the tile's lines in
// the grid.  A grid that one block's 128 x 32 tile holds whole (side up
// to 30, the coarsest 16^2 level) runs every sweep of its solve in one
// launch (WholeGrid, a grid a batch's z layer): the grid sits at tile cell
// (1, 1), since the ghost bit leaves the tile's outer ring out; every grid
// line is exact after every sweep, its ghost ring derived from its own
// interior, so the sweep range stays the whole grid for any count (the
// tiled form's range shrinks a line a sweep at each end, which would leave
// the grid's ghost rows stale from the second sweep on).  The 40 sweeps at
// 16^2 take 0.025 ms against 0.055 for 40 per-sweep launches; the 128 x 64
// tile took 0.030 there, and 0.0054 ms against 0.0040 on 16-row tiles for
// a 32^2 smooth.
//
// K9-damp jacobi_slab_damped_group: the multigrid smoother on row slabs
// (fsc_jacobi_slab_sweeps_damp_group), K1-damp's damped body on K9's slab
// walk (SlabTiles: the band, the wall rows gtop and gbot, the deeper halo
// of plan_slab), every slab of a device in one launch, slab blockIdx.z.
// It replaces no Pallas kernel: the JAX package smooths the fine level of
// its sharded multigrid in jnp (_mg_smooth_local,
// fluidsimulationcuda_tpu/parallel/sharded.py:477), one sweep per one-row
// halo exchange.  Here a smooth of `count` sweeps is one launch over
// slabs whose halo is `count` rows deep, and computes what that many
// exchanges and sweeps compute on each slab's rows, bit for bit (the
// plain twin, cuda_sharded.smooth_slabs_plain, equals
// ops.multigrid._smooth on the whole grid there): omw*x_k + w*val in that
// order, the wall rows and ghost columns by the border rule of their
// interior neighbour's damped value.  Float32, no fold, fast mode or
// Chebyshev.
//
// Bound: a smooth reads every slab's guess (none from zero) and rhs once
// and writes its result once, and does 9 float operations a cell a sweep
// (kernels/checks.py, _group_cost): 0.0150 ms for the 2-sweep smooth over
// 2048^2 (bytes).  What bounded a launch a slab on its halo-extended
// buffer was latency: each slab's smooth was one partial wave, 8 launches
// of 0.0061 ms and 8 torch.cat halo copies a smooth on 8 slabs of 2048^2.
// Here the launch's tiles cover every slab, and a tile loads buffer row r
// of its slab's (m + 2*count)-row buffer from one of three row sources
// (SplitSlabTiles, K18's split_row in the tile load): the neighbour
// above's own last `count` rows, the slab, the neighbour below's first
// `count` rows, each a pointer into that slab's array (or into a copy
// where it lies on another device; null, zero rows, beyond a wall), so
// no extended slab is built.  The slabs' pointers and wall rows travel in
// the kernel's parameters (SlabGroup), captured with the launch by a CUDA
// graph.  Every index is SlabTiles', so a launch computes what the tiled
// sweeps compute on the concatenated buffer, bit for bit; a smooth of
// more sweeps than a launch takes runs in several, each reading its
// neighbours' rows as the last left them (a fresh exchange).  The tile by
// measurement (cuda_ops.group_smooth_tiling, PERF.md): 32 rows over
// 2048^2 (0.0353 ms on 8 slabs, 42.6% of the bound), 64 over 8192^2.
//
// B13 split-source (fsc_jacobi_slab_sweeps_split): the tiled K9's first
// launch of a solve whose extended slab comes as three operands (top
// halo, slab, bottom halo; fused_jacobi_slab_split, pallas_sharded.py:473,
// pallas_call :506).  K18 (jacobi_slab_split.cu) ran that solve's first
// sweep one cell a thread from the three operands and left the other
// sweeps to K9 launches on the buffers it wrote, which lost to two
// torch.cat and K9 at 8192^2 (0.652 against 0.625 ms).  Here the first
// launch runs T sweeps in the shared-memory tiles, loading them through
// the same row sources, and writes x_T and the rhs it read (pre-scaled in
// fast mode) on its band of the extended buffers, which the later tiled
// launches read: bit for bit K9 on the concatenation.  Jacobi, fast mode
// and the zero guess, as JAX's B13; no Chebyshev form.
//
// K9-block jacobi_block_sweeps: the tiled sweeps on an extended 2-D block
// (fsc_jacobi_block_sweeps), the block route of the multi-device step.  It
// replaces no Pallas kernel: the JAX package sweeps its blocks in jnp
// (_diffuse_local, _cheby_diffuse_local and _mg_smooth_local,
// fluidsimulationcuda_tpu/parallel/sharded.py:195, :348, :477), a chunk of
// K sweeps on an (m + 2K, k + 2K) block extended by the two-phase halo
// exchange, whose interior and ghost cells follow from global coordinates.
// Here a chunk is one launch on that buffer (BlockTiles: its cell (0, 0)
// is global cell (gr0, gc0), its output the (m, k) block at buffer cell
// (K, K)): the tiles cover the block with a halo of `count` cells, the
// interior update at every tile cell, then the border rule at whatever
// global ghost cells fall in the tile, each from its interior neighbour's
// new value (a corner from the diagonal cell, 0.5*(sy*v + sx*v), which is
// 0.5*(edge + edge) of the edges just written), so a launch computes what
// the chunk computes on the block's cells, bit for bit.  A ghost line of
// the grid derives from a line the sweeps reach one sweep later than
// their own, so a launch whose buffer holds one takes a halo one cell
// deeper (plan_block), wherever the line lies in the tile.  The forms are
// K9's: Jacobi, the reciprocal form (the rhs pre-scaled in every launch,
// since each chunk reads the solve's one extended rhs), Chebyshev with
// x_{k-1} carried in and out across chunks (sweep 0 of the solve plain),
// and K1-damp's damped form for the multigrid smoother.  Float32, and
// bf16 forms of each (fsc_jacobi_block_sweeps_bf16): every operand bf16,
// widened at the tile's loads; the iterate stays float32 through the
// chunk's sweeps and x_count (and a Chebyshev chunk's x_{count-1}) round
// to bf16 at the store, so a block solve rounds once a chunk, where JAX's
// jnp sweeps round every operation (ROADMAP §C).  Between chunks the halo
// exchange moves bf16 blocks, as JAX's _extend_deep does.
//
// K9-block grouped jacobi_block_group: the same chunk on every block of a
// device in one launch (fsc_jacobi_block_group, and _bf16), block
// blockIdx.z, the path of every block solve since the per-block launch
// above, which stays as the form it is held against.  It replaces the same
// jnp chunks.  A launch a block on its extended buffer was a partial wave
// (1040 x 528 cells at 2048^2 on (2, 4): 320 blocks of 512 threads) after
// two torch.cat phases a chunk (Blocks.ext), which took 26-48% of the block
// steps' device time.  Here no extended block exists: a tile's load of
// buffer cell (r, c), clamped as BlockTiles clamps it, reads global cell
// (gr0 + r, gc0 + c) from the array that owns it, the block's or one of its
// eight neighbours' (a copy of the neighbour's strip where it lies on
// another device; zero beyond a wall), found from the line's place against
// the halo K and the block's sides (GroupBlockTiles, the table GroupBlock
// in the kernel's parameters), so a launch computes, bit for bit, what the
// per-block launch computes on Blocks.ext's buffer, and each chunk reads
// its neighbours as the chunk before left them.
//
// Bound: a chunk reads every block's guess (none from zero), rhs and, in a
// chained Chebyshev chunk, x_{k-1} once and writes x (and x_{k-1}) once:
// 0.01502 ms for the 8-sweep Jacobi chunk over 2048^2 (bytes), 0.00751 in
// bf16.  Design by measurement on the H100 (dev/bench_block_group.py,
// PERF.md §6; cuda_ops.BLOCK_GROUP_TILES, group_load below): 128 x 64
// tiles from 2 M cells a launch and 128 x 32 below (128-row and 256-column
// tiles, one block an SM, were slower, and are not built); every load of
// a tile before its stores (a store between two loads held the second);
// float32 Chebyshev chunks by cp.async, the other float32 forms staged
// through registers, bf16 in 4-cell vectors (vectors of 8 were no faster);
// a zero numerator taken as its own quotient, the bits 0/beta gives for
// beta > 0, since zeros send the IEEE division to its slow path and most
// of a step's cells are zero (90% of u after 4 steps of the impulse run,
// all of it after 300): over the (2, 4) blocks of the 2048^2 step's
// velocity after 300 steps the 8-sweep chunk took 0.0934 ms against
// 0.1766 dividing; the block steps took 0.97-1.03x the dividing kernel's
// after 4 steps at 2048^2, 0.92x at 8192^2, and 0.52-0.89x after 301.
#include <atomic>
#include <type_traits>

#include "fsc_common.cuh"

namespace {

constexpr int kLanes = fsc::kBlockX;  // a warp: 32 columns of one row
constexpr int kWarps = 16;            // a block's rows of warps
constexpr int kCols = 4;              // a thread's columns, 32 apart
constexpr int kTileW = kLanes * kCols;
constexpr int kThreads = kLanes * kWarps;
constexpr int kMaxSweeps = 20;  // JAX's max_fused
// Devices whose shared-memory attribute launch_kernel keeps.
constexpr int kDevices = 64;

// The tile of kRows rows of warps a thread (kRows of them 16 apart, K1's
// 4): kTileH rows, kCells cells a thread, two float32 buffers.
template <int kRows>
struct Tile {
  static constexpr int kTileH = kWarps * kRows;
  static constexpr int kCells = kCols * kRows;
  static constexpr int kSmem =
      2 * kTileW * kTileH * static_cast<int>(sizeof(float));
};

// One launch's tiling and its sweeps.
struct Tiling {
  int side, b, nb1, b1;
  int count;          // sweeps of this launch
  int margin;         // halo depth: count, or count + 1 (plan_tiling)
  int out_w, out_h;   // the output tile
  int margin_c;       // the halo's columns: margin, or more to align the
                      // tile's columns (the grouped K9-block's vector loads)
  int first_combine;  // the first sweep of the launch with the Chebyshev
                      // combine: 1 where the launch starts the solve
  // A slab buffer: its rows, wall rows (-1 when absent) and the band of
  // rows the launch writes, [band_lo, band_hi).
  int rows, gtop, gbot, band_lo, band_hi;
  // A block buffer: its band of columns [col_lo, col_hi), the grid's n and
  // the global cell of buffer cell (0, 0).
  int col_lo, col_hi, n, gr0, gc0;
  float w[kMaxSweeps];  // ω of each sweep of the launch
  float omw;            // 1-w of the damped form
};

// K1's geometry: grid blockIdx.z of a batch of padded (side, side) grids,
// its ghost ring the border.
struct GridTiles {
  static constexpr bool kWhole = false;  // a tile holds part of the grid
  // Loads cell by cell (GroupBlockTiles loads a tile's rows and columns).
  static constexpr bool kSeparable = false;
  int side, n, off, mode, r0, c0;
  __device__ explicit GridTiles(const Tiling& t)
      : side(t.side),
        n(t.side - 2),
        off(fsc::grid_offset(t.side)),
        mode(static_cast<int>(blockIdx.z) < t.nb1 ? t.b : t.b1),
        r0(static_cast<int>(blockIdx.y) * t.out_h - t.margin),
        c0(static_cast<int>(blockIdx.x) * t.out_w - t.margin_c) {}
  __device__ int load_at(int r, int c) const {
    return off + fsc::clampi(r, 0, side - 1) * side +
           fsc::clampi(c, 0, side - 1);
  }
  // The tile's loads from the operands' own arrays: whether the launch has
  // a guess, x_k at (r, c) clamped into the grid, the rhs at the interior
  // cell (r, c) derives from.
  template <class P>
  __device__ bool guess(const P& p) const {
    return p.x != nullptr;
  }
  template <class P>
  __device__ float x_at(const P& p, int r, int c) const {
    return fsc::load(p.x, load_at(r, c));
  }
  template <class P>
  __device__ float rhs_at(const P& p, int r, int c) const {
    return fsc::load(p.rhs, inner(r, c));
  }
  __device__ bool in_grid(int r, int c) const {
    return r >= 0 && r < side && c >= 0 && c < side;
  }
  // The interior cell a cell derives from (fsc::interior_of clamps).
  __device__ int inner(int r, int c) const {
    return off + fsc::interior_of(r, c, side);
  }
  __device__ bool border(int r, int c) const {
    return !(r >= 1 && r <= n && c >= 1 && c <= n);
  }
  __device__ int row_dir(int r) const {
    return r == 0 ? 1 : (r == side - 1 ? -1 : 0);
  }
  __device__ int col_dir(int c) const {
    return c == 0 ? 1 : (c == side - 1 ? -1 : 0);
  }
  // The tile holds a ghost row or column of the grid.
  __device__ bool edge(int tile_h) const {
    return r0 <= 0 || r0 + tile_h >= side || c0 <= 0 || c0 + kTileW >= side;
  }
  __device__ bool writes_row(int r) const { return r < side; }
  __device__ bool writes_col(int c) const { return c < side; }
  __device__ int at(int r, int c) const { return off + r * side + c; }
  // The lines of the array along the tile's rows.
  __device__ int extent() const { return side; }
};

// K1-damp's whole-grid geometry: one block a grid, the grid at tile cell
// (1, 1) (a launch of margin 1 and output tile side x side, plan_whole).
struct WholeGrid : GridTiles {
  static constexpr bool kWhole = true;  // every grid line exact every sweep
  using GridTiles::GridTiles;
};

// K9's geometry: a (rows, side) slab buffer whose tiles start at the
// band's first row, its ghost columns and wall rows the border.
struct SlabTiles {
  static constexpr bool kWhole = false;
  static constexpr bool kSeparable = false;
  int side, n, rows, gtop, gbot, band_hi, mode, r0, c0;
  __device__ explicit SlabTiles(const Tiling& t)
      : side(t.side),
        n(t.side - 2),
        rows(t.rows),
        gtop(t.gtop),
        gbot(t.gbot),
        band_hi(t.band_hi),
        mode(t.b),
        r0(t.band_lo + static_cast<int>(blockIdx.y) * t.out_h - t.margin),
        c0(static_cast<int>(blockIdx.x) * t.out_w - t.margin_c) {}
  __device__ int load_at(int r, int c) const {
    return fsc::clampi(r, 0, rows - 1) * side + fsc::clampi(c, 0, side - 1);
  }
  template <class P>
  __device__ bool guess(const P& p) const {
    return p.x != nullptr;
  }
  template <class P>
  __device__ float x_at(const P& p, int r, int c) const {
    return fsc::load(p.x, load_at(r, c));
  }
  template <class P>
  __device__ float rhs_at(const P& p, int r, int c) const {
    return fsc::load(p.rhs, inner(r, c));
  }
  __device__ bool in_grid(int r, int c) const {
    return r >= 0 && r < rows && c >= 0 && c < side;
  }
  __device__ int inner(int r, int c) const {
    return fsc::slab_row_of(fsc::clampi(r, 0, rows - 1), gtop, gbot) * side +
           fsc::clampi(c, 1, n);
  }
  __device__ bool border(int r, int c) const {
    return c == 0 || c == side - 1 || r == gtop || r == gbot;
  }
  __device__ int row_dir(int r) const {
    return r == gtop ? 1 : (r == gbot ? -1 : 0);
  }
  __device__ int col_dir(int c) const {
    return c == 0 ? 1 : (c == side - 1 ? -1 : 0);
  }
  __device__ bool edge(int tile_h) const {
    return c0 <= 0 || c0 + kTileW >= side ||
           (gtop >= r0 && gtop < r0 + tile_h) ||
           (gbot >= 0 && gbot >= r0 && gbot < r0 + tile_h);
  }
  __device__ bool writes_row(int r) const { return r < band_hi; }
  __device__ bool writes_col(int c) const { return c < side; }
  __device__ int at(int r, int c) const { return r * side + c; }
  __device__ int extent() const { return rows; }
};

// K9-block's geometry: an extended block buffer of `rows` x `side`
// columns whose cell (0, 0) is global cell (gr0, gc0) of a grid of n
// interior cells a side, its tiles over the band [band_lo, band_hi) x
// [col_lo, col_hi) (the block), written to an array of the band alone.
// Interior and ghost cells follow from global coordinates: a ghost row or
// column of the grid, or a corner, may lie anywhere in the buffer, and a
// cell beyond the grid (a halo beyond a wall) is neither.
struct BlockTiles {
  static constexpr bool kWhole = false;
  static constexpr bool kSeparable = false;
  int side, n, rows, gr0, gc0, band_lo, band_hi, col_lo, col_hi, mode, r0,
      c0;
  __device__ explicit BlockTiles(const Tiling& t)
      : side(t.side),
        n(t.n),
        rows(t.rows),
        gr0(t.gr0),
        gc0(t.gc0),
        band_lo(t.band_lo),
        band_hi(t.band_hi),
        col_lo(t.col_lo),
        col_hi(t.col_hi),
        mode(t.b),
        r0(t.band_lo + static_cast<int>(blockIdx.y) * t.out_h - t.margin),
        c0(t.col_lo + static_cast<int>(blockIdx.x) * t.out_w - t.margin_c) {}
  __device__ int load_at(int r, int c) const {
    return fsc::clampi(r, 0, rows - 1) * side + fsc::clampi(c, 0, side - 1);
  }
  template <class P>
  __device__ bool guess(const P& p) const {
    return p.x != nullptr;
  }
  template <class P>
  __device__ float x_at(const P& p, int r, int c) const {
    return fsc::load(p.x, load_at(r, c));
  }
  template <class P>
  __device__ float rhs_at(const P& p, int r, int c) const {
    return fsc::load(p.rhs, inner(r, c));
  }
  __device__ bool in_grid(int r, int c) const {
    return r >= 0 && r < rows && c >= 0 && c < side;
  }
  // The interior cell of the grid a cell derives from, clamped into the
  // buffer.
  __device__ int inner(int r, int c) const {
    return load_at(fsc::clampi(gr0 + r, 1, n) - gr0,
                   fsc::clampi(gc0 + c, 1, n) - gc0);
  }
  __device__ bool border(int r, int c) const {
    const int R = gr0 + r, C = gc0 + c;
    return R >= 0 && R <= n + 1 && C >= 0 && C <= n + 1 &&
           (R == 0 || R == n + 1 || C == 0 || C == n + 1);
  }
  __device__ int row_dir(int r) const {
    return gr0 + r == 0 ? 1 : (gr0 + r == n + 1 ? -1 : 0);
  }
  __device__ int col_dir(int c) const {
    return gc0 + c == 0 ? 1 : (gc0 + c == n + 1 ? -1 : 0);
  }
  // The tile holds a ghost row or column of the grid.
  __device__ bool edge(int tile_h) const {
    const int R = gr0 + r0, C = gc0 + c0;
    return (R <= 0 && R + tile_h > 0) || (R <= n + 1 && R + tile_h > n + 1) ||
           (C <= 0 && C + kTileW > 0) || (C <= n + 1 && C + kTileW > n + 1);
  }
  __device__ bool writes_row(int r) const { return r < band_hi; }
  __device__ bool writes_col(int c) const { return c < col_hi; }
  __device__ int at(int r, int c) const {
    return (r - band_lo) * (col_hi - col_lo) + (c - col_lo);
  }
  __device__ int extent() const { return rows; }
};

// The rows of a (m + 2K, side) slab buffer held in three arrays, as
// K18's split_row reads them (csrc/jacobi_slab_split.cu): rows [0, K) in
// top, [K, K + m) in mid, [K + m, m + 2K) in bot, each row `side` floats.
// A null top or bot holds zero rows (beyond a global wall, as
// parallel/mesh.py's _halos pads there); a null mid is the zero guess.
struct RowSources {
  const float* top;
  const float* mid;
  const float* bot;
};

// SlabTiles whose tile loads take buffer row r from split row sources
// (x and rhs) instead of one buffer: every index is SlabTiles' (rows and
// columns clamped into the buffer, the rhs at its interior cell), so a
// launch computes what it computes on the concatenated buffer, bit for
// bit.  A warp's cells share a row, so the row's source is one choice a
// warp.  Outputs are stored at buffer row r - out_row0: 0 for a buffer of
// the whole extended slab, K for one of the slab's m rows alone.
struct SplitSlabTiles : SlabTiles {
  RowSources xs, rs;
  int K, m, out_row0;
  __device__ SplitSlabTiles(const Tiling& t, const RowSources& x,
                            const RowSources& rhs, int halo, int slab_rows,
                            int wall_top, int wall_bot, int first_row)
      : SlabTiles(t),
        xs(x),
        rs(rhs),
        K(halo),
        m(slab_rows),
        out_row0(first_row) {
    gtop = wall_top;
    gbot = wall_bot;
  }
  __device__ float row_at(const RowSources& s, int r, int c) const {
    const float* row =
        r < K ? (s.top ? s.top + r * side : nullptr)
              : (r < K + m ? s.mid + (r - K) * side
                           : (s.bot ? s.bot + (r - K - m) * side : nullptr));
    return row ? __ldg(row + c) : 0.0f;
  }
  template <class P>
  __device__ bool guess(const P&) const {
    return xs.mid != nullptr;
  }
  template <class P>
  __device__ float x_at(const P&, int r, int c) const {
    return row_at(xs, fsc::clampi(r, 0, rows - 1),
                  fsc::clampi(c, 0, side - 1));
  }
  template <class P>
  __device__ float rhs_at(const P&, int r, int c) const {
    return row_at(rs, fsc::slab_row_of(fsc::clampi(r, 0, rows - 1), gtop,
                                       gbot),
                  fsc::clampi(c, 1, n));
  }
  __device__ int at(int r, int c) const { return (r - out_row0) * side + c; }
};

// One sweep of the tile's rows [lo, hi) from cur into nxt, every column
// but the tile's first and last (whose reads wrap to the next and the
// previous row, in bounds, their values stale as the halo's are) and the
// warps' columns from col_hi on.  Border cells and cells past the grid
// take the interior update of their own rhs here; the border cells are
// set after it (sweeps_body) and nothing exact reads the others.  A damped
// sweep blends the update with the cell's own x_k, omw*x_k + w*val.
// kSkipZero takes a zero numerator as its own quotient, the bits the IEEE
// division gives for the positive finite beta the caller checks, without
// the division's slow path on zeros (the grouped K9-block, by measurement).
template <int kRows, bool kCheby, bool kFast, bool kDamp, bool kCombine,
          bool kSkipZero, typename TX, typename TM, typename TR>
__device__ __forceinline__ void sweep_tile(
    const fsc::SweepParamsT<TX, TM, TR>& p, const float* cur, float* nxt,
    const float (&rhs)[Tile<kRows>::kCells],
    float (&xm)[kCheby ? Tile<kRows>::kCells : 1], float w, float omw,
    int lo, int hi, int col_hi) {
#pragma unroll
  for (int rb = 0; rb < kRows; ++rb) {
    const int lr = static_cast<int>(threadIdx.y) + kWarps * rb;
    if (lr < lo || lr >= hi) continue;
#pragma unroll
    for (int cb = 0; cb < kCols; ++cb) {
      if (kLanes * cb >= col_hi) continue;
      const int q = rb * kCols + cb;
      const int i = lr * kTileW + static_cast<int>(threadIdx.x) + kLanes * cb;
      const float neigh =
          ((cur[i - 1] + cur[i + 1]) + cur[i - kTileW]) + cur[i + kTileW];
      float val;
      if constexpr (kFast) {
        val = fmaf(p.ab, neigh, rhs[q]);
      } else {
        const float num = rhs[q] + p.alpha * neigh;
        val = kSkipZero && num == 0.0f ? num : num / p.beta;
      }
      if constexpr (kDamp) val = omw * cur[i] + p.w * val;
      if constexpr (kCheby) {
        if (kCombine) val = fsc::cheby_combine(w, val, xm[q]);
        xm[q] = cur[i];
      }
      nxt[i] = val;
    }
  }
}

// How a launch loads x_k into its tile: every launch but the grouped
// K9-block's stages a thread's cells through registers.
constexpr int kLoadStaged = 0;
// cp.async, each cell's 4 bytes straight into shared memory (float32).
constexpr int kLoadAsync = 1;
// kLoadVec4: 4 consecutive cells of a row a thread, one 8-byte load (bf16)
// where they share a source, each vector its own thread's.
constexpr int kLoadVec4 = 4;

// One cp.async of a float32 cell into shared memory: zeros where !valid
// (src is then any readable address and nothing is read).  Host builds
// copy at once.
__device__ __forceinline__ void async_cell(float* dst, const float* src,
                                           bool valid) {
#ifdef __CUDA_ARCH__
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(to),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
#else
  *dst = valid ? *src : 0.0f;
#endif
}

// Wait for this thread's cp.async copies.
__device__ __forceinline__ void async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
#endif
}

// The sources of one block of a grouped K9-block launch, by the nine
// regions of its extended (m + 2K) x (k + 2K) buffer: region 3*di + dj,
// di and dj 0 (the K rows or columns before the block), 1 (the block's
// own m rows or k columns) or 2 (the K after it).  Each source points at
// the region's first cell: into the block's own array (region 4), into
// the neighbour's array that holds the region (its last K rows, first K
// columns, a corner; row stride k), or at a copy of those cells where the
// neighbour lies on another device (`copied`: a (K, k) strip keeps row
// stride k, an (m, K) strip or a (K, K) corner takes K); null beyond a
// wall, zeros.
constexpr int kRegions = 9;
struct GroupBlock {
  const void* x[kRegions];    // all null: the zero guess
  const void* rhs[kRegions];
  const void* xm[kRegions];   // x_{k-1}; all null: none
  void* out;                  // the (m, k) block
  void* xm_out;               // its x_{count-1} (Chebyshev)
  int r0, c0;                 // the block's global origin
  int copied;                 // bit i: region i's source is a copy
};

// Where a line of a block's extended buffer lies among the regions: d 0
// (the K lines before the block), 1 (its own) or 2 (the K after), and its
// offset in that region's source.
struct Line {
  int d, off;
};

// K9-block's geometry over every block of a group: BlockTiles at the
// block's own buffer origin (r0 - K, c0 - K), each load of buffer cell
// (r, c) (clamped into the buffer, as BlockTiles' loads) taken from the
// source of its region, so that a launch computes, bit for bit, what the
// per-block launch computes on the block's extended buffer.  T is the
// storage type of every operand.  The staged loads are separable: a
// thread's cells share kRows buffer rows and kCols columns, so each row's
// and each column's region and offset are found once (load_cells), and a
// cell's address is its region's source plus the two.
template <typename T>
struct GroupBlockTiles : BlockTiles {
  static constexpr bool kSeparable = true;
  const GroupBlock& blk;
  int K, m, k;
  __device__ GroupBlockTiles(const Tiling& t, const GroupBlock& b, int halo,
                             int bm, int bk)
      : BlockTiles(t), blk(b), K(halo), m(bm), k(bk) {
    gr0 = b.r0 - halo;
    gc0 = b.c0 - halo;
  }
  // Buffer line v (inside the buffer) of a block of len lines.
  __device__ Line line(int v, int len) const {
    const int w = v - K;
    return w < 0 ? Line{0, w + K} : (w < len ? Line{1, w} : Line{2, w - len});
  }
  __device__ Line row_line(int r) const {
    return line(fsc::clampi(r, 0, rows - 1), m);
  }
  __device__ Line col_line(int c) const {
    return line(fsc::clampi(c, 0, side - 1), k);
  }
  // The interior line of the grid a buffer line derives from.
  __device__ Line inner_row(int r) const {
    return row_line(fsc::clampi(gr0 + r, 1, n) - gr0);
  }
  __device__ Line inner_col(int c) const {
    return col_line(fsc::clampi(gc0 + c, 1, n) - gc0);
  }
  // The cell at rows r, columns c in the sources `src`: null beyond a wall.
  __device__ const T* cell(const void* const* src, Line r, Line c) const {
    const int region = 3 * r.d + c.d;
    const T* base = static_cast<const T*>(src[region]);
    const int stride = c.d != 1 && ((blk.copied >> region) & 1) ? K : k;
    return base == nullptr ? nullptr : base + r.off * stride + c.off;
  }
  __device__ float value(const void* const* src, Line r, Line c) const {
    const T* q = cell(src, r, c);
    return q == nullptr ? 0.0f : fsc::load(q, 0);
  }
  template <class P>
  __device__ bool guess(const P&) const {
    return blk.x[4] != nullptr;
  }
  template <class P>
  __device__ float x_at(const P&, int r, int c) const {
    return value(blk.x, row_line(r), col_line(c));
  }
  // The tile's loads at tile origin (r0, c0): with kX x_k into both tile
  // buffers (zero off the buffer and for the zero guess), the raw rhs and,
  // for Chebyshev, x_{k-1} (zero when the chunk reads none) at the
  // interior cell each cell derives from.
  template <int kRows, bool kCheby, bool kX>
  __device__ void load_cells(float* cur, float* nxt,
                             float (&rhs)[kRows * kCols],
                             float (&xm)[kCheby ? kRows * kCols : 1]) const {
    Line xr[kRows], ir[kRows], xc[kCols], ic[kCols];
    bool rin[kRows], cin[kCols];
#pragma unroll
    for (int rb = 0; rb < kRows; ++rb) {
      const int r = r0 + static_cast<int>(threadIdx.y) + kWarps * rb;
      rin[rb] = r >= 0 && r < rows;
      xr[rb] = row_line(r);
      ir[rb] = inner_row(r);
    }
#pragma unroll
    for (int cb = 0; cb < kCols; ++cb) {
      const int c = c0 + static_cast<int>(threadIdx.x) + kLanes * cb;
      cin[cb] = c >= 0 && c < side;
      xc[cb] = col_line(c);
      ic[cb] = inner_col(c);
    }
    const bool x = blk.x[4] != nullptr;
    const bool has_xm = kCheby && blk.xm[4] != nullptr;
    // Every load first, then the tile's stores: a store between two loads
    // would hold the second until the first lands (the compiler cannot
    // tell the tile from the sources).
    float xv[kX ? kRows * kCols : 1];
#pragma unroll
    for (int rb = 0; rb < kRows; ++rb) {
#pragma unroll
      for (int cb = 0; cb < kCols; ++cb) {
        const int q = rb * kCols + cb;
        if constexpr (kX)
          xv[q] = x && rin[rb] && cin[cb] ? value(blk.x, xr[rb], xc[cb])
                                          : 0.0f;
        rhs[q] = value(blk.rhs, ir[rb], ic[cb]);
        if constexpr (kCheby)
          xm[q] = has_xm ? value(blk.xm, ir[rb], ic[cb]) : 0.0f;
      }
    }
    if constexpr (kX) {
#pragma unroll
      for (int rb = 0; rb < kRows; ++rb) {
#pragma unroll
        for (int cb = 0; cb < kCols; ++cb) {
          const int i = (static_cast<int>(threadIdx.y) + kWarps * rb) * kTileW +
                        static_cast<int>(threadIdx.x) + kLanes * cb;
          cur[i] = xv[rb * kCols + cb];
          nxt[i] = xv[rb * kCols + cb];
        }
      }
    }
  }
  // kLoadAsync: x_k at (r, c) into the tile cell `to`, zero off the
  // buffer, beyond a wall and for the zero guess.
  template <class P>
  __device__ void x_async(const P& p, int r, int c, float* to) const {
    const T* q = guess(p) && in_grid(r, c)
                     ? cell(blk.x, row_line(r), col_line(c))
                     : nullptr;
    async_cell(to, q != nullptr ? q : static_cast<const T*>(blk.rhs[4]),
               q != nullptr);
  }
  // kLoadVec4: x_k at (r, c) .. (r, c + V - 1) as the staged load stores
  // them (zero off the buffer), in one V-cell load where they lie in the
  // buffer and one source at an address aligned to the load.
  template <int V, class P>
  __device__ void x_vec(const P& p, int r, int c, float (&o)[V]) const {
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = 0.0f;
    if (!guess(p)) return;
    const bool whole = r >= 0 && r < rows && c >= 0 && c + V <= side &&
                       (c < K) == (c + V - 1 < K) &&
                       (c < K + k) == (c + V - 1 < K + k);
    if (whole) {
      const T* q = cell(blk.x, row_line(r), col_line(c));
      if (q == nullptr) return;
      if (reinterpret_cast<unsigned long long>(q) % (V * sizeof(T)) == 0) {
        fsc::load_vec<V>(q, 0, o);
        return;
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      o[j] = in_grid(r, c + j) ? x_at(p, r, c + j) : 0.0f;
  }
};

// The sweeps of one launch on the block's tile of geometry g (GridTiles,
// SlabTiles, SplitSlabTiles, WholeGrid, BlockTiles, GroupBlockTiles):
// load, `count` sweeps in shared memory, store; x_k loaded as kLoad says,
// kSkipZero as sweep_tile says.
template <int kRows, bool kCheby, bool kFast, bool kDamp,
          int kLoad = kLoadStaged, bool kSkipZero = false, class G,
          typename TX, typename TM, typename TR, typename TO, typename TXO>
__device__ __forceinline__ void sweeps_body(
    const G& g, const fsc::SweepParamsT<TX, TM, TR>& p, const Tiling& t,
    TO* out, TXO* xm_out, TR* rhs_out, float* tile) {
  constexpr int kTileH = Tile<kRows>::kTileH;
  constexpr int kCells = Tile<kRows>::kCells;
  float* cur = tile;                     // x_k
  float* nxt = tile + kTileW * kTileH;  // x_{k+1}
  // The tile's loads, one pass an operand, each pass free of branches
  // that depend on the cell (addresses clamped into the grid), so that a
  // thread's loads are all in flight together.  Cell q of the thread is
  // tile cell (row(q), col(q)), grid cell (r0 + row(q), c0 + col(q)).
  const auto row = [](int q) {
    return static_cast<int>(threadIdx.y) + kWarps * (q / kCols);
  };
  const auto col = [](int q) {
    return static_cast<int>(threadIdx.x) + kLanes * (q % kCols);
  };
  const auto in_grid = [&](int q) {
    return g.in_grid(g.r0 + row(q), g.c0 + col(q));
  };
  const auto inner = [&](int q) {
    return g.inner(g.r0 + row(q), g.c0 + col(q));
  };
  float rhs[kCells];
  float xm[kCheby ? kCells : 1];
  if constexpr (kLoad == kLoadAsync) {
#pragma unroll
    for (int q = 0; q < kCells; ++q)
      g.x_async(p, g.r0 + row(q), g.c0 + col(q),
                cur + row(q) * kTileW + col(q));
  } else if constexpr (kLoad == kLoadVec4) {
    // Vectors of kLoad cells of a row, the tile's vectors dealt out over
    // the block's threads (kCells / kLoad a thread).
    constexpr int kPerRow = kTileW / kLoad;
    const int tid = static_cast<int>(threadIdx.y) * kLanes +
                    static_cast<int>(threadIdx.x);
    constexpr int kVecs = kCells / kLoad;
    float o[kVecs][kLoad];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int e = tid + kThreads * v;
      g.template x_vec<kLoad>(p, g.r0 + e / kPerRow,
                              g.c0 + (e % kPerRow) * kLoad, o[v]);
    }
    // The stores after every load (as GroupBlockTiles::load_cells).
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const int e = tid + kThreads * v;
      const int i = (e / kPerRow) * kTileW + (e % kPerRow) * kLoad;
#pragma unroll
      for (int j = 0; j < kLoad; ++j) {
        cur[i + j] = o[v][j];
        nxt[i + j] = o[v][j];
      }
    }
  } else if constexpr (!G::kSeparable) {
    float x[kCells];
#pragma unroll
    for (int q = 0; q < kCells; ++q) x[q] = 0.0f;
    if (g.guess(p)) {
#pragma unroll
      for (int q = 0; q < kCells; ++q)
        x[q] = g.x_at(p, g.r0 + row(q), g.c0 + col(q));
    }
#pragma unroll
    for (int q = 0; q < kCells; ++q) {
      const float v = in_grid(q) ? x[q] : 0.0f;
      cur[row(q) * kTileW + col(q)] = v;
      nxt[row(q) * kTileW + col(q)] = v;
    }
  }
  // The rhs as fsc::rhs_at builds it: base + src_dt*src, times 1/beta in
  // fast mode, rounded to its storage type (GroupBlockTiles loads it, and
  // x_{k-1}, with x_k).
  if constexpr (G::kSeparable) {
    g.template load_cells<kRows, kCheby, kLoad == kLoadStaged>(cur, nxt, rhs,
                                                               xm);
  } else {
#pragma unroll
    for (int q = 0; q < kCells; ++q)
      rhs[q] = g.rhs_at(p, g.r0 + row(q), g.c0 + col(q));
  }
  if (p.flags & fsc::kPrep) {
    if (p.src) {
#pragma unroll
      for (int q = 0; q < kCells; ++q)
        rhs[q] = rhs[q] + p.src_dt * fsc::load(p.src, inner(q));
    }
    if (p.flags & fsc::kFast) {
#pragma unroll
      for (int q = 0; q < kCells; ++q) rhs[q] = rhs[q] * p.inv_b;
    }
#pragma unroll
    for (int q = 0; q < kCells; ++q) rhs[q] = fsc::round_to<TR>(rhs[q]);
  }
  if constexpr (kCheby && !G::kSeparable) {
#pragma unroll
    for (int q = 0; q < kCells; ++q) xm[q] = 0.0f;
    if (p.xm) {
#pragma unroll
      for (int q = 0; q < kCells; ++q) xm[q] = fsc::load(p.xm, inner(q));
    }
  }
  if constexpr (kLoad == kLoadAsync) {
    // This thread's copies have landed; x_k into x_{k+1}'s buffer too.
    async_wait();
#pragma unroll
    for (int q = 0; q < kCells; ++q)
      nxt[row(q) * kTileW + col(q)] = cur[row(q) * kTileW + col(q)];
  }
  // Bit q: own cell q is a border cell off the tile's outer ring (set from
  // its interior neighbour after each sweep).
  unsigned ghost = 0u;
#pragma unroll
  for (int q = 0; q < kCells; ++q) {
    const int gr = g.r0 + row(q);
    const int gc = g.c0 + col(q);
    const bool border = g.border(gr, gc);
    if (in_grid(q) && border && row(q) >= 1 && row(q) < kTileH - 1 &&
        col(q) >= 1 && col(q) < kTileW - 1)
      ghost |= 1u << q;
    // The first launch of a folded or fast solve stores the rhs it built,
    // once per interior cell it writes, for the launches after it.
    const bool kept = row(q) >= t.margin && row(q) < t.margin + t.out_h &&
                      col(q) >= t.margin_c && col(q) < t.margin_c + t.out_w;
    if (rhs_out != nullptr && in_grid(q) && !border && kept &&
        g.writes_row(gr))
      fsc::store(rhs_out, g.at(gr, gc), rhs[q]);
  }
  const bool edge = g.edge(kTileH);
  __syncthreads();
  // K1-damp and K9-damp sweep only the tile's lines in the array (a small
  // level's tiles reach past it; nothing exact reads a cell past the
  // array): rows [-r0, extent - r0) and the warps' columns before
  // side - c0.
  const int row_lo = -g.r0;
  const int row_hi = g.extent() - g.r0;
  const int col_hi =
      kDamp && t.side - g.c0 < kTileW ? t.side - g.c0 : kTileW;
  for (int s = 0; s < t.count; ++s) {
    // After s sweeps rows [s, kTileH - s) of the tile are exact; a whole
    // grid's rows all stay exact.
    int lo = G::kWhole ? 1 : s + 1;
    int hi = G::kWhole ? t.side + 1 : kTileH - 1 - s;
    if constexpr (kDamp) {
      lo = lo > row_lo ? lo : row_lo;
      hi = hi < row_hi ? hi : row_hi;
    }
    if (kCheby && s >= t.first_combine)
      sweep_tile<kRows, kCheby, kFast, kDamp, true, kSkipZero>(
          p, cur, nxt, rhs, xm, t.w[s], t.omw, lo, hi, col_hi);
    else
      sweep_tile<kRows, kCheby, kFast, kDamp, false, kSkipZero>(
          p, cur, nxt, rhs, xm, 0.0f, t.omw, lo, hi, col_hi);
    if (edge) {
      __syncthreads();
#pragma unroll
      for (int rb = 0; rb < kRows; ++rb) {
        const int lr = static_cast<int>(threadIdx.y) + kWarps * rb;
        if (lr < lo || lr >= hi) continue;
#pragma unroll
        for (int cb = 0; cb < kCols; ++cb) {
          const int q = rb * kCols + cb;
          if (!((ghost >> q) & 1u)) continue;
          const int lc = static_cast<int>(threadIdx.x) + kLanes * cb;
          const int di = g.row_dir(g.r0 + lr);
          const int dj = g.col_dir(g.c0 + lc);
          const int i = lr * kTileW + lc;
          nxt[i] = fsc::border_rule(nxt[i + di * kTileW + dj], dj != 0,
                                    di != 0, g.mode);
        }
      }
    }
    __syncthreads();
    float* const swept = nxt;
    nxt = cur;
    cur = swept;
  }
#pragma unroll
  for (int rb = 0; rb < kRows; ++rb) {
    const int lr = static_cast<int>(threadIdx.y) + kWarps * rb;
    const int gr = g.r0 + lr;
    if (lr < t.margin || lr >= t.margin + t.out_h || !g.writes_row(gr))
      continue;
#pragma unroll
    for (int cb = 0; cb < kCols; ++cb) {
      const int lc = static_cast<int>(threadIdx.x) + kLanes * cb;
      const int gc = g.c0 + lc;
      if (lc < t.margin_c || lc >= t.margin_c + t.out_w || !g.writes_col(gc))
        continue;
      const int o = g.at(gr, gc);
      const int i = lr * kTileW + lc;
      fsc::store(out, o, cur[i]);
      if (xm_out != nullptr) fsc::store(xm_out, o, nxt[i]);
    }
  }
}

template <bool kCheby, bool kFast, typename TX, typename TM, typename TR,
          typename TO>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
    jacobi_sweeps_kernel(fsc::SweepParamsT<TX, TM, TR> p, Tiling t,
                         TO* __restrict__ out, float* __restrict__ xm_out,
                         TR* __restrict__ rhs_out) {
  extern __shared__ float tile[];
  sweeps_body<4, kCheby, kFast, false>(GridTiles(t), p, t, out, xm_out,
                                       rhs_out, tile);
}

template <int kRows, bool kCheby, bool kFast>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
    jacobi_slab_sweeps_kernel(fsc::SweepParams p, Tiling t,
                              float* __restrict__ out,
                              float* __restrict__ xm_out,
                              float* __restrict__ rhs_out) {
  extern __shared__ float tile[];
  sweeps_body<kRows, kCheby, kFast, false>(SlabTiles(t), p, t, out, xm_out,
                                           rhs_out, tile);
}

// K1-damp on tiles of kRows rows of warps (GridTiles; kRows 1 or 4: tiles
// of 16 or 64 rows) or on whole grids (WholeGrid, kRows 2: 32 rows); x of
// TX, the rhs of TR and out of TO (float32, or the bf16-rhs forms).
template <class G, int kRows, typename TX, typename TR, typename TO>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
    jacobi_damped_sweeps_kernel(fsc::SweepParamsT<TX, float, TR> p, Tiling t,
                                TO* __restrict__ out) {
  extern __shared__ float tile[];
  sweeps_body<kRows, false, false, true>(G(t), p, t, out,
                                         static_cast<float*>(nullptr),
                                         static_cast<TR*>(nullptr), tile);
}

// One slab of a grouped K9-damp launch: its x and rhs row sources (a
// halo of `count` rows, the launch's sweeps), its (m, side) output and
// its wall rows in the (m + 2*count)-row buffer those sources make.
struct GroupSlab {
  RowSources x, rhs;
  float* out;
  int gtop, gbot;
};

// The slabs of one grouped launch, passed by value in the kernel's
// parameters (CUDA 12.1 and later take up to 32,764 bytes of them on
// sm_70 and later: 64 bytes a slab, 8 KB at kGroupSlabs), so a CUDA graph
// captures the table with the launch and no copy to the device runs.
constexpr int kGroupSlabs = 128;
struct SlabGroup {
  GroupSlab slab[kGroupSlabs];
};

// K9-damp grouped: the smooth of every slab of the group in one launch,
// slab blockIdx.z, its halo rows read from the neighbouring slabs' own
// arrays (tiles of kRows rows of warps: 1, 2 or 4).
template <int kRows>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
    jacobi_slab_damped_group_kernel(fsc::SweepParams p, Tiling t, int m,
                                    const __grid_constant__ SlabGroup group) {
  extern __shared__ float tile[];
  const GroupSlab& s = group.slab[blockIdx.z];
  sweeps_body<kRows, false, false, true>(
      SplitSlabTiles(t, s.x, s.rhs, t.count, m, s.gtop, s.gbot, t.count), p,
      t, s.out, static_cast<float*>(nullptr), static_cast<float*>(nullptr),
      tile);
}

// The tiled K9's first launch of a solve on split operands: x and rhs from
// (top halo, slab, bottom halo) arrays, x_count and the rhs it read
// (pre-scaled in fast mode) written on its band of the extended
// (m + 2K, side) buffers the launches after it read.
template <int kRows, bool kFast>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
    jacobi_slab_split_sweeps_kernel(fsc::SweepParams p, Tiling t,
                                    RowSources xs, RowSources rs, int K,
                                    int m, float* __restrict__ out,
                                    float* __restrict__ rhs_out) {
  extern __shared__ float tile[];
  sweeps_body<kRows, false, kFast, false>(
      SplitSlabTiles(t, xs, rs, K, m, t.gtop, t.gbot, 0), p, t, out,
      static_cast<float*>(nullptr), rhs_out, tile);
}

// K9-block: the sweeps of one chunk of a block solve (Jacobi, the
// reciprocal form, Chebyshev or damped) on an extended block buffer,
// written to the (m, k) block and, for Chebyshev, its x_{count-1}; every
// operand stored as T (float32, or bf16: loads widen, the iterate is
// float32 in the tile, the stores round).
template <int kRows, bool kCheby, bool kFast, bool kDamp, typename T>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
    jacobi_block_sweeps_kernel(fsc::SweepParamsT<T, T, T> p, Tiling t,
                               T* __restrict__ out, T* __restrict__ xm_out) {
  extern __shared__ float tile[];
  sweeps_body<kRows, kCheby, kFast, kDamp>(BlockTiles(t), p, t, out, xm_out,
                                           static_cast<T*>(nullptr), tile);
}

// The blocks of one grouped K9-block launch, passed by value in the
// kernel's parameters (248 bytes a block, 15.9 KB at kGroupBlocks, under
// the 32,764 bytes CUDA 12.1 takes on sm_70 and later), so a CUDA graph
// captures the table with the launch, as K9-damp's SlabGroup.
constexpr int kGroupBlocks = 64;
struct BlockGroup {
  GroupBlock block[kGroupBlocks];
};

// K9-block grouped: one chunk of a block solve on every block of the
// group in one launch, block blockIdx.z, its halo read from the
// neighbouring blocks' own arrays (GroupBlockTiles), x_k loaded as kLoad
// says, a zero numerator its own quotient (kSkipZero).
template <int kRows, int kLoad, bool kCheby, bool kFast, bool kDamp,
          typename T>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
    jacobi_block_group_kernel(fsc::SweepParamsT<T, T, T> p, Tiling t, int K,
                              int m, int k,
                              const __grid_constant__ BlockGroup group) {
  extern __shared__ float tile[];
  const GroupBlock& b = group.block[blockIdx.z];
  sweeps_body<kRows, kCheby, kFast, kDamp, kLoad, true>(
      GroupBlockTiles<T>(t, b, K, m, k), p, t, static_cast<T*>(b.out),
      static_cast<T*>(b.xm_out), static_cast<T*>(nullptr), tile);
}

// The halo and output tile of a launch of `count` sweeps: a halo of
// `count` cells, one more where `deeper` says a border line would derive
// from a line the halo leaves stale.
void set_halo(int count, int tile_h, bool deeper, Tiling* t) {
  t->margin = count + (deeper ? 1 : 0);
  t->margin_c = t->margin;
  t->out_w = kTileW - 2 * t->margin;
  t->out_h = tile_h - 2 * t->margin;
}

// The tiling of a launch of `count` sweeps on grids of `side` in tiles of
// tile_h rows: a halo of `count` cells, one more where the last tile of a
// row or column of tiles would hold only the grid's last ghost row or
// column (its value derives from the row before, which a halo of `count`
// leaves stale).
int plan_tiling(int side, int count, Tiling* t,
                int tile_h = Tile<4>::kTileH) {
  if (count < 1 || count > kMaxSweeps || side < 3 ||
      tile_h - 2 * (count + 1) < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  set_halo(count, tile_h, false, t);
  set_halo(count, tile_h, side % t->out_w == 1 || side % t->out_h == 1, t);
  t->side = side;
  t->count = count;
  return 0;
}

// The tiling of a launch of `count` sweeps after `done` on a (rows, side)
// slab buffer with wall rows gtop and gbot: tiles of tile_h rows from the
// band's first row, done + count.  The halo is one cell deeper where a
// tile's first output column would be the last ghost column, its last
// output row the wall row gtop or its first the wall row gbot: each
// derives from its neighbour across the tile's edge.  K9 takes tiles of
// 64 or 32 rows, the grouped K9-damp (`damped`) also of 16.
int plan_slab(int rows, int side, int count, int done, int gtop, int gbot,
              int tile_h, Tiling* t, bool damped = false) {
  if (count < 1 || count > kMaxSweeps || side < 3 || done < 0 ||
      (tile_h != Tile<4>::kTileH && tile_h != Tile<2>::kTileH &&
       !(damped && tile_h == Tile<1>::kTileH)) ||
      rows - 2 * (done + count) < 1 || tile_h - 2 * (count + 1) < 1 ||
      gtop < -1 || gtop >= rows - 1 || gbot < -1 || gbot == 0 ||
      gbot >= rows)
    return static_cast<int>(cudaErrorInvalidValue);
  t->side = side;
  t->count = count;
  t->rows = rows;
  t->gtop = gtop;
  t->gbot = gbot;
  t->band_lo = done + count;
  t->band_hi = rows - done - count;
  set_halo(count, tile_h, false, t);
  const auto stale = [&](int wall, int at) {
    return wall >= t->band_lo && wall < t->band_hi &&
           (wall - t->band_lo) % t->out_h == at;
  };
  set_halo(count, tile_h,
           side % t->out_w == 1 || stale(gtop, t->out_h - 1) || stale(gbot, 0),
           t);
  return 0;
}

// The launch of `count` sweeps (any count) on whole grids of `side` in a
// tile of tile_h rows (32): margin 1, the grid at tile cell (1, 1), which
// keeps its last ghost line off the tile's outer ring.
int plan_whole(int side, int count, int tile_h, Tiling* t) {
  if (count < 1 || side < 3 || tile_h != Tile<2>::kTileH ||
      side + 2 > tile_h)
    return static_cast<int>(cudaErrorInvalidValue);
  t->side = side;
  t->count = count;
  t->margin = t->margin_c = 1;
  t->out_w = side;
  t->out_h = side;
  return 0;
}

// The tiling of a K9-block launch of `count` sweeps (at most the halo)
// on an (m + 2*halo) x (k + 2*halo) block buffer: tiles of tile_h rows
// over the block, a halo of `count` cells, one deeper where the buffer
// holds a ghost line of the grid (`walls`; a grouped launch takes it where
// any of its blocks' buffers does: a deeper halo changes no written
// cell).  A top ghost row derives from the row below it in the same
// sweep, so wherever it lies within `count` rows under a tile's output
// band it leaves the exact rows one short after the sweep that reaches
// it; one more halo row keeps the band exact (so for the bottom row, the
// columns and the corners).  The caller sets the buffer's global origin
// (gr0, gc0).
int plan_block(int halo, int m, int k, int n, int count, int tile_h,
               bool walls, Tiling* t) {
  if (count < 1 || count > kMaxSweeps || count > halo || m < 2 || k < 2 ||
      n < 1 || (tile_h != Tile<4>::kTileH && tile_h != Tile<2>::kTileH) ||
      tile_h - 2 * (count + 1) < 1 || kTileW - 2 * (count + 1) < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  t->side = k + 2 * halo;
  t->rows = m + 2 * halo;
  t->count = count;
  t->n = n;
  t->gtop = t->gbot = -1;
  t->band_lo = t->col_lo = halo;
  t->band_hi = halo + m;
  t->col_hi = halo + k;
  set_halo(count, tile_h, walls, t);
  return 0;
}

// Set the kernel's dynamic shared-memory attribute once a device, its
// cudaError_t + 1 kept (0: not set yet) and returned after.
template <typename K>
int smem_attribute(K kernel, int smem, std::atomic<int>* attribute) {
  int device = 0;
  int err = static_cast<int>(cudaGetDevice(&device));
  if (err != 0) return err;
  if (device < 0 || device >= kDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  if (attribute[device].load() == 0)
    attribute[device].store(1 + static_cast<int>(cudaFuncSetAttribute(
                                    kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem)));
  return attribute[device].load() - 1;
}

template <bool kCheby, bool kFast, typename TX, typename TM, typename TR,
          typename TO>
int launch_kernel(const fsc::SweepParamsT<TX, TM, TR>& p, const Tiling& t,
                  void* out, float* xm_out, void* rhs_out, int nb,
                  cudaStream_t stream) {
  const auto kernel = jacobi_sweeps_kernel<kCheby, kFast, TX, TM, TR, TO>;
  constexpr int kSmem = Tile<4>::kSmem;
  static std::atomic<int> attribute[kDevices];
  const int err = smem_attribute(kernel, kSmem, attribute);
  if (err != 0) return err;
  const dim3 grid((t.side + t.out_w - 1) / t.out_w,
                  (t.side + t.out_h - 1) / t.out_h, nb);
  kernel<<<grid, dim3(kLanes, kWarps), kSmem, stream>>>(
      p, t, static_cast<TO*>(out), xm_out, static_cast<TR*>(rhs_out));
  return static_cast<int>(cudaGetLastError());
}

template <bool kCheby, typename TX, typename TM, typename TR, typename TO>
int launch(const fsc::SweepParamsT<TX, TM, TR>& p, const Tiling& t, void* out,
           float* xm_out, void* rhs_out, int nb, cudaStream_t stream) {
  return (p.flags & fsc::kFast)
             ? launch_kernel<kCheby, true, TX, TM, TR, TO>(p, t, out, xm_out,
                                                           rhs_out, nb, stream)
             : launch_kernel<kCheby, false, TX, TM, TR, TO>(
                   p, t, out, xm_out, rhs_out, nb, stream);
}

// The launch of one instantiation: Chebyshev or not, then (bf16 form only)
// the types of out and, for Chebyshev, of x_{k-1}.
template <typename TX, typename TR>
int launch_types(bool cheby, bool xm_bf16, bool out_bf16,
                 const fsc::SweepParamsT<TX, float, TR>& pf,
                 const fsc::SweepParamsT<TX, fsc::bf16, TR>& pb,
                 const Tiling& t, void* out, float* xm_out, void* rhs_out,
                 int nb, cudaStream_t stream) {
  if constexpr (std::is_same<TR, float>::value)
    return cheby ? launch<true, float, float, float, float>(
                       pf, t, out, xm_out, rhs_out, nb, stream)
                 : launch<false, float, float, float, float>(
                       pf, t, out, xm_out, rhs_out, nb, stream);
  else {
    if (!cheby)
      return out_bf16
                 ? launch<false, TX, float, TR, fsc::bf16>(pf, t, out, xm_out,
                                                           rhs_out, nb, stream)
                 : launch<false, TX, float, TR, float>(pf, t, out, xm_out,
                                                       rhs_out, nb, stream);
    if (xm_bf16)
      return out_bf16 ? launch<true, TX, fsc::bf16, TR, fsc::bf16>(
                            pb, t, out, xm_out, rhs_out, nb, stream)
                      : launch<true, TX, fsc::bf16, TR, float>(
                            pb, t, out, xm_out, rhs_out, nb, stream);
    return out_bf16 ? launch<true, TX, float, TR, fsc::bf16>(pf, t, out, xm_out,
                                                             rhs_out, nb, stream)
                    : launch<true, TX, float, TR, float>(pf, t, out, xm_out,
                                                         rhs_out, nb, stream);
  }
}

template <typename TX, typename TM, typename TR>
fsc::SweepParamsT<TX, TM, TR> sweep_params(const void* x, const void* rhs,
                                           const void* src, const void* xm,
                                           float alpha, float beta, float ab,
                                           float inv_b, float src_dt,
                                           int flags) {
  fsc::SweepParamsT<TX, TM, TR> p;
  p.x = static_cast<const TX*>(x);
  p.rhs = static_cast<const TR*>(rhs);
  p.src = static_cast<const TX*>(src);
  p.xm = static_cast<const TM*>(xm);
  p.alpha = alpha;
  p.beta = beta;
  p.ab = ab;
  p.inv_b = inv_b;
  p.src_dt = src_dt;
  p.w = 0.0f;
  p.flags = flags;
  return p;
}

template <typename TX, typename TR>
int launch_form(const void* x, const void* rhs, const void* src,
                const void* xm, void* out, float* xm_out, void* rhs_out,
                int side, int b, float alpha, float beta, float ab,
                float inv_b, float src_dt, const float* omegas, int flags,
                int first, int count, int nb, int nb1, int b1, bool xm_bf16,
                bool out_bf16, void* stream) {
  Tiling t{};
  const int err = plan_tiling(side, count, &t);
  if (err != 0) return err;
  if (nb < 1 || first < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool cheby = (flags & fsc::kCheby) != 0;
  t.b = b;
  t.nb1 = nb1;
  t.b1 = b1;
  t.first_combine = first == 0 ? 1 : 0;
  for (int s = 0; s < kMaxSweeps; ++s)
    t.w[s] = (cheby && s < count) ? omegas[s] : 0.0f;
  const int sweep_flags = flags & ~fsc::kCheby;
  return launch_types<TX, TR>(
      cheby, xm_bf16, out_bf16,
      sweep_params<TX, float, TR>(x, rhs, src, xm, alpha, beta, ab, inv_b,
                                  src_dt, sweep_flags),
      sweep_params<TX, fsc::bf16, TR>(x, rhs, src, xm, alpha, beta, ab,
                                      inv_b, src_dt, sweep_flags),
      t, out, xm_out, rhs_out, nb, static_cast<cudaStream_t>(stream));
}

template <int kRows, bool kCheby, bool kFast>
int launch_slab_kernel(const fsc::SweepParams& p, const Tiling& t, float* out,
                       float* xm_out, float* rhs_out, cudaStream_t stream) {
  const auto kernel = jacobi_slab_sweeps_kernel<kRows, kCheby, kFast>;
  constexpr int kSmem = Tile<kRows>::kSmem;
  static std::atomic<int> attribute[kDevices];
  const int err = smem_attribute(kernel, kSmem, attribute);
  if (err != 0) return err;
  const dim3 grid((t.side + t.out_w - 1) / t.out_w,
                  (t.band_hi - t.band_lo + t.out_h - 1) / t.out_h);
  kernel<<<grid, dim3(kLanes, kWarps), kSmem, stream>>>(p, t, out, xm_out,
                                                         rhs_out);
  return static_cast<int>(cudaGetLastError());
}

template <int kRows>
int launch_slab(bool cheby, const fsc::SweepParams& p, const Tiling& t,
                float* out, float* xm_out, float* rhs_out,
                cudaStream_t stream) {
  const bool fast = (p.flags & fsc::kFast) != 0;
  if (cheby)
    return fast ? launch_slab_kernel<kRows, true, true>(p, t, out, xm_out,
                                                        rhs_out, stream)
                : launch_slab_kernel<kRows, true, false>(p, t, out, xm_out,
                                                         rhs_out, stream);
  return fast ? launch_slab_kernel<kRows, false, true>(p, t, out, xm_out,
                                                       rhs_out, stream)
              : launch_slab_kernel<kRows, false, false>(p, t, out, xm_out,
                                                        rhs_out, stream);
}

template <class G, int kRows, typename TX, typename TR, typename TO>
int launch_damped_kernel(const fsc::SweepParamsT<TX, float, TR>& p,
                         const Tiling& t, void* out, dim3 grid,
                         cudaStream_t stream) {
  const auto kernel = jacobi_damped_sweeps_kernel<G, kRows, TX, TR, TO>;
  constexpr int kSmem = Tile<kRows>::kSmem;
  static std::atomic<int> attribute[kDevices];
  const int err = smem_attribute(kernel, kSmem, attribute);
  if (err != 0) return err;
  kernel<<<grid, dim3(kLanes, kWarps), kSmem, stream>>>(
      p, t, static_cast<TO*>(out));
  return static_cast<int>(cudaGetLastError());
}

// One K1-damp launch (fsc_jacobi_sweeps_damp's arguments) of the form
// <TX, TR, TO>: its tiling, then the whole-grid or the tiled kernel.
template <typename TX, typename TR, typename TO>
int launch_damped(const void* x, const void* rhs, void* out, int side, int b,
                  float alpha, float beta, float w, float omw, int count,
                  int nb, int nb1, int b1, int tile_rows, int whole,
                  void* stream) {
  if (nb < 1 || (!whole && tile_rows != Tile<4>::kTileH &&
                 tile_rows != Tile<1>::kTileH))
    return static_cast<int>(cudaErrorInvalidValue);
  Tiling t{};
  const int err = whole ? plan_whole(side, count, tile_rows, &t)
                        : plan_tiling(side, count, &t, tile_rows);
  if (err != 0) return err;
  t.b = b;
  t.nb1 = nb1;
  t.b1 = b1;
  t.omw = omw;
  auto p = sweep_params<TX, float, TR>(x, rhs, nullptr, nullptr, alpha, beta,
                                       0.0f, 0.0f, 0.0f, 0);
  p.w = w;
  const auto stream_ = static_cast<cudaStream_t>(stream);
  if (whole)
    return launch_damped_kernel<WholeGrid, 2, TX, TR, TO>(
        p, t, out, dim3(1, 1, nb), stream_);
  const dim3 grid((side + t.out_w - 1) / t.out_w,
                  (side + t.out_h - 1) / t.out_h, nb);
  return tile_rows == Tile<4>::kTileH
             ? launch_damped_kernel<GridTiles, 4, TX, TR, TO>(p, t, out, grid,
                                                              stream_)
             : launch_damped_kernel<GridTiles, 1, TX, TR, TO>(p, t, out, grid,
                                                              stream_);
}

template <int kRows>
int launch_group_kernel(const fsc::SweepParams& p, const Tiling& t, int m,
                        const SlabGroup& group, int slabs,
                        cudaStream_t stream) {
  const auto kernel = jacobi_slab_damped_group_kernel<kRows>;
  constexpr int kSmem = Tile<kRows>::kSmem;
  static std::atomic<int> attribute[kDevices];
  const int err = smem_attribute(kernel, kSmem, attribute);
  if (err != 0) return err;
  const dim3 grid((t.side + t.out_w - 1) / t.out_w,
                  (t.band_hi - t.band_lo + t.out_h - 1) / t.out_h, slabs);
  kernel<<<grid, dim3(kLanes, kWarps), kSmem, stream>>>(p, t, m, group);
  return static_cast<int>(cudaGetLastError());
}

template <int kRows, bool kFast>
int launch_split_kernel(const fsc::SweepParams& p, const Tiling& t,
                        const RowSources& xs, const RowSources& rs, int K,
                        int m, float* out, float* rhs_out,
                        cudaStream_t stream) {
  const auto kernel = jacobi_slab_split_sweeps_kernel<kRows, kFast>;
  constexpr int kSmem = Tile<kRows>::kSmem;
  static std::atomic<int> attribute[kDevices];
  const int err = smem_attribute(kernel, kSmem, attribute);
  if (err != 0) return err;
  const dim3 grid((t.side + t.out_w - 1) / t.out_w,
                  (t.band_hi - t.band_lo + t.out_h - 1) / t.out_h);
  kernel<<<grid, dim3(kLanes, kWarps), kSmem, stream>>>(
      p, t, xs, rs, K, m, out, rhs_out);
  return static_cast<int>(cudaGetLastError());
}

template <int kRows>
int launch_split(const fsc::SweepParams& p, const Tiling& t,
                 const RowSources& xs, const RowSources& rs, int K, int m,
                 float* out, float* rhs_out, cudaStream_t stream) {
  return (p.flags & fsc::kFast) != 0
             ? launch_split_kernel<kRows, true>(p, t, xs, rs, K, m, out,
                                                rhs_out, stream)
             : launch_split_kernel<kRows, false>(p, t, xs, rs, K, m, out,
                                                 rhs_out, stream);
}

template <int kRows, bool kCheby, bool kFast, bool kDamp, typename T>
int launch_block_kernel(const fsc::SweepParamsT<T, T, T>& p, const Tiling& t,
                        T* out, T* xm_out, cudaStream_t stream) {
  const auto kernel =
      jacobi_block_sweeps_kernel<kRows, kCheby, kFast, kDamp, T>;
  constexpr int kSmem = Tile<kRows>::kSmem;
  static std::atomic<int> attribute[kDevices];
  const int err = smem_attribute(kernel, kSmem, attribute);
  if (err != 0) return err;
  const dim3 grid((t.col_hi - t.col_lo + t.out_w - 1) / t.out_w,
                  (t.band_hi - t.band_lo + t.out_h - 1) / t.out_h);
  kernel<<<grid, dim3(kLanes, kWarps), kSmem, stream>>>(p, t, out, xm_out);
  return static_cast<int>(cudaGetLastError());
}

template <int kRows, typename T>
int launch_block(int flags, const fsc::SweepParamsT<T, T, T>& p,
                 const Tiling& t, T* out, T* xm_out, cudaStream_t stream) {
  if (flags & fsc::kDamp)
    return launch_block_kernel<kRows, false, false, true, T>(p, t, out,
                                                             xm_out, stream);
  const bool fast = (flags & fsc::kFast) != 0;
  if (flags & fsc::kCheby)
    return fast ? launch_block_kernel<kRows, true, true, false, T>(
                      p, t, out, xm_out, stream)
                : launch_block_kernel<kRows, true, false, false, T>(
                      p, t, out, xm_out, stream);
  return fast ? launch_block_kernel<kRows, false, true, false, T>(
                    p, t, out, xm_out, stream)
              : launch_block_kernel<kRows, false, false, false, T>(
                    p, t, out, xm_out, stream);
}

// One K9-block launch (fsc_jacobi_block_sweeps's arguments) with every
// operand stored as T.
template <typename T>
int block_sweeps(const void* x, const void* rhs, const void* xm, void* out,
                 void* xm_out, int rows, int cols, int halo, int m, int k,
                 int gr0, int gc0, int n, int b, float alpha, float beta,
                 float ab, float inv_b, float w, float omw,
                 const float* omegas, int flags, int first, int count,
                 int tile_h, void* stream) {
  if (rows != m + 2 * halo || cols != k + 2 * halo)
    return static_cast<int>(cudaErrorInvalidValue);
  Tiling t{};
  const int err = plan_block(halo, m, k, n, count, tile_h,
                             gr0 <= 0 || gr0 + rows > n + 1 || gc0 <= 0 ||
                                 gc0 + cols > n + 1,
                             &t);
  if (err != 0) return err;
  t.gr0 = gr0;
  t.gc0 = gc0;
  const bool cheby = (flags & fsc::kCheby) != 0;
  if (first < 0 || ((flags & fsc::kDamp) && flags != fsc::kDamp) ||
      (cheby && first > 0 && xm == nullptr) || (cheby && xm_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  t.b = b;
  t.omw = omw;
  t.first_combine = first == 0 ? 1 : 0;
  for (int s = 0; s < kMaxSweeps; ++s)
    t.w[s] = (cheby && s < count) ? omegas[s] : 0.0f;
  auto p = sweep_params<T, T, T>(x, rhs, nullptr, cheby ? xm : nullptr,
                                 alpha, beta, ab, inv_b, 0.0f,
                                 flags & (fsc::kPrep | fsc::kFast));
  p.w = w;
  const auto stream_ = static_cast<cudaStream_t>(stream);
  T* const o = static_cast<T*>(out);
  T* const xo = static_cast<T*>(xm_out);
  return tile_h == Tile<4>::kTileH
             ? launch_block<4, T>(flags, p, t, o, xo, stream_)
             : launch_block<2, T>(flags, p, t, o, xo, stream_);
}

template <int kRows, int kLoad, bool kCheby, bool kFast, bool kDamp,
          typename T>
int launch_group_block_kernel(const fsc::SweepParamsT<T, T, T>& p,
                              const Tiling& t, int K, int m, int k,
                              const BlockGroup& group, int blocks,
                              cudaStream_t stream) {
  const auto kernel =
      jacobi_block_group_kernel<kRows, kLoad, kCheby, kFast, kDamp, T>;
  constexpr int kSmem = Tile<kRows>::kSmem;
  static std::atomic<int> attribute[kDevices];
  const int err = smem_attribute(kernel, kSmem, attribute);
  if (err != 0) return err;
  const dim3 grid((t.col_hi - t.col_lo + t.out_w - 1) / t.out_w,
                  (t.band_hi - t.band_lo + t.out_h - 1) / t.out_h, blocks);
  kernel<<<grid, dim3(kLanes, kWarps), kSmem, stream>>>(p, t, K, m, k,
                                                         group);
  return static_cast<int>(cudaGetLastError());
}

// How the grouped launches load x_k, by measurement on the H100
// (dev/bench_block_group.py, PERF.md): float32 Chebyshev chunks by
// cp.async (13-16% under staged loads on 64-row tiles), the other float32
// forms staged (3-4% under cp.async), every bf16 form in vectors of 4
// cells (10% under staged loads; vectors of 8 were within 3% of them but
// for the 8-sweep Jacobi chunk, 11% over, and are not built).
template <typename T>
constexpr int group_load(bool cheby) {
  return std::is_same<T, float>::value ? (cheby ? kLoadAsync : kLoadStaged)
                                       : kLoadVec4;
}

// The grouped launch of the form `flags` names, on tiles of kRows rows of
// warps, each form loaded as group_load says.
template <int kRows, typename T>
int launch_group(int flags, const fsc::SweepParamsT<T, T, T>& p,
                 const Tiling& t, int K, int m, int k, const BlockGroup& g,
                 int blocks, cudaStream_t s) {
  constexpr int kJ = group_load<T>(false);
  constexpr int kCh = group_load<T>(true);
  const bool fast = (flags & fsc::kFast) != 0;
  if (flags & fsc::kDamp)
    return launch_group_block_kernel<kRows, kJ, false, false, true, T>(
        p, t, K, m, k, g, blocks, s);
  if (flags & fsc::kCheby)
    return fast ? launch_group_block_kernel<kRows, kCh, true, true, false, T>(
                      p, t, K, m, k, g, blocks, s)
                : launch_group_block_kernel<kRows, kCh, true, false, false,
                                            T>(p, t, K, m, k, g, blocks, s);
  return fast ? launch_group_block_kernel<kRows, kJ, false, true, false, T>(
                    p, t, K, m, k, g, blocks, s)
              : launch_group_block_kernel<kRows, kJ, false, false, false, T>(
                    p, t, K, m, k, g, blocks, s);
}

// One grouped K9-block launch (fsc_jacobi_block_group's arguments) with
// every operand stored as T.
template <typename T>
int block_group(const void* const* ptrs, const int* ints, int blocks, int m,
                int k, int halo, int n, int b, float alpha, float beta,
                float ab, float inv_b, float w, float omw,
                const float* omegas, int flags, int first, int count,
                int tile_h, void* stream) {
  // beta positive and finite: 0/beta is then the zero numerator itself
  // (kSkipZero).
  if (blocks < 1 || blocks > kGroupBlocks || halo > m || halo > k ||
      first < 0 || ((flags & fsc::kDamp) && flags != fsc::kDamp) ||
      !(beta > 0.0f && beta <= 3.4e38f))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool cheby = (flags & fsc::kCheby) != 0;
  const bool guess = ptrs[4] != nullptr;
  const bool has_xm = cheby && first > 0;
  BlockGroup group;
  bool walls = false;
  for (int i = 0; i < blocks; ++i) {
    const void* const* q = ptrs + (3 * kRegions + 2) * i;
    const int* v = ints + 3 * i;
    GroupBlock& g = group.block[i];
    for (int r = 0; r < kRegions; ++r) {
      g.x[r] = q[r];
      g.rhs[r] = q[kRegions + r];
      g.xm[r] = has_xm ? q[2 * kRegions + r] : nullptr;
    }
    g.out = const_cast<void*>(q[3 * kRegions]);
    g.xm_out = const_cast<void*>(q[3 * kRegions + 1]);
    g.r0 = v[0];
    g.c0 = v[1];
    g.copied = v[2];
    // Every block alike: a guess or none, x_{k-1} where the chunk reads
    // it, its rhs and its outputs.
    if ((g.x[4] != nullptr) != guess || (has_xm && g.xm[4] == nullptr) ||
        g.rhs[4] == nullptr || g.out == nullptr ||
        (cheby && g.xm_out == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    walls = walls || g.r0 - halo <= 0 || g.r0 + m + halo > n + 1 ||
            g.c0 - halo <= 0 || g.c0 + k + halo > n + 1;
  }
  Tiling t{};
  const int err = plan_block(halo, m, k, n, count, tile_h, walls, &t);
  if (err != 0) return err;
  constexpr int vec = group_load<T>(false);
  if (vec > 1) {
    // Vector loads: the tile's columns start on a multiple of the vector
    // (the blocks' columns do; a deeper halo changes no written cell).
    t.margin_c = (t.margin + vec - 1) / vec * vec;
    t.out_w = kTileW - 2 * t.margin_c;
    if (t.out_w < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  t.b = b;
  t.omw = omw;
  t.first_combine = first == 0 ? 1 : 0;
  for (int s = 0; s < kMaxSweeps; ++s)
    t.w[s] = (cheby && s < count) ? omegas[s] : 0.0f;
  auto p = sweep_params<T, T, T>(nullptr, nullptr, nullptr, nullptr, alpha,
                                 beta, ab, inv_b, 0.0f,
                                 flags & (fsc::kPrep | fsc::kFast));
  p.w = w;
  const auto s = static_cast<cudaStream_t>(stream);
  return tile_h == Tile<4>::kTileH
             ? launch_group<4, T>(flags, p, t, halo, m, k, group, blocks, s)
             : launch_group<2, T>(flags, p, t, halo, m, k, group, blocks, s);
}

}  // namespace

// `count` sweeps (1..kMaxSweeps) of a solve whose sweeps are numbered from
// 0, the first of them sweep `first`; every pointer holds nb grids of
// side^2 cells.  x, src, xm, xm_out and rhs_out may be null (fsc::SweepParams;
// xm_out: x_{count-1} not wanted, rhs_out: the rhs built not kept).  flags
// as fsc_jacobi_sweep's, kCheby set for a Chebyshev solve whatever `first`
// is (the solve's sweep 0 takes no combine); omegas holds `count` floats on
// the host, the ω of each sweep, read with kCheby.  No output aliases an
// input or another output.  Grids [0, nb1) take boundary mode b, grids
// [nb1, nb) mode b1.  Returns a cudaError_t: cudaErrorInvalidValue for a
// count out of range, otherwise cudaGetLastError() after the launch.
extern "C" int fsc_jacobi_sweeps(const float* x, const float* rhs,
                                 const float* src, const float* xm,
                                 float* out, float* xm_out, float* rhs_out,
                                 int side, int b, float alpha, float beta,
                                 float ab, float inv_b, float src_dt,
                                 const float* omegas, int flags, int first,
                                 int count, int nb, int nb1, int b1,
                                 void* stream) {
  return launch_form<float, float>(x, rhs, src, xm, out, xm_out, rhs_out,
                                   side, b, alpha, beta, ab, inv_b, src_dt,
                                   omegas, flags, first, count, nb, nb1, b1,
                                   false, false, stream);
}

// The bf16 form (fsc_jacobi_sweep_bf16's): rhs and rhs_out hold bf16;
// types says which of x (1), xm (2) and out (4) hold bf16, the others
// float32; src is stored as x; xm_out is float32.
extern "C" int fsc_jacobi_sweeps_bf16(const void* x, const void* rhs,
                                      const void* src, const void* xm,
                                      void* out, float* xm_out, void* rhs_out,
                                      int side, int b, float alpha,
                                      float beta, float ab, float inv_b,
                                      float src_dt, const float* omegas,
                                      int flags, int first, int count, int nb,
                                      int nb1, int b1, int types,
                                      void* stream) {
  const auto form = (types & 1) ? launch_form<fsc::bf16, fsc::bf16>
                                : launch_form<float, fsc::bf16>;
  return form(x, rhs, src, xm, out, xm_out, rhs_out, side, b, alpha, beta,
              ab, inv_b, src_dt, omegas, flags, first, count, nb, nb1, b1,
              (types & 2) != 0, (types & 4) != 0, stream);
}

// K1-damp: `count` damped sweeps x <- omw*x + w*S(x) (fsc_jacobi_sweep's
// kDamp: omw is 1-w rounded on the host) from x (null: the zero guess)
// with rhs, nb float32 grids of side^2 cells, grids [0, nb1) in boundary
// mode b and the rest in b1, in tiles of tile_rows rows.  whole 0: on
// tiles of 16 or 64 rows, count 1..kMaxSweeps and at most
// (tile_rows - 3)/2; whole 1: each grid whole in one block's tile of 32
// rows, any count, side at most 30.  out must not alias x or rhs.  Returns
// cudaErrorInvalidValue for a count, side or tile out of range, otherwise
// cudaGetLastError() after the launch.
extern "C" int fsc_jacobi_sweeps_damp(const float* x, const float* rhs,
                                      float* out, int side, int b,
                                      float alpha, float beta, float w,
                                      float omw, int count, int nb, int nb1,
                                      int b1, int tile_rows, int whole,
                                      void* stream) {
  return launch_damped<float, float, float>(x, rhs, out, side, b, alpha,
                                            beta, w, omw, count, nb, nb1, b1,
                                            tile_rows, whole, stream);
}

// K1-damp's bf16-rhs forms (the finest level of a bf16 multigrid solve):
// the same launch with a bf16 rhs; types says which of x (1) and out (4)
// hold bf16, the other float32.  The iterate is float32 in the tile;
// loads widen, the store of a bf16 out rounds once.  The caller passes w
// and 1-w in the iterate's storage type (bf16-rounded for a solve from
// zero or from a bf16 guess, as JAX's _smooth takes them).
extern "C" int fsc_jacobi_sweeps_damp_bf16(const void* x, const void* rhs,
                                           void* out, int side, int b,
                                           float alpha, float beta, float w,
                                           float omw, int count, int nb,
                                           int nb1, int b1, int tile_rows,
                                           int whole, int types,
                                           void* stream) {
  using fsc::bf16;
  const auto form =
      (types & 1) ? ((types & 4) ? launch_damped<bf16, bf16, bf16>
                                 : launch_damped<bf16, bf16, float>)
                  : ((types & 4) ? launch_damped<float, bf16, bf16>
                                 : launch_damped<float, bf16, float>);
  return form(x, rhs, out, side, b, alpha, beta, w, omw, count, nb, nb1, b1,
              tile_rows, whole, stream);
}

// The same sweeps on a (rows, side) row-slab buffer (fsc_jacobi_slab's
// operands, float32 only): `done` sweeps of the solve ran before this
// launch (first == done but after a first sweep another kernel ran), so
// x is exact on rows [done, rows - done), the launch's sweep t (from 1)
// computes rows [done + t, rows - done - t) and the launch writes out,
// xm_out and rhs_out on the band [done + count, rows - done - count).  The
// wall rows gtop and gbot are buffer rows, -1 when absent; tile_h, the
// tile's rows, is 64 or 32.  Returns cudaErrorInvalidValue for a count out
// of range or a band, tile or wall row that does not fit, otherwise
// cudaGetLastError() after the launch.
extern "C" int fsc_jacobi_slab_sweeps(const float* x, const float* rhs,
                                      const float* src, const float* xm,
                                      float* out, float* xm_out,
                                      float* rhs_out, int side, int b,
                                      float alpha, float beta, float ab,
                                      float inv_b, float src_dt,
                                      const float* omegas, int flags,
                                      int first, int count, int rows,
                                      int done, int gtop, int gbot,
                                      int tile_h, void* stream) {
  Tiling t{};
  const int err = plan_slab(rows, side, count, done, gtop, gbot, tile_h, &t);
  if (err != 0) return err;
  if (first < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool cheby = (flags & fsc::kCheby) != 0;
  t.b = b;
  t.first_combine = first == 0 ? 1 : 0;
  for (int s = 0; s < kMaxSweeps; ++s)
    t.w[s] = (cheby && s < count) ? omegas[s] : 0.0f;
  const fsc::SweepParams p = fsc::make_sweep_params(
      x, rhs, src, xm, alpha, beta, ab, inv_b, src_dt, 0.0f,
      flags & ~fsc::kCheby);
  const auto stream_ = static_cast<cudaStream_t>(stream);
  return tile_h == Tile<4>::kTileH
             ? launch_slab<4>(cheby, p, t, out, xm_out, rhs_out, stream_)
             : launch_slab<2>(cheby, p, t, out, xm_out, rhs_out, stream_);
}

// K9-damp grouped: `count` damped sweeps x <- omw*x + w*S(x) (K1-damp's,
// omw 1-w rounded on the host) of boundary mode b on each of `slabs` (at most kGroupSlabs) row slabs of
// m rows in one launch.  ptrs holds 7 pointers a slab, on the host: x's
// `count` halo rows above the slab, its m rows and its `count` rows below,
// the same three of rhs, and the slab's (m, side) output; a halo pointer
// may point into the neighbouring slab's own array (its last or first
// `count` rows) or at a copy of them, and is null beyond a global wall
// (zero rows).  x's slab pointers are all null for the zero guess.  walls
// holds 2 ints a slab: whether it holds the global top and the bottom
// ghost row.  count is at most m and what the tile's halo allows; tile_rows
// is 64, 32 or 16.  No output aliases an input.  Returns
// cudaErrorInvalidValue for a count, slab count, tile or band out of
// range, otherwise cudaGetLastError() after the launch.
extern "C" int fsc_jacobi_slab_sweeps_damp_group(
    const float* const* ptrs, const int* walls, int slabs, int m, int side,
    int b, float alpha, float beta, float w, float omw, int count,
    int tile_rows, void* stream) {
  if (slabs < 1 || slabs > kGroupSlabs || count > m)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = m + 2 * count;
  bool top = false, bot = false;
  SlabGroup group;
  for (int i = 0; i < slabs; ++i) {
    const float* const* q = ptrs + 7 * i;
    GroupSlab& s = group.slab[i];
    s.x = RowSources{q[0], q[1], q[2]};
    s.rhs = RowSources{q[3], q[4], q[5]};
    s.out = const_cast<float*>(q[6]);
    s.gtop = walls[2 * i] ? count : -1;
    s.gbot = walls[2 * i + 1] ? count + m - 1 : -1;
    top = top || walls[2 * i];
    bot = bot || walls[2 * i + 1];
  }
  // One tiling for every slab: the halo one cell deeper where any slab's
  // wall row sits on a tile's edge (a deeper halo changes no written cell).
  Tiling t{};
  const int err = plan_slab(rows, side, count, 0, top ? count : -1,
                            bot ? count + m - 1 : -1, tile_rows, &t, true);
  if (err != 0) return err;
  t.b = b;
  t.omw = omw;
  const fsc::SweepParams p = fsc::make_sweep_params(
      nullptr, nullptr, nullptr, nullptr, alpha, beta, 0.0f, 0.0f, 0.0f, w,
      0);
  const auto stream_ = static_cast<cudaStream_t>(stream);
  switch (tile_rows) {
    case Tile<4>::kTileH:
      return launch_group_kernel<4>(p, t, m, group, slabs, stream_);
    case Tile<2>::kTileH:
      return launch_group_kernel<2>(p, t, m, group, slabs, stream_);
    default:
      return launch_group_kernel<1>(p, t, m, group, slabs, stream_);
  }
}

// The tiled K9's first launch of a solve (fsc_jacobi_slab_sweeps's, first
// and done 0) on a slab's split operands, B13's: x (m, side) and its (K,
// side) halos x_top and x_bot (all null: the zero guess), rhs and its
// halos rhs_top and rhs_bot, read as the rows of the (m + 2K, side)
// extended buffer they make.  It writes x_count on the band [count,
// m + 2K - count) of out and the rhs it read, pre-scaled in fast mode, at
// the band's cells that are their own interior cells of rhs_out (may be
// null): the extended buffers the launches after it read.  flags as
// fsc_jacobi_slab_sweeps's, no source fold and no Chebyshev.  Returns
// cudaErrorInvalidValue for a count, halo, tile, flag or wall row out of
// range, otherwise cudaGetLastError() after the launch.
extern "C" int fsc_jacobi_slab_sweeps_split(
    const float* x, const float* x_top, const float* x_bot, const float* rhs,
    const float* rhs_top, const float* rhs_bot, float* out, float* rhs_out,
    int side, int b, float alpha, float beta, float ab, float inv_b,
    int flags, int count, int m, int K, int gtop, int gbot, int tile_h,
    void* stream) {
  if (K < count || m < 1 || (flags & fsc::kCheby) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Tiling t{};
  const int err = plan_slab(m + 2 * K, side, count, 0, gtop, gbot, tile_h,
                            &t);
  if (err != 0) return err;
  t.b = b;
  const fsc::SweepParams p = fsc::make_sweep_params(
      nullptr, nullptr, nullptr, nullptr, alpha, beta, ab, inv_b, 0.0f, 0.0f,
      flags);
  const RowSources xs{x_top, x, x_bot}, rs{rhs_top, rhs, rhs_bot};
  const auto stream_ = static_cast<cudaStream_t>(stream);
  return tile_h == Tile<4>::kTileH
             ? launch_split<4>(p, t, xs, rs, K, m, out, rhs_out, stream_)
             : launch_split<2>(p, t, xs, rs, K, m, out, rhs_out, stream_);
}

// K9-block: `count` sweeps (1..kMaxSweeps, at most halo) of one chunk of a
// block solve on the (rows, cols) = (m + 2*halo, k + 2*halo) extended block
// buffers x (null: the zero guess) and rhs, buffer cell (0, 0) at global
// cell (gr0, gc0) of a grid of n interior cells a side, in boundary mode
// b, sweeps `first` .. `first + count - 1` of the solve.  It writes the
// (m, k) block at buffer cell (halo, halo) to out and, with kCheby, its
// x_{count-1} to xm_out.  flags: kPrep | kFast (the reciprocal form,
// rhs * inv_b built in the launch), kCheby (omegas holds `count` floats
// on the host, the ω of each sweep; sweep 0 of the solve takes none; xm,
// the extended x_{k-1}, is read where first > 0), or kDamp alone (damped
// Jacobi, w and omw).  tile_h is 64 or 32.  No output aliases an input.
// Returns cudaErrorInvalidValue for a count, shape, tile or flag out of
// range, otherwise cudaGetLastError() after the launch.
extern "C" int fsc_jacobi_block_sweeps(
    const float* x, const float* rhs, const float* xm, float* out,
    float* xm_out, int rows, int cols, int halo, int m, int k, int gr0,
    int gc0, int n, int b, float alpha, float beta, float ab, float inv_b,
    float w, float omw, const float* omegas, int flags, int first,
    int count, int tile_h, void* stream) {
  return block_sweeps<float>(x, rhs, xm, out, xm_out, rows, cols, halo, m, k,
                             gr0, gc0, n, b, alpha, beta, ab, inv_b, w, omw,
                             omegas, flags, first, count, tile_h, stream);
}

// K9-block's bf16 forms: the same launch with x, rhs, xm, out and xm_out
// all bf16.  The tile loads widen them to float32, the chunk's sweeps run
// in float32 (the pre-scaled rhs of the reciprocal form rounded to bf16
// first, as K1's bf16 form restages it) and x_count and x_{count-1} round
// to bf16 at the store: a block solve rounds once a chunk.  The damped
// form takes w and omw as the caller rounds them (bf16, as JAX's
// _mg_smooth_local takes them in p's dtype).
extern "C" int fsc_jacobi_block_sweeps_bf16(
    const void* x, const void* rhs, const void* xm, void* out, void* xm_out,
    int rows, int cols, int halo, int m, int k, int gr0, int gc0, int n,
    int b, float alpha, float beta, float ab, float inv_b, float w,
    float omw, const float* omegas, int flags, int first, int count,
    int tile_h, void* stream) {
  return block_sweeps<fsc::bf16>(x, rhs, xm, out, xm_out, rows, cols, halo,
                                 m, k, gr0, gc0, n, b, alpha, beta, ab, inv_b,
                                 w, omw, omegas, flags, first, count, tile_h,
                                 stream);
}

// K9-block grouped: one chunk of a block solve (fsc_jacobi_block_sweeps's:
// `count` sweeps, at most halo, sweeps `first` .. of the solve, flags,
// b, the coefficients, omegas) on each of `blocks` (at most kGroupBlocks)
// (m, k) blocks of a grid of n interior cells a side in one launch, each
// block's halo of `halo` cells read from its neighbours' own arrays.
// ptrs holds 29 pointers a block, on the host: the sources of x's nine
// regions of the block's extended buffer (region 3*di + dj, rows and
// columns before, in and after the block; region 4 the block's own (m, k)
// array, the others into the neighbour's array that holds them, row
// stride k, or at copies of their cells; null beyond a wall), the rhs's
// nine, x_{k-1}'s nine (read where a Chebyshev chunk has first > 0), the
// block's (m, k) output and, for Chebyshev, its x_{count-1}.  x's are all
// null for the zero guess.  ints holds 3 a block: its global origin r0,
// c0 and a bit a region whose source is a copy ((K, k) strips of row
// stride k, (m, K) strips and (K, K) corners of stride K).  tile_h: 32
// or 64 rows of 128 columns.  No output aliases an input.  Returns
// cudaErrorInvalidValue for a count, block count, shape, tile, flag or
// operand out of range, otherwise cudaGetLastError() after the launch.
extern "C" int fsc_jacobi_block_group(
    const void* const* ptrs, const int* ints, int blocks, int m, int k,
    int halo, int n, int b, float alpha, float beta, float ab, float inv_b,
    float w, float omw, const float* omegas, int flags, int first,
    int count, int tile_h, void* stream) {
  return block_group<float>(ptrs, ints, blocks, m, k, halo, n, b, alpha,
                            beta, ab, inv_b, w, omw, omegas, flags, first,
                            count, tile_h, stream);
}

// Its bf16 forms: every operand bf16, as fsc_jacobi_block_sweeps_bf16's
// (loads widen, the iterate float32 through the chunk, one rounding at
// the store).
extern "C" int fsc_jacobi_block_group_bf16(
    const void* const* ptrs, const int* ints, int blocks, int m, int k,
    int halo, int n, int b, float alpha, float beta, float ab, float inv_b,
    float w, float omw, const float* omegas, int flags, int first,
    int count, int tile_h, void* stream) {
  return block_group<fsc::bf16>(ptrs, ints, blocks, m, k, halo, n, b, alpha,
                                beta, ab, inv_b, w, omw, omegas, flags,
                                first, count, tile_h, stream);
}
