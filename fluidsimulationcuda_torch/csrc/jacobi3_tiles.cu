// K5/K13 jacobi3_sweeps: up to kMaxSweeps 7-point Chebyshev sweeps in fast
// mode (the reciprocal form) of one solve per launch, each block walking a
// (y, x) tile along z in shared memory, on a padded volume or on a plane
// range of a z-slab.
//
// Replaces the TPU kernels _jacobi3_kernel (fluidsimulationcuda_tpu/
// kernels/pallas_ops_3d.py:155, pallas_calls at :458 and, with the
// Chebyshev combine, :522) and _jacobi3_slab_kernel (kernels/
// pallas_sharded_3d.py:105, pallas_calls at :349 and :442), which run
// several sweeps per VMEM round-trip over z-plane strips with margins.
// The per-sweep K5 (jacobi3.cu) and K13 (jacobi3_slab.cu) compute the same
// sweeps one launch each; this kernel computes what `count` of their
// launches compute in that mode, bit for bit: the same expressions in the
// same order (--fmad=false, their fmaf), x_{k-1} read only at its own
// cell, every ghost cell the border rule of its interior cell's new value
// in the same sweep (faces, edges, corners: fsc::border_rule3), and the
// first sweep of a solve reading the guess as it is, ghost faces included.
//
// Bound: a solve must read its guess (none for the zero guess) and its rhs
// (the folded source is the guess) and write its result once, 8-12 bytes
// a cell, and do 8-14 float operations a cell each sweep
// (kernels/checks.py, _sweeps_cost): at 20 sweeps on 256^3 bytes bind
// (0.04-0.06 ms).  One launch a sweep moves x, rhs and x_{k-1} through HBM
// every sweep (a 67 MB field does not stay in the 50 MB L2), 12-16 bytes a
// cell, and runs such a solve at 2-5% of that bound.
//
// Design: a block of 32 x 32 threads owns an output tile of (y, x) and
// holds it with a halo `count` cells deep in a 32 x 64 tile of shared
// memory, two cells a thread (columns 32 apart).  It walks a chunk of
// output planes along z, from `count` planes before the chunk to `count`
// after it, one plane a step, as a wavefront of the launch's sweep levels:
// at step z, level 0 takes input plane z and level t (sweep t of the
// launch) computes plane z - t from level t-1's planes z-t-1 and z-t+1
// (at the cell) and z-t (its four neighbours).  Each level keeps its last
// three planes in a ring in shared memory (a thread reads another's cell
// only in plane z-t, written a step before; z-t+1 at its cell is the value
// the level below just computed, passed in a register), so one barrier
// ends a step; a thread keeps only that value, the rhs of the planes its
// levels are at and the next input plane in registers (55-64 of them, no
// spills), its loads issued a step ahead with addresses clamped into the
// volume and no branch on the cell.  Each sweep
// leaves one more ring of the tile stale, and a level's range of planes in
// the chunk shrinks by one at each end that is not a wall, so after
// `count` sweeps the tile less `count` cells on each side, over the
// chunk's planes, is exact.  The last tile of a row or a column and the
// last chunk move back to end at the volume's end, so that no output
// region starts at a ghost line, whose value derives from the line before
// it.  A ghost row or column of a plane takes the border rule of its
// interior neighbour after a second barrier, in the blocks whose tile holds
// one only; a wall ghost plane takes it from the plane next to it in the
// same level, as the walk reaches that plane.  The launch writes x_count
// over the chunk, x_{count-1} where a Chebyshev chain goes on, and in the
// first launch of a folded or fast solve the rhs it built, for the
// launches after it (the trap of pallas_ops.py:550-559).  The host picks
// the chunk so that the launch's rounds of blocks (132 SMs, one block an
// SM) times a block's steps are fewest (plan_chunk): 440 blocks of 32
// planes at 256^3 ran 3.33 rounds, 165 on a 32-plane slab 1.25.
//
// Measured on an H100 (PERF.md, dev/bench_sweeps3.py): ~100-105 us a
// sweep at 256^3 whatever the mode, against the per-sweep kernels' 87-117
// us, so it beats them only where they move three fields a sweep and it
// divides by nothing: Chebyshev solves in fast mode (1.10-1.19x), the
// only mode built here (kernels/cuda_ops.py tiled3); the Jacobi and
// dividing forms lost (0.83-0.98x) and are not built.  Registers held each
// level's planes in a first form (128 a thread, spills): 1.5x slower.
//
// A z-slab buffer of `planes` planes is walked over its plane range: sweep
// k of a segment (k = done + t, from 1) computes planes [k, planes - k)
// (jacobi3_slab.cu) between the wall ghost planes gtop and gbot where the
// slab has them (planes beyond a wall influence no slab plane, so they are
// not computed).  A volume is the buffer of `side` planes with walls at 0
// and side - 1 and no shrinking.
//
// It also has a bf16 storage form, on a volume (fsc_jacobi3_sweeps_bf16,
// JAX's bf16 mode) and on a z-slab (fsc_jacobi3_slab_sweeps_bf16): the rhs is
// read as bf16, and the rhs a first launch builds is rounded to bf16
// before any sweep reads it; the iterate stays float32 in shared memory
// within a launch and in the float32 scratch between launches (x_{k-1}
// too); the caller's guess is read as bf16 (as x_k by the first launch,
// as x_{k-1} by a second after a 1-sweep first) and the launch that ends
// the solve writes bf16.  So a solve rounds once, at its end, whatever its
// launches, as the per-sweep K5's bf16 form does: each a template
// instantiation over the types of x, x_{k-1}, rhs and out.  On a z-slab
// the solve runs in segments between halo exchanges: a segment after the
// first reads the float32 iterate (and x_{k-1}) the one before it wrote,
// and only the segment that ends the solve writes bf16, so the slab walk
// computes what the per-sweep K13's bf16 form computes, bit for bit.
#include <atomic>

#include "fsc_common.cuh"

namespace {

constexpr int kLanes = fsc::kBlockX;  // a warp: 32 columns of one row
constexpr int kWarps = 32;            // a block's rows of warps
constexpr int kCols = 2;              // a thread's columns, 32 apart
constexpr int kRows = 1;              // a thread's rows, kWarps apart
constexpr int kTileW = kLanes * kCols;
constexpr int kTileH = kWarps * kRows;
constexpr int kThreads = kLanes * kWarps;
constexpr int kCells = kCols * kRows;
constexpr int kPlane = kTileW * kTileH;  // floats of one tile plane
constexpr int kMaxSweeps = 6;
// Devices whose shared-memory attribute launch_kernel keeps.
constexpr int kDevices = 64;

// One launch's geometry and its sweeps.
struct Walk {
  int side, b;
  int count;       // sweeps of this launch
  int gtop, gbot;  // wall ghost planes, -1 where the buffer has none
  int chunk;       // output planes a block walks (plan_chunk)
  // Planes [lo[t], hi[t]) are those sweep t of the launch computes (t = 0:
  // the input's valid planes).
  int lo[kMaxSweeps + 1], hi[kMaxSweeps + 1];
  int first_combine;    // the first level with the Chebyshev combine
  float w[kMaxSweeps];  // ω of each sweep of the launch
};

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

template <int kT, typename TX, typename TM, typename TR, typename TO>
__global__ void __launch_bounds__(kThreads, 1)
    jacobi3_sweeps_kernel(fsc::SweepParamsT<TX, TM, TR> p, Walk g,
                          TO* __restrict__ out, float* __restrict__ xm_out,
                          TR* __restrict__ rhs_out) {
  extern __shared__ float smem[];
  // Level t keeps its last three planes, plane z in slot z % 3; at step z
  // (s = z % 3) ring(t, d) is level t's plane z - d, 0 <= d.
  int s = 0;
  const auto ring = [&](int t, int d) {
    const int k = s - d % 3;
    return smem + (3 * t + (k < 0 ? k + 3 : k)) * kPlane;
  };
  const int side = g.side;
  const int plane = side * side;
  const int out_w = kTileW - 2 * kT;
  const int out_h = kTileH - 2 * kT;
  // The columns and rows this block writes, and its tile's origin: the
  // last tile moves back to end at the volume's end.
  const int wc0 = static_cast<int>(blockIdx.x) * out_w;
  const int wr0 = static_cast<int>(blockIdx.y) * out_h;
  const int wc1 = imin(wc0 + out_w, side);
  const int wr1 = imin(wr0 + out_h, side);
  const int c0 = imin(wc0, imax(side - out_w, 0)) - kT;
  const int r0 = imin(wr0, imax(side - out_h, 0)) - kT;
  // The planes this block writes, and the planes each level computes in
  // its walk (a chunk that does not start at a wall reads kT planes before
  // it, and so on up the levels).
  const int zw0 = g.lo[kT] + static_cast<int>(blockIdx.z) * g.chunk;
  const int zw1 = imin(zw0 + g.chunk, g.hi[kT]);
  const int zs = imax(g.lo[kT], imin(zw0, g.hi[kT] - g.chunk));
  int lo[kT + 1], hi[kT + 1];
  lo[0] = imax(g.lo[0], zs - kT);
  hi[0] = imin(g.hi[0], zw1 + kT);
#pragma unroll
  for (int t = 1; t <= kT; ++t) {
    lo[t] = lo[t - 1] == g.gtop ? g.gtop : imax(g.lo[t], lo[t - 1] + 1);
    hi[t] = hi[t - 1] - 1 == g.gbot ? hi[t - 1]
                                     : imin(g.hi[t], hi[t - 1] - 1);
  }
  // Cell q of the thread: tile cell (row(q), col(q)), grid cell (r0 +
  // row(q), c0 + col(q)).
  const auto row = [](int q) {
    return static_cast<int>(threadIdx.y) + kWarps * (q / kCols);
  };
  const auto col = [](int q) {
    return static_cast<int>(threadIdx.x) + kLanes * (q % kCols);
  };
  const int n = side - 2;
  int at[kCells];        // in-plane index of the cell, clamped into the grid
  unsigned in_grid = 0;  // bit q: the cell lies in the grid
  unsigned inner = 0;    // bit q: an interior column of the grid
  unsigned ghost = 0;    // bit q: a ghost row or column off the tile's ring
  unsigned kept = 0;     // bit q: the block writes the cell
  unsigned gx = 0, gy = 0;  // bit q: a ghost column, a ghost row
  int nb[kCells];        // tile offset of a ghost cell's interior cell
#pragma unroll
  for (int q = 0; q < kCells; ++q) {
    const int gr = r0 + row(q);
    const int gc = c0 + col(q);
    at[q] = fsc::clampi(gr, 0, side - 1) * side + fsc::clampi(gc, 0, side - 1);
    const bool grid = gr >= 0 && gr < side && gc >= 0 && gc < side;
    const bool interior = gr >= 1 && gr <= n && gc >= 1 && gc <= n;
    const int di = gr == 0 ? 1 : (gr == side - 1 ? -1 : 0);
    const int dj = gc == 0 ? 1 : (gc == side - 1 ? -1 : 0);
    nb[q] = di * kTileW + dj;
    gx |= unsigned(dj != 0) << q;
    gy |= unsigned(di != 0) << q;
    in_grid |= unsigned(grid) << q;
    inner |= unsigned(interior) << q;
    if (grid && !interior && row(q) >= 1 && row(q) < kTileH - 1 &&
        col(q) >= 1 && col(q) < kTileW - 1)
      ghost |= 1u << q;
    if (gr >= wr0 && gr < wr1 && gc >= wc0 && gc < wc1) kept |= 1u << q;
  }
  const auto bit = [](unsigned m, int q) { return ((m >> q) & 1u) != 0u; };
  const auto cell = [&](int q) { return row(q) * kTileW + col(q); };
  // The tile holds a ghost row or column of the grid.
  const bool edge =
      r0 <= 0 || r0 + kTileH >= side || c0 <= 0 || c0 + kTileW >= side;
  // A ghost cell's value from its interior cell's in `from` (a tile plane
  // of the same level), as fsc::border_value3 derives it.
  const auto ghost_value = [&](const float* from, int q, int i, bool gz) {
    return fsc::border_rule3(from[i + nb[q]], bit(gx, q), bit(gy, q), gz,
                             g.b);
  };

  float rhs[kT + 1][kCells];          // rhs[t]: the rhs of plane z - t
  float xmr[2][kCells];               // x_{k-1} input, planes z and z - 1
  float nx[kCells], nr[kCells], ns[kCells], nm[kCells];  // the next plane
  // The value the last level computed at each cell in this step: level t's
  // plane z-t+1 neighbour, which it reads at its own cell.
  float up[kCells];
#pragma unroll
  for (int q = 0; q < kCells; ++q) {
#pragma unroll
    for (int t = 0; t <= kT; ++t) rhs[t][q] = 0.0f;
    xmr[0][q] = xmr[1][q] = 0.0f;
    nx[q] = nr[q] = ns[q] = nm[q] = up[q] = 0.0f;
  }
  // Planes a level never computed in this walk are zeros, not stale bits.
  for (int i = static_cast<int>(threadIdx.y * kLanes + threadIdx.x);
       i < 3 * (kT + 1) * kPlane; i += kThreads)
    smem[i] = 0.0f;
  // Issue the loads of input plane z into the next-plane registers.
  const auto fetch = [&](int z) {
    const int base = z * plane;
#pragma unroll
    for (int q = 0; q < kCells; ++q) {
      nx[q] = p.x ? fsc::load(p.x, base + at[q]) : 0.0f;
      nr[q] = fsc::load(p.rhs, base + at[q]);
      ns[q] = p.src ? fsc::load(p.src, base + at[q]) : 0.0f;
      nm[q] = p.xm ? fsc::load(p.xm, base + at[q]) : 0.0f;
    }
  };
  const int last = hi[kT] - 1 + kT;  // the step at which level kT ends
  if (lo[0] < hi[0]) fetch(lo[0]);
  s = lo[0] % 3;
  __syncthreads();
  for (int z = lo[0]; z <= last; ++z, s = s == 2 ? 0 : s + 1) {
    // Level 0: input plane z, from the registers fetched a step before.
#pragma unroll
    for (int q = 0; q < kCells; ++q) {
#pragma unroll
      for (int t = kT; t >= 1; --t) rhs[t][q] = rhs[t - 1][q];
      xmr[1][q] = xmr[0][q];
    }
    if (z < hi[0]) {
      const bool own = z != g.gtop && z != g.gbot && z >= zw0 && z < zw1;
      float* const b0 = ring(0, 0);
#pragma unroll
      for (int q = 0; q < kCells; ++q) {
        up[q] = bit(in_grid, q) ? nx[q] : 0.0f;
        b0[cell(q)] = up[q];
        // The rhs as fsc::rhs_at builds it in fast mode: base +
        // src_dt*src, times 1/beta, rounded to the rhs's storage type.
        float r = nr[q];
        if (p.flags & fsc::kPrep) {
          if (p.src) r = r + p.src_dt * ns[q];
          r = fsc::round_to<TR>(r * p.inv_b);
        }
        rhs[0][q] = r;
        xmr[0][q] = nm[q];
        // The first launch of a folded or fast solve stores the rhs it
        // built, once per interior cell, for the launches after it.
        if (rhs_out != nullptr && own && bit(inner, q) && bit(kept, q))
          fsc::store(rhs_out, z * plane + at[q], r);
      }
      if (z + 1 < hi[0]) fetch(z + 1);
    }
    // Levels 1..kT: level t computes plane z - t from level t-1's planes
    // z-t-1 (at the cell), z-t (its four neighbours) and z-t+1 (at the
    // cell, computed earlier in this step by the same thread: up).  A level
    // that runs here ran the level below it at plane z-t+1 in this step,
    // on every row it computes.
#pragma unroll
    for (int t = 1; t <= kT; ++t) {
      const int zt = z - t;
      if (zt < lo[t] || zt >= hi[t] || zt == g.gtop) continue;
      float* const nxt = ring(t, t);
      if (zt == g.gbot) {
        // The wall plane below takes the plane above it, same level.
        const float* const above = ring(t, t + 1);
#pragma unroll
        for (int q = 0; q < kCells; ++q) {
          up[q] = fsc::border_rule3(above[cell(q)], false, false, true, g.b);
          nxt[cell(q)] = up[q];
        }
        continue;
      }
      const bool combine = t >= g.first_combine;
      const float* const cur = ring(t - 1, t);
      const float* const front = ring(t - 1, t + 1);
      const float* const prev = ring(t >= 2 ? t - 2 : 0, t);
      const bool top = zt == g.gtop + 1 && g.gtop >= 0;
      float* const wall = ring(t, t + 1);
#pragma unroll
      for (int q = 0; q < kCells; ++q) {
        const int r = row(q);
        if (r < t || r >= kTileH - t) continue;
        const int i = cell(q);
        const float neigh =
            ((cur[i - 1] + cur[i + 1]) + (cur[i - kTileW] + cur[i + kTileW])) +
            (front[i] + up[q]);
        float val = fmaf(p.ab, neigh, rhs[t][q]);
        if (combine)
          val = fsc::cheby_combine(g.w[t - 1], val,
                                   t == 1 ? xmr[1][q] : prev[i]);
        nxt[i] = val;
        up[q] = val;
        // The wall plane above takes the plane below it, same level.
        if (top) wall[i] = fsc::border_rule3(val, false, false, true, g.b);
      }
    }
    // The launch's outputs at plane z - kT (and at a wall plane beside
    // it), at the block's cells off the ghost rows and columns (those
    // follow the barrier): x_count from level kT's planes, and x_{count-1}
    // from level kT-1's, whose ghost rows and columns the last step set.
    {
      const int zt = z - kT;
      const bool on = zt >= lo[kT] && zt < hi[kT];
      const bool mid = on && zt != g.gtop && zt != g.gbot && zt >= zw0 &&
                       zt < zw1;
      const bool top = on && g.gtop >= 0 && zt == g.gtop + 1 &&
                       g.gtop >= zw0 && g.gtop < zw1;
      const bool bot = on && zt == g.gbot && zt >= zw0 && zt < zw1;
#pragma unroll
      for (int q = 0; q < kCells; ++q) {
        if (!bit(kept, q)) continue;
        const int i = cell(q);
        if (bit(inner, q)) {
          if (mid || bot) fsc::store(out, zt * plane + at[q], up[q]);
          if (top)
            fsc::store(out, g.gtop * plane + at[q],
                       fsc::border_rule3(up[q], false, false, true, g.b));
        }
        if (kT >= 2 && xm_out != nullptr) {
          const float* const prev = ring(kT - 1, kT);
          if (mid) xm_out[zt * plane + at[q]] = prev[i];
          if (top)
            xm_out[g.gtop * plane + at[q]] = ghost_value(prev, q, i, true);
          if (bot)
            xm_out[zt * plane + at[q]] =
                ghost_value(ring(kT - 1, kT + 1), q, i, true);
        }
      }
    }
    __syncthreads();
    if (edge) {
      // Ghost rows and columns: each level's at its plane of the step
      // (level kT's straight to out), from its interior cells' new values.
#pragma unroll
      for (int t = 1; t <= kT; ++t) {
        const int zt = z - t;
        if (zt < lo[t] || zt >= hi[t]) continue;
#pragma unroll
        for (int q = 0; q < kCells; ++q) {
          const int r = row(q);
          if (!bit(ghost, q) || r < t || r >= kTileH - t) continue;
          const int i = cell(q);
          if (t < kT) {
            if (zt != g.gtop && zt != g.gbot) {
              float* const cur = ring(t, t);
              cur[i] = ghost_value(cur, q, i, false);
            }
            continue;
          }
          if (!bit(kept, q)) continue;
          if (zt != g.gtop && zt != g.gbot && zt >= zw0 && zt < zw1)
            fsc::store(out, zt * plane + at[q],
                       ghost_value(ring(t, t), q, i, false));
          if (g.gtop >= 0 && zt == g.gtop + 1 && g.gtop >= zw0 &&
              g.gtop < zw1)
            fsc::store(out, g.gtop * plane + at[q],
                       ghost_value(ring(t, t), q, i, true));
          if (zt == g.gbot && zt >= zw0 && zt < zw1)
            fsc::store(out, zt * plane + at[q],
                       ghost_value(ring(t, t + 1), q, i, true));
        }
      }
      __syncthreads();
    }
  }
}

// The walk of a launch of `count` sweeps on a buffer of `planes` planes of
// side^2 cells: with `shrink` (a z-slab), sweep t computes planes
// [done + t, planes - done - t), within the walls gtop..gbot where present;
// otherwise (a volume) every plane.
int plan_walk(int planes, int side, int count, int done, bool shrink,
              int gtop, int gbot, Walk* g) {
  if (count < 1 || count > kMaxSweeps || side < 3 || planes < 3 || done < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  g->side = side;
  g->count = count;
  g->gtop = gtop;
  g->gbot = gbot;
  for (int t = 0; t <= kMaxSweeps; ++t) {
    int lo = shrink ? done + t : 0;
    int hi = shrink ? planes - done - t : planes;
    if (gtop >= 0) lo = imax(lo, gtop);
    if (gbot >= 0) hi = imin(hi, gbot + 1);
    g->lo[t] = lo;
    g->hi[t] = hi;
  }
  return 0;
}

// The output planes a block walks, for a launch of `tiles` (y, x) tiles
// over `span` planes on a card that runs `slots` blocks at once: the count
// of chunks that makes the fewest rounds of blocks times steps of a
// block's walk (its chunk, and 3 * count planes of warm-up and drain),
// each chunk at least 2 planes.
int plan_chunk(int span, int tiles, int slots, int count) {
  int chunk = span;
  long long best = -1;
  for (int c = 1; c <= imax(1, span / 2); ++c) {
    const int z = (span + c - 1) / c;
    const long long rounds =
        (static_cast<long long>(tiles) * c + slots - 1) / slots;
    const long long cost = rounds * (z + 3 * count);
    if (best < 0 || cost < best) {
      best = cost;
      chunk = z;
    }
  }
  return chunk;
}

template <int kT, typename TX, typename TM, typename TR, typename TO>
int launch_kernel(const fsc::SweepParamsT<TX, TM, TR>& p, const Walk& g,
                  TO* out, float* xm_out, TR* rhs_out, cudaStream_t stream) {
  const auto kernel = jacobi3_sweeps_kernel<kT, TX, TM, TR, TO>;
  const int smem = 3 * (kT + 1) * kPlane * static_cast<int>(sizeof(float));
  // The dynamic shared-memory attribute is each device's: set once a
  // device, its cudaError_t + 1 kept (0: not set yet) and returned after;
  // then the blocks an SM holds, kept + 1 the same way.
  static std::atomic<int> attribute[kDevices];
  static std::atomic<int> resident[kDevices];
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
  err = attribute[device].load() - 1;
  if (err != 0) return err;
  if (resident[device].load() == 0) {
    int blocks = 0;
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kThreads, smem));
    if (err != 0) return err;
    resident[device].store(1 + imax(blocks, 1));
  }
  int sms = 0;
  err = static_cast<int>(
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  if (err != 0) return err;
  const int out_w = kTileW - 2 * kT;
  const int out_h = kTileH - 2 * kT;
  const int span = g.hi[kT] - g.lo[kT];
  if (span <= 0) return 0;
  const int tiles_x = (g.side + out_w - 1) / out_w;
  const int tiles_y = (g.side + out_h - 1) / out_h;
  Walk w = g;
  w.chunk = plan_chunk(span, tiles_x * tiles_y,
                       imax(sms, 1) * (resident[device].load() - 1), kT);
  const dim3 grid(tiles_x, tiles_y, (span + w.chunk - 1) / w.chunk);
  kernel<<<grid, dim3(kLanes, kWarps), smem, stream>>>(p, w, out, xm_out,
                                                       rhs_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TM, typename TR, typename TO>
int launch_count(const fsc::SweepParamsT<TX, TM, TR>& p, const Walk& g,
                 TO* out, float* xm_out, TR* rhs_out, cudaStream_t stream) {
  switch (g.count) {
    case 1:
      return launch_kernel<1>(p, g, out, xm_out, rhs_out, stream);
    case 2:
      return launch_kernel<2>(p, g, out, xm_out, rhs_out, stream);
    case 3:
      return launch_kernel<3>(p, g, out, xm_out, rhs_out, stream);
    case 4:
      return launch_kernel<4>(p, g, out, xm_out, rhs_out, stream);
    case 5:
      return launch_kernel<5>(p, g, out, xm_out, rhs_out, stream);
    case 6:
      return launch_kernel<6>(p, g, out, xm_out, rhs_out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One launch of the walk g: x and src stored as TX, x_{k-1} as TM, rhs and
// rhs_out as TR, out as TO; x_{count-1} float32.
template <typename TX, typename TM, typename TR, typename TO>
int launch_walk(const void* x, const void* rhs, const void* src,
                const void* xm, void* out, float* xm_out, void* rhs_out,
                int b, float alpha, float beta, float ab, float inv_b,
                float src_dt, const float* omegas, int flags, int first,
                Walk* g, void* stream) {
  // The one mode built: a Chebyshev solve in fast mode.
  if (first < 0 || (flags & fsc::kCheby) == 0 || (flags & fsc::kFast) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  g->b = b;
  g->first_combine = first == 0 ? 2 : 1;
  for (int s = 0; s < kMaxSweeps; ++s)
    g->w[s] = s < g->count ? omegas[s] : 0.0f;
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
  p.flags = flags & ~fsc::kCheby;
  return launch_count(p, *g, static_cast<TO*>(out), xm_out,
                      static_cast<TR*>(rhs_out),
                      static_cast<cudaStream_t>(stream));
}

// The bf16 form's launch of out's type.
template <typename TX, typename TM>
int launch_walk_bf16(bool out_bf16, const void* x, const void* rhs,
                     const void* src, const void* xm, void* out,
                     float* xm_out, void* rhs_out, int b, float alpha,
                     float beta, float ab, float inv_b, float src_dt,
                     const float* omegas, int flags, int first, Walk* g,
                     void* stream) {
  const auto launch = out_bf16 ? launch_walk<TX, TM, fsc::bf16, fsc::bf16>
                               : launch_walk<TX, TM, fsc::bf16, float>;
  return launch(x, rhs, src, xm, out, xm_out, rhs_out, b, alpha, beta, ab,
                inv_b, src_dt, omegas, flags, first, g, stream);
}

}  // namespace

// `count` sweeps (1..kMaxSweeps) of a Chebyshev solve in fast mode on a
// (side, side, side) volume whose sweeps are numbered from 0, the first of
// them sweep `first`.  x, src, xm, xm_out and rhs_out may be null
// (fsc::SweepParams; xm_out: x_{count-1} not wanted, rhs_out: the rhs
// built not kept).  flags as fsc_jacobi3_sweep's, with kCheby and kFast
// set whatever `first` is (the solve's sweep 0 takes no combine); omegas
// holds `count` floats on the host, the ω of each sweep.  No output
// aliases an input or another output.  Returns a cudaError_t:
// cudaErrorInvalidValue for a count out of range or flags without kCheby
// and kFast, otherwise cudaGetLastError() after the launch.
extern "C" int fsc_jacobi3_sweeps(const float* x, const float* rhs,
                                  const float* src, const float* xm,
                                  float* out, float* xm_out, float* rhs_out,
                                  int side, int b, float alpha, float beta,
                                  float ab, float inv_b, float src_dt,
                                  const float* omegas, int flags, int first,
                                  int count, void* stream) {
  Walk g;
  const int err = plan_walk(side, side, count, 0, false, 0, side - 1, &g);
  if (err != 0) return err;
  return launch_walk<float, float, float, float>(
      x, rhs, src, xm, out, xm_out, rhs_out, b, alpha, beta, ab, inv_b,
      src_dt, omegas, flags, first, &g, stream);
}

// The bf16 form on a volume (JAX's bf16 storage, the per-sweep K5's bf16
// rule): rhs and rhs_out hold bf16, the rhs built rounded to bf16 before
// any sweep reads it; types says which of x (1, src too), xm (2) and out
// (4) hold bf16, the others float32 (x_{k-1} is read as bf16 only where x
// is not: types 3 is refused); xm_out is float32.  Returns a cudaError_t
// as fsc_jacobi3_sweeps does.
extern "C" int fsc_jacobi3_sweeps_bf16(
    const void* x, const void* rhs, const void* src, const void* xm,
    void* out, float* xm_out, void* rhs_out, int side, int b, float alpha,
    float beta, float ab, float inv_b, float src_dt, const float* omegas,
    int flags, int first, int count, int types, void* stream) {
  if ((types & 3) == 3) return static_cast<int>(cudaErrorInvalidValue);
  Walk g;
  const int err = plan_walk(side, side, count, 0, false, 0, side - 1, &g);
  if (err != 0) return err;
  const auto launch = (types & 1) ? launch_walk_bf16<fsc::bf16, float>
                      : (types & 2) ? launch_walk_bf16<float, fsc::bf16>
                                    : launch_walk_bf16<float, float>;
  return launch((types & 4) != 0, x, rhs, src, xm, out, xm_out, rhs_out, b,
                alpha, beta, ab, inv_b, src_dt, omegas, flags, first, &g,
                stream);
}

// The same on a (planes, side, side) z-slab buffer (fsc_jacobi3_slab's):
// `done` sweeps of the segment ran before this launch, so its sweep t
// computes planes [done + t, planes - done - t) between the wall ghost
// planes gtop and gbot (buffer planes, -1 when absent), and x is valid on
// planes [done, planes - done).
extern "C" int fsc_jacobi3_slab_sweeps(
    const float* x, const float* rhs, const float* src, const float* xm,
    float* out, float* xm_out, float* rhs_out, int side, int b, float alpha,
    float beta, float ab, float inv_b, float src_dt, const float* omegas,
    int flags, int first, int count, int planes, int done, int gtop,
    int gbot, void* stream) {
  Walk g;
  const int err =
      plan_walk(planes, side, count, done, true, gtop, gbot, &g);
  if (err != 0) return err;
  return launch_walk<float, float, float, float>(
      x, rhs, src, xm, out, xm_out, rhs_out, b, alpha, beta, ab, inv_b,
      src_dt, omegas, flags, first, &g, stream);
}

// The bf16 form on a z-slab buffer: fsc_jacobi3_slab_sweeps' geometry with
// fsc_jacobi3_sweeps_bf16's operand types (rhs and rhs_out bf16; types
// says which of x, xm and out hold bf16; types 3 is refused).  Returns a
// cudaError_t as fsc_jacobi3_slab_sweeps does.
extern "C" int fsc_jacobi3_slab_sweeps_bf16(
    const void* x, const void* rhs, const void* src, const void* xm,
    void* out, float* xm_out, void* rhs_out, int side, int b, float alpha,
    float beta, float ab, float inv_b, float src_dt, const float* omegas,
    int flags, int first, int count, int planes, int done, int gtop,
    int gbot, int types, void* stream) {
  if ((types & 3) == 3) return static_cast<int>(cudaErrorInvalidValue);
  Walk g;
  const int err =
      plan_walk(planes, side, count, done, true, gtop, gbot, &g);
  if (err != 0) return err;
  const auto launch = (types & 1) ? launch_walk_bf16<fsc::bf16, float>
                      : (types & 2) ? launch_walk_bf16<float, fsc::bf16>
                                    : launch_walk_bf16<float, float>;
  return launch((types & 4) != 0, x, rhs, src, xm, out, xm_out, rhs_out, b,
                alpha, beta, ab, inv_b, src_dt, omegas, flags, first, &g,
                stream);
}
