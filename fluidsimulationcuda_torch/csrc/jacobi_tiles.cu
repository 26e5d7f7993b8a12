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
#include <atomic>
#include <type_traits>

#include "fsc_common.cuh"

namespace {

constexpr int kLanes = fsc::kBlockX;  // a warp: 32 columns of one row
constexpr int kWarps = 16;            // a block's rows of warps
constexpr int kCols = 4;              // a thread's columns, 32 apart
constexpr int kRows = 4;              // a thread's rows, 16 apart
constexpr int kTileW = kLanes * kCols;
constexpr int kTileH = kWarps * kRows;
constexpr int kThreads = kLanes * kWarps;
constexpr int kCells = kCols * kRows;
constexpr int kMaxSweeps = 20;  // JAX's max_fused
constexpr int kSmem = 2 * kTileW * kTileH * static_cast<int>(sizeof(float));
// Devices whose shared-memory attribute launch_kernel keeps.
constexpr int kDevices = 64;

// One launch's tiling and its sweeps.
struct Tiling {
  int side, b, nb1, b1;
  int count;          // sweeps of this launch
  int margin;         // halo depth: count, or count + 1 (plan_tiling)
  int out_w, out_h;   // the output tile
  int first_combine;  // the first sweep of the launch with the Chebyshev
                      // combine: 1 where the launch starts the solve
  float w[kMaxSweeps];  // ω of each sweep of the launch
};

// One sweep of the tile's rows [lo, hi) from cur into nxt, every column
// but the tile's first and last (whose reads wrap to the next and the
// previous row, in bounds, their values stale as the halo's are).  Ghost
// cells and cells past the grid take the interior update of their own
// (zero) rhs here; the ghost cells are set after it (jacobi_sweeps_kernel)
// and nothing exact reads the others.
template <bool kCheby, bool kFast, bool kCombine, typename TX, typename TM,
          typename TR>
__device__ __forceinline__ void sweep_tile(
    const fsc::SweepParamsT<TX, TM, TR>& p, const float* cur, float* nxt,
    const float (&rhs)[kCells], float (&xm)[kCheby ? kCells : 1], float w,
    int lo, int hi) {
#pragma unroll
  for (int rb = 0; rb < kRows; ++rb) {
    const int lr = static_cast<int>(threadIdx.y) + kWarps * rb;
    if (lr < lo || lr >= hi) continue;
#pragma unroll
    for (int cb = 0; cb < kCols; ++cb) {
      const int q = rb * kCols + cb;
      const int i = lr * kTileW + static_cast<int>(threadIdx.x) + kLanes * cb;
      const float neigh =
          ((cur[i - 1] + cur[i + 1]) + cur[i - kTileW]) + cur[i + kTileW];
      float val = kFast ? fmaf(p.ab, neigh, rhs[q])
                        : (rhs[q] + p.alpha * neigh) / p.beta;
      if constexpr (kCheby) {
        if (kCombine) val = fsc::cheby_combine(w, val, xm[q]);
        xm[q] = cur[i];
      }
      nxt[i] = val;
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
  float* cur = tile;                     // x_k
  float* nxt = tile + kTileW * kTileH;  // x_{k+1}
  const int side = t.side;
  const int n = side - 2;
  const int off = fsc::grid_offset(side);
  const int mode = static_cast<int>(blockIdx.z) < t.nb1 ? t.b : t.b1;
  const int r0 = static_cast<int>(blockIdx.y) * t.out_h - t.margin;
  const int c0 = static_cast<int>(blockIdx.x) * t.out_w - t.margin;
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
    return r0 + row(q) >= 0 && r0 + row(q) < side && c0 + col(q) >= 0 &&
           c0 + col(q) < side;
  };
  // The interior cell a cell derives from (fsc::interior_of clamps).
  const auto inner = [&](int q) {
    return off + fsc::interior_of(r0 + row(q), c0 + col(q), side);
  };
  float rhs[kCells];
  float xm[kCheby ? kCells : 1];
  {
    float x[kCells];
#pragma unroll
    for (int q = 0; q < kCells; ++q) x[q] = 0.0f;
    if (p.x) {
#pragma unroll
      for (int q = 0; q < kCells; ++q)
        x[q] = fsc::load(p.x, off + fsc::clampi(r0 + row(q), 0, side - 1) *
                                        side +
                                    fsc::clampi(c0 + col(q), 0, side - 1));
    }
#pragma unroll
    for (int q = 0; q < kCells; ++q) {
      const float v = in_grid(q) ? x[q] : 0.0f;
      cur[row(q) * kTileW + col(q)] = v;
      nxt[row(q) * kTileW + col(q)] = v;
    }
  }
  // The rhs as fsc::rhs_at builds it: base + src_dt*src, times 1/beta in
  // fast mode, rounded to its storage type.
#pragma unroll
  for (int q = 0; q < kCells; ++q) rhs[q] = fsc::load(p.rhs, inner(q));
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
  if constexpr (kCheby) {
#pragma unroll
    for (int q = 0; q < kCells; ++q) xm[q] = 0.0f;
    if (p.xm) {
#pragma unroll
      for (int q = 0; q < kCells; ++q) xm[q] = fsc::load(p.xm, inner(q));
    }
  }
  // Bit q: own cell q is a ghost cell of the grid off the tile's outer
  // ring (set from its interior neighbour after each sweep).
  unsigned ghost = 0u;
#pragma unroll
  for (int q = 0; q < kCells; ++q) {
    const int gr = r0 + row(q);
    const int gc = c0 + col(q);
    const bool interior = gr >= 1 && gr <= n && gc >= 1 && gc <= n;
    if (in_grid(q) && !interior && row(q) >= 1 && row(q) < kTileH - 1 &&
        col(q) >= 1 && col(q) < kTileW - 1)
      ghost |= 1u << q;
    // The first launch of a folded or fast solve stores the rhs it built,
    // once per interior cell, for the launches after it.
    const bool kept = row(q) >= t.margin && row(q) < t.margin + t.out_h &&
                      col(q) >= t.margin && col(q) < t.margin + t.out_w;
    if (rhs_out != nullptr && interior && kept)
      fsc::store(rhs_out, off + gr * side + gc, rhs[q]);
  }
  // The tile holds a ghost row or column of the grid.
  const bool edge =
      r0 <= 0 || r0 + kTileH >= side || c0 <= 0 || c0 + kTileW >= side;
  __syncthreads();
  for (int s = 0; s < t.count; ++s) {
    // After s sweeps rows [s, kTileH - s) of the tile are exact.
    const int lo = s + 1;
    const int hi = kTileH - 1 - s;
    if (kCheby && s >= t.first_combine)
      sweep_tile<kCheby, kFast, true>(p, cur, nxt, rhs, xm, t.w[s], lo, hi);
    else
      sweep_tile<kCheby, kFast, false>(p, cur, nxt, rhs, xm, 0.0f, lo, hi);
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
          const int gr = r0 + lr;
          const int gc = c0 + lc;
          const int di = gr == 0 ? 1 : (gr == side - 1 ? -1 : 0);
          const int dj = gc == 0 ? 1 : (gc == side - 1 ? -1 : 0);
          const int i = lr * kTileW + lc;
          nxt[i] = fsc::border_rule(nxt[i + di * kTileW + dj], dj != 0,
                                    di != 0, mode);
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
    const int gr = r0 + lr;
    if (lr < t.margin || lr >= t.margin + t.out_h || gr >= side) continue;
#pragma unroll
    for (int cb = 0; cb < kCols; ++cb) {
      const int lc = static_cast<int>(threadIdx.x) + kLanes * cb;
      const int gc = c0 + lc;
      if (lc < t.margin || lc >= t.margin + t.out_w || gc >= side) continue;
      const int g = off + gr * side + gc;
      const int i = lr * kTileW + lc;
      fsc::store(out, g, cur[i]);
      if (xm_out != nullptr) xm_out[g] = nxt[i];
    }
  }
}

// The tiling of a launch of `count` sweeps on grids of `side`: a halo of
// `count` cells, one more where the last tile of a row or column of tiles
// would hold only the grid's last ghost row or column (its value derives
// from the row before, which a halo of `count` leaves stale).
int plan_tiling(int side, int count, Tiling* t) {
  if (count < 1 || count > kMaxSweeps || side < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  t->margin = count;
  t->out_w = kTileW - 2 * count;
  t->out_h = kTileH - 2 * count;
  if (side % t->out_w == 1 || side % t->out_h == 1) {
    t->margin = count + 1;
    t->out_w -= 2;
    t->out_h -= 2;
  }
  t->side = side;
  t->count = count;
  return 0;
}

template <bool kCheby, bool kFast, typename TX, typename TM, typename TR,
          typename TO>
int launch_kernel(const fsc::SweepParamsT<TX, TM, TR>& p, const Tiling& t,
                  void* out, float* xm_out, void* rhs_out, int nb,
                  cudaStream_t stream) {
  const auto kernel = jacobi_sweeps_kernel<kCheby, kFast, TX, TM, TR, TO>;
  // The dynamic shared-memory attribute is each device's: set once a
  // device, its cudaError_t + 1 kept (0: not set yet) and returned after.
  static std::atomic<int> attribute[kDevices];
  int device = 0;
  int err = static_cast<int>(cudaGetDevice(&device));
  if (err != 0) return err;
  if (device < 0 || device >= kDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  if (attribute[device].load() == 0)
    attribute[device].store(1 + static_cast<int>(cudaFuncSetAttribute(
                                    kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kSmem)));
  err = attribute[device].load() - 1;
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
  Tiling t;
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
