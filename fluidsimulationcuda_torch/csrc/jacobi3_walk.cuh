// The vector form of the per-sweep 3-D Jacobi sweeps: one device body that
// K5 (jacobi3.cu, a whole volume) and K13 (jacobi3_slab.cu, planes [lo, hi)
// of a z-slab buffer) both launch, in float32 and in bf16 storage.
//
// The one-cell kernels give a thread one cell: six scalar loads of the
// iterate, one load of the rhs and one store a cell, the iterate's z
// neighbours a plane apart.  Narrow loads, not bytes, set their time: in
// bf16 a middle sweep moves 10 bytes a cell (a float32 iterate, a bf16 rhs,
// a float32 output) against float32's 12, and still took longer than the
// float32 sweep (PERF.md §6).  Here a thread owns V consecutive cells of a
// row (x) and walks `walk` planes in z:
//
// - the iterate's rows come in V-cell vector loads on the read-only path
//   (16 bytes at V = 4 in float32), the rhs, x_{k-1} and the source in
//   V-cell loads of their own type, the output in one V-cell store;
// - the thread keeps rows kc-1, kc and kc+1 of its cells in registers
//   (back, mid, ahead) and moves them one plane on as it walks, so a plane
//   loads the iterate's row kc+1 (with the two cells left and right of the
//   vector, two scalar loads) and the rows above and below: about three
//   loads a plane where the one-cell kernel issues six a cell;
// - every cell does the one-cell kernel's arithmetic in its order: the rhs
//   built as rhs_at builds it, the neighbour sum ((L+R)+(U+D))+(F+B),
//   jacobi_update, the Chebyshev combine, border_rule3, so the two forms
//   agree bit for bit.
//
// Ghost cells follow the one-cell kernels' rule: a ghost cell evaluates its
// interior cell and applies the border rule.  Column 0 derives from column
// 1 and column side-1 from side-2, both in the same vector (ghost_shift);
// row i evaluates row clampi(i, 1, n); plane k evaluates plane
// slab_row_of(k, gtop, gbot), which for a volume (gtop = 0, gbot = side-1)
// is clampi(k, 1, n).  Along a walk that plane steps by 0 or 1, so the
// rows in registers move on only where it steps, except across a wall plane
// with buffer planes beyond it (a z-slab's halo past the global wall),
// where it steps by 2 and the rows are loaded anew.  The first sweep of a
// folded or fast solve stores the rhs it built at the interior cells
// (i == ci, k == kc, columns 1..n), as the one-cell kernels do.
//
// Bound: device memory.  A middle sweep moves 12 bytes a cell in float32
// (0.0601 ms at 256^3 on 3.35 TB/s) and 10 in bf16 (a float32 iterate
// read, a bf16 rhs read, a float32 output written: 0.0501 ms); the vector
// form took 0.0726 ms in float32 (83%) and 0.0685 in bf16 (73%), the
// one-cell forms 0.0880 and 0.1058 (PERF.md §6).  What held the one-cell
// form back was not its load path: its SASS issues the float32 form's
// loads, all on the read-only path (LDG.E.CONSTANT; the rhs a 2-byte
// LDG.E.U16.CONSTANT), and a sweep from the zero guess, which reads only
// the rhs, took as long in bf16 (6 bytes a cell) as in float32 (8): a
// one-cell thread's loads are too narrow for the bytes to set its time.
//
// Unrolling the walk at a fixed length, or loading all its rows at once
// where no wall plane lies in it, measured no faster (PERF.md §6).  The
// wrapper (kernels/cuda_ops.py _Sweeps.sweep) takes V = kSweep3Width
// where it divides side and every operand is aligned to its access
// (cuda_ops.vector_width), else width 1, the one-cell kernel, and passes
// the walk (cuda_ops.SWEEP3_WALK).
#pragma once

#include "fsc_common.cuh"

namespace fsc {

// V, the cells of a row a thread of the vector form owns, chosen by
// measurement on the H100 with the walk (cuda_ops.SWEEP3_WALK, 3 planes):
// V = 4 was the fastest in every bf16 20-sweep solve and segment and in
// both bf16 parity steps (PERF.md §6, dev/bench_sweep3_bf16.py; V = 8 at
// its best walk 3-6% slower, V = 2 slower still).  cuda_ops.VECTOR_WIDTHS
// names it for the wrapper; the library refuses any other width but 1,
// the one-cell kernel.
constexpr int kSweep3Width = 4;

// One value on the read-only path.
__device__ __forceinline__ float load_ro(const float* __restrict__ p, int i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float load_ro(const bf16* __restrict__ p, int i) {
  return bf16_lo(__ldg(reinterpret_cast<const unsigned short*>(p) + i));
}

// Row segment [j0-1, j0+V] of the iterate from index g = the flat index of
// cell j0: the V cells in one vector load, the cells left and right of it
// one load each where they lie in the row (0 where they do not; no cell
// reads them then).
template <int V, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ x, int g,
                                         bool left, bool right,
                                         float (&o)[V + 2]) {
  float v[V];
  load_vec<V>(x, g, v);
#pragma unroll
  for (int m = 0; m < V; ++m) o[m + 1] = v[m];
  o[0] = left ? load_ro(x, g - 1) : 0.0f;
  o[V + 1] = right ? load_ro(x, g + V) : 0.0f;
}

// The bytes of one V-cell access of T.
template <typename T>
constexpr int access_bytes(int v) {
  return v * static_cast<int>(sizeof(T)) < 16
             ? v * static_cast<int>(sizeof(T))
             : 16;
}

// Plane k of a thread's cells, which evaluate plane kc, from the rows
// kc-1 (back), kc (mid) and kc+1 (ahead) of the iterate at row ci, each
// with the cells left and right of the vector ([j0-1, j0+V]).
template <int V, typename TX, typename TM, typename TR, typename TO>
__device__ __forceinline__ void sweep3_plane(
    const SweepParamsT<TX, TM, TR>& p, TO* __restrict__ out,
    TR* __restrict__ rhs_out, int side, int b, int i, int ci, int j0, int k,
    int kc, bool gz, const float (&back)[V + 2], const float (&mid)[V + 2],
    const float (&ahead)[V + 2]) {
  const int n = side - 2;
  const bool cheby = (p.flags & kCheby) != 0;
  const int c = (kc * side + ci) * side + j0;
  float r[V];
  load_vec<V>(p.rhs, c, r);
  if (p.flags & kPrep) {
    float s[V];
    if (p.src) load_vec<V>(p.src, c, s);
#pragma unroll
    for (int m = 0; m < V; ++m) {
      float v = r[m];
      if (p.src) v = v + p.src_dt * s[m];
      if (p.flags & kFast) v = v * p.inv_b;
      r[m] = round_to<TR>(v);
    }
  }
  float prev[V];
  if (cheby && p.xm) {
    load_vec<V>(p.xm, c, prev);
  } else {
#pragma unroll
    for (int m = 0; m < V; ++m) prev[m] = 0.0f;
  }
  float up[V], down[V];
  if (p.x) {
    load_vec<V>(p.x, c - side, up);
    load_vec<V>(p.x, c + side, down);
  }
  const bool gy = (i == 0) || (i == side - 1);
  float o[V];
#pragma unroll
  for (int m = 0; m < V; ++m) {
    // Cell m evaluates cell m + s of the vector (s: its ghost shift).
    const int s = ghost_shift<V>(m, j0, side);
    float neigh = 0.0f;
    if (p.x)
      neigh = ((shifted(mid, m, s) + shifted(mid, m + 2, s)) +
               (shifted(up, m, s) + shifted(down, m, s))) +
              (shifted(back, m + 1, s) + shifted(ahead, m + 1, s));
    float val = jacobi_update(p, neigh, shifted(r, m, s));
    if (cheby) val = cheby_combine(p.w, val, shifted(prev, m, s));
    const int j = j0 + m;
    o[m] = border_rule3(val, (j == 0) || (j == side - 1), gy, gz, b);
  }
  store_vec<V>(out, (k * side + i) * side + j0, o);
  // The rhs the first sweep of a folded or fast solve built, at the
  // interior cells of the row.
  if (rhs_out != nullptr && i == ci && k == kc) {
    if (j0 > 0 && j0 + V < side) {
      store_vec<V>(rhs_out, c, r);
    } else {
#pragma unroll
      for (int m = 0; m < V; ++m)
        if (j0 + m >= 1 && j0 + m <= n) store(rhs_out, c + m, r[m]);
    }
  }
}

// One thread of the vector form: V cells of row i from column j0, planes
// [k0, min(k0 + walk, hi)) with k0 = lo + blockIdx.z * walk, of a
// (planes, side, side) buffer whose wall ghost planes are gtop and gbot.
template <int V, typename TX, typename TM, typename TR, typename TO>
__device__ __forceinline__ void sweep3_walk(const SweepParamsT<TX, TM, TR>& p,
                                            TO* __restrict__ out,
                                            TR* __restrict__ rhs_out,
                                            int side, int b, int lo, int hi,
                                            int gtop, int gbot, int walk) {
  const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int k0 = lo + static_cast<int>(blockIdx.z) * walk;
  if (i >= side || j0 >= side) return;
  const int k1 = k0 + walk < hi ? k0 + walk : hi;
  const int ci = clampi(i, 1, side - 2);
  const int plane = side * side;
  const bool left = j0 > 0;
  const bool right = j0 + V < side;
  const int row = ci * side + j0;
  // Rows kc-1 (back), kc (mid) and kc+1 (ahead) of the iterate at row ci;
  // only mid's cells left and right of the vector are read.
  float back[V + 2], mid[V + 2], ahead[V + 2];
  int kc = slab_row_of(k0, gtop, gbot);
  if (p.x) {
    load_row<V>(p.x, (kc - 1) * plane + row, false, false, back);
    load_row<V>(p.x, kc * plane + row, left, right, mid);
    load_row<V>(p.x, (kc + 1) * plane + row, left, right, ahead);
  }
  for (int k = k0; k < k1; ++k) {
    const int kn = slab_row_of(k, gtop, gbot);
    if (kn != kc && p.x) {
      if (kn == kc + 1) {  // the rows move one plane on
#pragma unroll
        for (int m = 0; m < V + 2; ++m) {
          back[m] = mid[m];
          mid[m] = ahead[m];
        }
      } else {  // two planes on, across a wall plane: load them anew
        load_row<V>(p.x, (kn - 1) * plane + row, false, false, back);
        load_row<V>(p.x, kn * plane + row, left, right, mid);
      }
      load_row<V>(p.x, (kn + 1) * plane + row, left, right, ahead);
    }
    kc = kn;
    sweep3_plane<V>(p, out, rhs_out, side, b, i, ci, j0, k, kc,
                    (k == gtop) || (k == gbot), back, mid, ahead);
  }
}

// Launch `kernel`, a __global__ wrapper of sweep3_walk<V> at V =
// kSweep3Width, over planes [lo, hi): ceil(side/V) x side threads in 32 x 8
// blocks, one grid layer per `walk` planes.  Refused (cudaErrorInvalidValue)
// unless V divides side, walk >= 1 and every operand is aligned to its
// V-cell access.
template <typename TX, typename TM, typename TR, typename TO, typename Kernel>
int launch_walk(Kernel kernel, const SweepParamsT<TX, TM, TR>& p, TO* out,
                TR* rhs_out, int side, int b, int lo, int hi, int gtop,
                int gbot, int walk, cudaStream_t stream) {
  constexpr int V = kSweep3Width;
  if (side % V != 0 || walk < 1 ||
      !aligned(access_bytes<TX>(V), p.x, p.src) ||
      !aligned(access_bytes<TM>(V), p.xm) ||
      !aligned(access_bytes<TR>(V), p.rhs, rhs_out) ||
      !aligned(access_bytes<TO>(V), out))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((side / V + kBlockX - 1) / kBlockX,
                  (side + kBlockY - 1) / kBlockY, (hi - lo + walk - 1) / walk);
  kernel<<<grid, block_dim(), 0, stream>>>(p, out, rhs_out, side, b, lo, hi,
                                           gtop, gbot, walk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fsc

