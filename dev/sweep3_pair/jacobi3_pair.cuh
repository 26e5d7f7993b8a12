// The two-sweep form of the per-sweep 3-D Jacobi sweeps, measured and not
// built into the port (dev/sweep3_pair/pair.cu; PERF.md §6): sweeps s and
// s+1 of a solve in one launch, for K5 (a whole volume) and K13 (planes
// [lo, hi) of a z-slab buffer), one device body over the one-sweep walk's
// (fluidsimulationcuda_torch/csrc/jacobi3_walk.cuh).
//
// A 256^3 field is 67 MB and does not stay in the 50 MB L2, so each launch
// of the one-sweep walk reads the iterate and the rhs from HBM and writes
// its output there: 12 bytes a cell a sweep.  A pair reads x_s and the rhs
// once and writes x_{s+2} once, 12 bytes a cell for two sweeps: its bound
// at 256^3 is 0.0601 ms, 0.0300 a sweep.  On the H100 it took 0.204 ms at
// best against 0.146 for two walk sweeps (1.37-1.46x, at 26-29% of its
// bound, a float32 or bf16 rhs, a volume or a z-slab buffer): the walk
// moves its bytes at 82% of the HBM rate, and the pair, computing level s
// on 1.3-1.4 times the cells with a barrier a plane, is held back by the
// latency of each plane's loads and barrier rather than by its bytes.
//
// A block of NW warps owns a tile of 128 columns (4 cells a thread, the
// walk's vectors) and R = NW - 2 interior rows, and walks `walk` planes of
// level s+1 in z as a two-level wavefront: at plane k it computes level s
// (sweep s) at plane k, then level s+1 at plane k-1.
//
// - Level s is computed over the tile plus a one-cell ring, in the walk's
//   arithmetic (sweep3_cells), one row a warp: warp w takes row a-1+w of
//   the tile at row a, so warps 0 and NW-1 compute the ring rows and the
//   others the tile's rows, each from its rows of x_s in registers (back,
//   mid, ahead) moved one plane on as it walks.  The first and last lane
//   of a tile row also compute the ring cell left or right of the tile,
//   from the cells of the row they hold and three more loads.  A ring cell
//   at a wall evaluates its interior cell and applies the border rule, as
//   every ghost cell of a sweep does.
// - Level s goes to one shared-memory plane of NW rows, double-buffered: a
//   plane's level-s values are written in the iteration that computes them
//   and read in the next one, so one barrier ends a plane.  Level s+1
//   reads its x and y neighbours of level s there and its z neighbours
//   from registers: each warp keeps level s at its cells for the planes
//   k-2, k-1 and k.
// - A ghost cell of level s+1 takes the value of the interior cell it
//   derives from, with the border rule: the warp that computes row 1 also
//   writes row 0, row side-2 row side-1, and the plane next to a wall
//   plane (gtop + 1, gbot - 1) the wall plane, so level s+1 needs level s
//   only at planes next to the interior planes it computes.
//
// Every cell does the one-sweep kernels' arithmetic in their order, so a
// pair equals two one-sweep launches bit for bit.  It takes the middle
// sweeps of Jacobi and dividing solves: no rhs is built (kPrep), no
// Chebyshev combine (kCheby) is taken, and x_s and the output are float32
// (the rhs float32 or bf16).
#pragma once

#include "jacobi3_walk.cuh"

namespace fsc {

// Columns of a pair's tile: 32 threads of 4 cells.
constexpr int kPairCols = kBlockX * kSweep3Width;
// A row of level s in shared memory: columns [j0-4, j0+132) of a tile at
// column j0, so the tile's vectors sit on 16-byte boundaries; its ring
// cells are columns j0-1 and j0+128.
constexpr int kPairStride = kPairCols + 8;

// The walk's sweep3_plane without its stores, in its arithmetic: the
// values of a thread's cells at plane k, which evaluate plane kc, from the
// rows kc-1 (back), kc (mid) and kc+1 (ahead) of the iterate at row ci,
// each with the cells left and right of the vector ([j0-1, j0+V]): o, with
// the border rule applied, and r, the rhs the sweep read (built where
// kPrep).
template <int V, typename TX, typename TM, typename TR>
__device__ __forceinline__ void sweep3_cells(
    const SweepParamsT<TX, TM, TR>& p, int side, int b, int i, int ci,
    int j0, int kc, bool gz, const float (&back)[V + 2],
    const float (&mid)[V + 2], const float (&ahead)[V + 2], float (&r)[V],
    float (&o)[V]) {
  const bool cheby = (p.flags & kCheby) != 0;
  const int c = (kc * side + ci) * side + j0;
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
}


// One thread of the pair: level s+1 at planes [q0, q0 + walk) of [lo, hi)
// (q0 = lo + blockIdx.z * walk), level s where they need it, on a
// (planes, side, side) buffer whose wall ghost planes are gtop and gbot.
template <int NW, typename TR>
__device__ __forceinline__ void sweep3_pair(
    const SweepParamsT<float, float, TR>& p, float* __restrict__ out,
    int side, int b, int lo, int hi, int planes, int gtop, int gbot,
    int walk) {
  constexpr int V = kSweep3Width;
  constexpr int R = NW - 2;
  constexpr int W = kPairStride;
  constexpr int kPlane = NW * W;
  __shared__ float4 level_s[2 * kPlane / 4];
  float* const lvl = reinterpret_cast<float*>(level_s);
  const int tx = threadIdx.x, w = threadIdx.y;
  const int j0 = blockIdx.x * kPairCols + tx * V;
  const int a = 1 + static_cast<int>(blockIdx.y) * R;  // first interior row
  const int end = a + R < side - 1 ? a + R : side - 1;  // one past the last
  const int q0 = lo + static_cast<int>(blockIdx.z) * walk;
  const int q1 = q0 + walk < hi ? q0 + walk : hi;
  const int plane = side * side;
  const bool left = j0 > 0, right = j0 + V < side;
  // This warp's row of level s (the ring rows a-1 and end included), the
  // row it evaluates, and whether it is a row of level s+1.
  const int i = a - 1 + w;
  const int ci = clampi(i, 1, side - 2);
  const bool on = j0 < side && i <= end;
  const bool owns = on && w >= 1 && i < end;
  // The ring cells left and right of the tile this lane computes.
  const bool ring_l = owns && tx == 0 && left;
  const bool ring_r = owns && tx == kBlockX - 1 && right;
  const int row = ci * side + j0;
  // Rows kc-1, kc and kc+1 of x_s at row ci, and level s at this thread's
  // cells of planes k-2, k-1 and k.
  float xb[V + 2], xm[V + 2], xa[V + 2];
  float sb[V], sm[V], sa[V];
  // The rhs level s read at plane k-1: level s+1's at plane q = k-1.
  float rq[V];
#pragma unroll
  for (int c = 0; c < V; ++c) sb[c] = sm[c] = sa[c] = rq[c] = 0.0f;
  const int pa = q0 - 1 > 0 ? q0 - 1 : 0;
  const int pb = q1 + 1 < planes ? q1 + 1 : planes;
  int kc = slab_row_of(pa, gtop, gbot);
  if (on) {
    load_row<V>(p.x, (kc - 1) * plane + row, left, right, xb);
    load_row<V>(p.x, kc * plane + row, left, right, xm);
    load_row<V>(p.x, (kc + 1) * plane + row, left, right, xa);
  }
  for (int k = pa; k < pb; ++k) {
    // Level s at plane k, which evaluates plane kc.
    const int kn = slab_row_of(k, gtop, gbot);
    if (kn != kc && on) {
      if (kn == kc + 1) {  // the rows move one plane on
#pragma unroll
        for (int c = 0; c < V + 2; ++c) {
          xb[c] = xm[c];
          xm[c] = xa[c];
        }
      } else {  // two planes on, across a wall plane: load them anew
        load_row<V>(p.x, (kn - 1) * plane + row, left, right, xb);
        load_row<V>(p.x, kn * plane + row, left, right, xm);
      }
      load_row<V>(p.x, (kn + 1) * plane + row, left, right, xa);
    }
    kc = kn;
    const bool gz = (k == gtop) || (k == gbot);
    float* const cur = lvl + (k & 1) * kPlane + w * W + 4 + tx * V;
    float r[V];
    if (on) {
      // The ring cell's neighbours outside the rows held: the next cell
      // of the row, the cells above and below, and its rhs; its value in
      // the one-cell kernel's arithmetic (sweep_at3, slab_border_value3).
      const int g = kc * plane + row + (ring_l ? -1 : V);
      float nx = 0.0f, up = 0.0f, down = 0.0f, rr = 0.0f;
      if (ring_l || ring_r) {
        nx = load_ro(p.x, g + (ring_l ? -1 : 1));
        up = load_ro(p.x, g - side);
        down = load_ro(p.x, g + side);
        rr = load_ro(p.rhs, g);
      }
      float o[V];
      sweep3_cells<V>(p, side, b, i, ci, j0, kc, gz, xb, xm, xa, r, o);
#pragma unroll
      for (int c = 0; c < V; ++c) {
        sb[c] = sm[c];
        sm[c] = sa[c];
        sa[c] = o[c];
      }
      *reinterpret_cast<float4*>(cur) = make_float4(o[0], o[1], o[2], o[3]);
      if (ring_l || ring_r) {
        // Constant indices keep the rows in registers.
        const float lr = ring_l ? nx + xm[1] : xm[V] + nx;
        const float fb = ring_l ? xb[0] + xa[0] : xb[V + 1] + xa[V + 1];
        const float neigh = (lr + (up + down)) + fb;
        cur[ring_l ? -1 : V] =
            border_rule3(jacobi_update(p, neigh, rr), false, false, gz, b);
      }
    }
    // Level s+1 at plane q = k-1, from level s at plane q in shared memory
    // (written in the last iteration) and at planes q-1 and q+1 in
    // registers, and the rhs level s read at plane q (q is no wall plane,
    // so it evaluates itself); a wall plane is written with the plane
    // next to it.
    const int q = k - 1;
    if (owns && q >= q0 && q < q1 && q != gtop && q != gbot) {
      const float* const at = lvl + (q & 1) * kPlane + w * W + 4 + tx * V;
      float mid[V + 2], up[V], down[V], val[V];
      mid[0] = left ? at[-1] : 0.0f;
      mid[V + 1] = right ? at[V] : 0.0f;
#pragma unroll
      for (int c = 0; c < V; ++c) mid[c + 1] = sm[c];
      const float4 u4 = *reinterpret_cast<const float4*>(at - W);
      const float4 d4 = *reinterpret_cast<const float4*>(at + W);
      up[0] = u4.x, up[1] = u4.y, up[2] = u4.z, up[3] = u4.w;
      down[0] = d4.x, down[1] = d4.y, down[2] = d4.z, down[3] = d4.w;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const int s = ghost_shift<V>(c, j0, side);
        const float neigh = ((shifted(mid, c, s) + shifted(mid, c + 2, s)) +
                             (shifted(up, c, s) + shifted(down, c, s))) +
                            (shifted(sb, c, s) + shifted(sa, c, s));
        val[c] = jacobi_update(p, neigh, shifted(rq, c, s));
      }
      // The cell's own plane and row, the ghost row next to row 1 or
      // side-2, the wall plane next to plane q, and their corners.
      const int gr = i == 1 ? 0 : (i == side - 2 ? side - 1 : -1);
      const int gp = (q - 1 == gtop && gtop >= lo)   ? gtop
                     : (q + 1 == gbot && gbot < hi) ? gbot
                                                    : -1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rz = (e & 1) ? gr : i;
        const int pz = (e & 2) ? gp : q;
        if (rz < 0 || pz < 0) continue;
        float o[V];
#pragma unroll
        for (int c = 0; c < V; ++c) {
          const int j = j0 + c;
          o[c] = border_rule3(val[c], (j == 0) || (j == side - 1),
                              (e & 1) != 0, (e & 2) != 0, b);
        }
        store_vec<V>(out, (pz * side + rz) * side + j0, o);
      }
    }
    if (on) {
#pragma unroll
      for (int c = 0; c < V; ++c) rq[c] = r[c];
    }
    __syncthreads();
  }
}

// The warps of a pair's block, by the interior rows of its tile, for the
// launch's `rows` (6, 8 or 14).
constexpr int pair_warps(int rows) { return rows + 2; }

// Launch `k6`, `k8` or `k14`, __global__ wrappers of sweep3_pair at 8, 10
// and 16 warps (tiles of 6, 8 and 14 interior rows, `rows`), over level
// s+1's planes [lo, hi) of a (planes, side, side) buffer: ceil(side/128)
// x ceil((side-2)/rows) tiles, one grid layer per `walk` planes.  Refused
// (cudaErrorInvalidValue) unless 4 divides side, rows is 6, 8 or 14, walk
// >= 1, x is given, flags take neither kPrep nor kCheby nor kDamp, x, out
// and the rhs are aligned to their 4-cell accesses, every plane of [lo,
// hi) that is not a wall plane has planes on both sides of it, a wall
// plane in [lo, hi) has the plane next to it in [lo, hi) and no wall, and
// level s reads x inside the buffer.
template <typename TR, typename K6, typename K8, typename K14>
int launch_pair(K6 k6, K8 k8, K14 k14, const SweepParamsT<float, float, TR>& p,
                float* out, int side, int b, int lo, int hi, int planes,
                int gtop, int gbot, int rows, int walk, cudaStream_t stream) {
  constexpr int V = kSweep3Width;
  const bool top_in = gtop >= lo && gtop < hi;
  const bool bot_in = gbot >= lo && gbot < hi;
  if (side % V != 0 || (rows != 6 && rows != 8 && rows != 14) || walk < 1 ||
      p.x == nullptr || (p.flags & (kPrep | kCheby | kDamp)) != 0 ||
      lo < 0 || hi > planes || lo >= hi ||
      !aligned(access_bytes<float>(V), p.x, out) ||
      !aligned(access_bytes<TR>(V), p.rhs) ||
      (lo < 1 && lo != gtop) || (hi > planes - 1 && hi - 1 != gbot) ||
      (top_in && (gtop + 1 >= hi || gtop + 1 == gbot)) ||
      (bot_in && (gbot - 1 < lo || gbot - 1 == gtop)))
    return static_cast<int>(cudaErrorInvalidValue);
  // Level s at planes [lo-1, hi+1) of the buffer reads x at the planes
  // next to the plane each evaluates: inside the buffer.
  for (int k = lo - 1 > 0 ? lo - 1 : 0; k < hi + 1 && k < planes; ++k) {
    const int kc = k == gtop ? k + 1 : (k == gbot ? k - 1 : k);
    if (kc < 1 || kc > planes - 2)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((side / V + kBlockX - 1) / kBlockX,
                  (side - 2 + rows - 1) / rows, (hi - lo + walk - 1) / walk);
  const dim3 block(kBlockX, pair_warps(rows));
  if (rows == 6)
    k6<<<grid, block, 0, stream>>>(p, out, side, b, lo, hi, planes, gtop,
                                   gbot, walk);
  else if (rows == 8)
    k8<<<grid, block, 0, stream>>>(p, out, side, b, lo, hi, planes, gtop,
                                   gbot, walk);
  else
    k14<<<grid, block, 0, stream>>>(p, out, side, b, lo, hi, planes, gtop,
                                    gbot, walk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fsc
