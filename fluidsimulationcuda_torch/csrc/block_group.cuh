// The tables of the block route's grouped stencils: K11-block grouped
// (project_slab.cu, gradient_block_group_kernel) and K12-block grouped
// (advect_slab.cu, advect_block_group_kernel), one launch over every
// block of a device, as K9-block grouped (jacobi_tiles.cu, BlockGroup).
//
// A table is passed by value in the kernel's parameters, so a CUDA graph
// captures it with the launch (under the 32,764 bytes CUDA 12.1 takes on
// sm_70 and later: 88 bytes a block for the gradient, 5.6 KB at
// kStencilBlocks; 32 bytes a part and 56 a block for the gather, 11.8 KB).
// Each block of a launch reads its neighbours' cells from their own
// arrays, or from a copy of the cells it reads where the neighbour lies on
// another device (the wrappers make those copies), so no halo, no extended
// block and no assembled field is built for it.
#pragma once

#include "fsc_common.cuh"

namespace fsc {

// The most blocks one grouped launch writes (K9-block grouped's
// kGroupBlocks), and the most blocks of the field a gather's table holds.
constexpr int kStencilBlocks = 64;
constexpr int kGatherParts = 256;

// K11-block grouped: one (m, k) block at global origin (r0, c0), its u, v
// and p, its outputs, and p's one-cell neighbours: the row above (top) and
// below (bot), k cells each, and the column left and right of it, m cells
// each, cell r at r * lstride (rstride): a neighbour's own array (its last
// row, first row, last column (stride k), first column) or a copy of that
// row or column (stride 1); null beyond a wall, where no cell reads it.
struct GradBlock {
  const void* u;
  const void* v;
  const void* p;
  void* uo;
  void* vo;
  const void* top;
  const void* bot;
  const void* left;
  const void* right;
  int lstride, rstride;
  int r0, c0;
};

struct GradGroup {
  GradBlock block[kStencilBlocks];
};

// K12-block grouped: each block of the field as the launch sees it (part
// bi * py + bj owns global rows [bi*m, (bi+1)*m) and columns [bj*k,
// (bj+1)*k)): each gathered field's array, the global row and column of
// its element 0 and its row stride.  A block on the launch's device is
// its own array (r, c its origin, stride k); one on another device a copy
// of the cells the launch can read; null where it reads none.
struct GatherPart {
  const void* f[2];
  int r, c, stride;
};

// One block a grouped gather writes: its velocities (the u/v pair's own
// cells, or the velocity blocks for the density) and outputs, and its own
// fields (the part it owns), for departures that stay inside it.
struct GatherBlock {
  const void* u;
  const void* v;
  const void* f[2];
  void* o[2];
  int r0, c0;
};

struct BlockGatherGroup {
  GatherPart part[kGatherParts];
  GatherBlock block[kStencilBlocks];
  int m, k, py;
};

// Whether an (m, k) block at (r0, c0) lies in the grid and has each
// neighbour that is not beyond a wall (top, bottom, left, right; null
// beyond one).
inline bool block_in_grid(int m, int k, int n, int r0, int c0,
                          const void* top, const void* bot, const void* left,
                          const void* right) {
  return m >= 2 && k >= 2 && r0 >= 0 && c0 >= 0 && r0 + m <= n + 2 &&
         c0 + k <= n + 2 && (top != nullptr || r0 == 0) &&
         (bot != nullptr || r0 + m == n + 2) && (left != nullptr || c0 == 0) &&
         (right != nullptr || c0 + k == n + 2);
}

// Whether an array of T at p takes `width`-cell vectors on rows of a
// multiple of `width` cells.
template <typename T>
inline bool vec_aligned(int width, const void* p) {
  return p == nullptr ||
         reinterpret_cast<size_t>(p) % (width * sizeof(T)) == 0;
}

// The gradient's table from the host's arrays (9 pointers a block: u, v,
// p, uo, vo, top, bot, left, right; 4 ints: r0, c0, lstride, rstride),
// checked: every block in the grid with its neighbours, its outputs, and
// where `width` > 1 every array the vectors read or write aligned to them
// (k a multiple of width, checked by the caller).
template <typename T>
inline bool grad_table(const void* const* ptrs, const int* ints, int blocks,
                       int m, int k, int n, int width, GradGroup* g) {
  if (blocks < 1 || blocks > kStencilBlocks) return false;
  for (int i = 0; i < blocks; ++i) {
    const void* const* q = ptrs + 9 * i;
    const int* v = ints + 4 * i;
    GradBlock& b = g->block[i];
    b.u = q[0];
    b.v = q[1];
    b.p = q[2];
    b.uo = const_cast<void*>(q[3]);
    b.vo = const_cast<void*>(q[4]);
    b.top = q[5];
    b.bot = q[6];
    b.left = q[7];
    b.right = q[8];
    b.r0 = v[0];
    b.c0 = v[1];
    b.lstride = v[2];
    b.rstride = v[3];
    if (!block_in_grid(m, k, n, b.r0, b.c0, b.top, b.bot, b.left,
                       b.right) ||
        b.u == nullptr || b.v == nullptr || b.p == nullptr ||
        b.uo == nullptr || b.vo == nullptr || b.lstride < 1 ||
        b.rstride < 1)
      return false;
    for (int a = 0; a < 7; ++a)
      if (!vec_aligned<T>(width, q[a])) return false;
  }
  return true;
}

// The gather's table from the host's arrays (parts: 2 pointers and 3 ints
// (r, c, stride) a part, px * py of them; blocks: 4 pointers (u, v, o1,
// o2) and 2 ints (r0, c0) a block), checked: the parts tile the grid,
// every block is one of them with its own fields, and where `width` > 1
// its velocities and outputs are aligned to the vectors.
template <typename T>
inline bool gather_table(const void* const* parts, const int* part_ints,
                         int nparts, const void* const* blks,
                         const int* blk_ints, int nblocks, int m, int k,
                         int n, int py, int nf, int width,
                         BlockGatherGroup* g) {
  if (nparts < 1 || nparts > kGatherParts || nblocks < 1 ||
      nblocks > kStencilBlocks || nf < 1 || nf > 2 || m < 2 || k < 2 ||
      py < 1 || nparts % py != 0 || m * (nparts / py) != n + 2 ||
      k * py != n + 2)
    return false;
  g->m = m;
  g->k = k;
  g->py = py;
  for (int s = 0; s < nparts; ++s) {
    GatherPart& p = g->part[s];
    p.f[0] = parts[2 * s];
    p.f[1] = parts[2 * s + 1];
    p.r = part_ints[3 * s];
    p.c = part_ints[3 * s + 1];
    p.stride = part_ints[3 * s + 2];
  }
  for (int i = 0; i < nblocks; ++i) {
    const void* const* q = blks + 4 * i;
    GatherBlock& b = g->block[i];
    b.u = q[0];
    b.v = q[1];
    b.o[0] = const_cast<void*>(q[2]);
    b.o[1] = const_cast<void*>(q[3]);
    b.r0 = blk_ints[2 * i];
    b.c0 = blk_ints[2 * i + 1];
    if (b.r0 < 0 || b.c0 < 0 || b.r0 % m != 0 || b.c0 % k != 0 ||
        b.r0 + m > n + 2 || b.c0 + k > n + 2 || b.u == nullptr ||
        b.v == nullptr || b.o[0] == nullptr ||
        (nf == 2) != (b.o[1] != nullptr))
      return false;
    const GatherPart& own = g->part[(b.r0 / m) * py + b.c0 / k];
    if (own.r != b.r0 || own.c != b.c0 || own.stride != k ||
        own.f[0] == nullptr || (nf == 2 && own.f[1] == nullptr))
      return false;
    b.f[0] = own.f[0];
    b.f[1] = own.f[1];
    for (int a = 0; a < 4; ++a)
      if (!vec_aligned<T>(width, q[a])) return false;
  }
  return true;
}

// K11-block grouped: the gradient of block blockIdx.z of the group, V
// cells of a row a thread (V = 1: one cell, as gradient_block_kernel),
// expression for expression gradient_block_kernel's, p's neighbours read
// from the table's sources.  u, v, p's row segment [j0, j0 + V) and the
// rows above and below it are one vector each, p's cells j0 - 1 and j0 + V
// two loads (its neighbours' where the segment meets the block's edge;
// beyond a wall none, which only a ghost column's shifted cell would read,
// and it does not).  A zero numerator is its own quotient: 0/h for h > 0
// (the library refuses any other h), the bits the division gives, which
// takes its slow path on zeros.
//
// Design by measurement on the H100 (dev/bench_block_stencils.py, PERF.md
// §6): over the (2, 4) blocks of 2048², on random fields, smooth and shear
// flows and the block step's state after 4 and 301 steps, V = 2 in
// float32 (within 1.1% of each flow's best; V = 4 1.6%) and V = 8 in bf16
// (within 2.8% of each flow's best but random fields'; V = 4 4.5%, V = 2
// and 1 25-150%); p's edge cells taken from the neighbouring lanes by warp
// shuffles gained at most 0.5% at these widths; dividing zero numerators
// cost the bf16 form 5-66% on those flows (neighbouring bf16 pressures are
// often equal; the shear flow's p is zero on 98% of its cells, the late
// state's on all) and the float32 form up to 5%, and saved 11.5% on random
// fields alone.
template <int V, typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    gradient_block_group_kernel(const __grid_constant__ GradGroup g,
                                int m, int k, int n, float h) {
  const GradBlock& b = g.block[blockIdx.z];
  const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= m || j0 >= k) return;
  const int ri = clampi(b.r0 + r, 1, n) - b.r0;
  const T* u = static_cast<const T*>(b.u);
  const T* v = static_cast<const T*>(b.v);
  const T* p = static_cast<const T*>(b.p);
  const T* left = static_cast<const T*>(b.left);
  const T* right = static_cast<const T*>(b.right);
  const int row = ri * k;
  const T* up = ri == 0 ? static_cast<const T*>(b.top) : p + row - k;
  const T* dn = ri == m - 1 ? static_cast<const T*>(b.bot) : p + row + k;
  const bool gy = b.r0 + r == 0 || b.r0 + r == n + 1;
  const auto grad = [h](float pr, float pl) {
    const float num = 0.5f * (pr - pl);
    return num == 0.0f ? num : num / h;
  };
  if constexpr (V == 1) {
    const int ci = clampi(b.c0 + j0, 1, n) - b.c0;
    const float p_l = ci == 0 ? ldg(left, ri * b.lstride)
                              : ldg(p, row + ci - 1);
    const float p_r = ci == k - 1 ? ldg(right, ri * b.rstride)
                                  : ldg(p, row + ci + 1);
    const float un = ldg(u, row + ci) - grad(p_r, p_l);
    const float vn = ldg(v, row + ci) - grad(ldg(dn, ci), ldg(up, ci));
    const bool gx = b.c0 + j0 == 0 || b.c0 + j0 == n + 1;
    store(static_cast<T*>(b.uo), r * k + j0, border_rule(un, gx, gy, 1));
    store(static_cast<T*>(b.vo), r * k + j0, border_rule(vn, gx, gy, 2));
  } else {
    float uc[V], vc[V], pu[V], pd[V], mid[V], pc[V + 2];
    load_vec<V>(u, row + j0, uc);
    load_vec<V>(v, row + j0, vc);
    load_vec<V>(up, j0, pu);
    load_vec<V>(dn, j0, pd);
    load_vec<V>(p, row + j0, mid);
    // pc: p at columns j0 - 1 .. j0 + V.
    pc[0] = j0 > 0 ? ldg(p, row + j0 - 1)
                   : (left ? ldg(left, ri * b.lstride) : 0.0f);
#pragma unroll
    for (int q = 0; q < V; ++q) pc[q + 1] = mid[q];
    pc[V + 1] = j0 + V < k ? ldg(p, row + j0 + V)
                           : (right ? ldg(right, ri * b.rstride) : 0.0f);
    float a[V], e[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int s = ghost_shift<V>(q, b.c0 + j0, n + 2);
      const float un = shifted(uc, q, s) -
                       grad(shifted(pc, q + 2, s), shifted(pc, q, s));
      const float vn = shifted(vc, q, s) -
                       grad(shifted(pd, q, s), shifted(pu, q, s));
      const bool gx = b.c0 + j0 + q == 0 || b.c0 + j0 + q == n + 1;
      a[q] = border_rule(un, gx, gy, 1);
      e[q] = border_rule(vn, gx, gy, 2);
    }
    store_vec<V>(static_cast<T*>(b.uo), r * k + j0, a);
    store_vec<V>(static_cast<T*>(b.vo), r * k + j0, e);
  }
}

// One grouped K11-block launch of V cells a thread.
template <int V, typename T>
int launch_gradient_group(const GradGroup& g, int blocks, int m, int k,
                          int n, float h, cudaStream_t stream) {
  const auto kernel = gradient_block_group_kernel<V, T>;
  const dim3 grid((k / V + kBlockX - 1) / kBlockX,
                  (m + kBlockY - 1) / kBlockY, blocks);
  kernel<<<grid, block_dim(), 0, stream>>>(g, m, k, n, h);
  return static_cast<int>(cudaGetLastError());
}

// Field fi's cell at global (i, j), read from the part that owns it.
template <typename T>
__device__ __forceinline__ float part_cell(const BlockGatherGroup& g,
                                           int fi, int i, int j) {
  const GatherPart& s = g.part[(i / g.m) * g.py + j / g.k];
  return ldg(static_cast<const T*>(s.f[fi]),
             (i - s.r) * s.stride + (j - s.c));
}

// K12-block grouped: the gather of nf fields (border modes b1, b2) at
// block blockIdx.z of the group, V cells of a row a thread (V = 1: one
// cell, as advect_block_kernel): the cell's departure (backtrace_at, or
// window_backtrace in the window of cmax cells), then each of its four
// corners read from the part that owns it, from the block's own fields
// where all four lie in it, the blend and the border rule of
// advect_block_kernel, expression for expression.  The global clamp keeps
// every corner in the grid, so some part owns it, and the window keeps it
// in the block or a neighbour.
//
// Design by measurement on the H100 (dev/bench_block_stencils.py, PERF.md
// §6; the gradient's inputs): V = 4 for the windowed gathers in both
// storages and the exact ones in bf16, V = 2 for the exact ones in float32,
// each within 6.1% of each realistic flow's best (the next width up to 15%
// behind); each corner row's x-pair as one access where aligned was slower
// in 117 of 120 form, flow and width cells, by up to 11%.
template <bool kExact, int V, typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    advect_block_group_kernel(const __grid_constant__ BlockGatherGroup g,
                              int n, int nf, int b1, int b2, float dt0,
                              int cmax) {
  const GatherBlock& b = g.block[blockIdx.z];
  const int m = g.m, k = g.k;
  const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= m || j0 >= k) return;
  const int gi = clampi(b.r0 + r, 1, n);
  const int row = (gi - b.r0) * k;
  const T* u = static_cast<const T*>(b.u);
  const T* v = static_cast<const T*>(b.v);
  float uv[V], vv[V];
  if constexpr (V == 1) {
    const int c = row + clampi(b.c0 + j0, 1, n) - b.c0;
    uv[0] = ldg(u, c);
    vv[0] = ldg(v, c);
  } else {
    load_vec<V>(u, row + j0, uv);
    load_vec<V>(v, row + j0, vv);
  }
  const bool gy = b.r0 + r == 0 || b.r0 + r == n + 1;
  float out[2][V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    const int s = V == 1 ? 0 : ghost_shift<V>(q, b.c0 + j0, n + 2);
    const int gj = clampi(b.c0 + j0 + q, 1, n);
    const float uc = V == 1 ? uv[0] : shifted(uv, q, s);
    const float vc = V == 1 ? vv[0] : shifted(vv, q, s);
    const Departure d =
        kExact ? backtrace_at(uc, vc, gi, gj, n + 2, dt0)
               : window_backtrace(uc, vc, gi, gj, n, dt0, cmax);
    const bool gx = b.c0 + j0 + q == 0 || b.c0 + j0 + q == n + 1;
    const bool inside = d.i0 >= b.r0 && d.i0 + 1 < b.r0 + m &&
                        d.j0 >= b.c0 && d.j0 + 1 < b.c0 + k;
    const int o = (d.i0 - b.r0) * k + (d.j0 - b.c0);
#pragma unroll
    for (int fi = 0; fi < 2; ++fi) {
      if (fi >= nf) break;
      float g00, g10, g01, g11;
      if (inside) {
        const T* f = static_cast<const T*>(b.f[fi]);
        g00 = ldg(f, o);
        g01 = ldg(f, o + 1);
        g10 = ldg(f, o + k);
        g11 = ldg(f, o + k + 1);
      } else {
        g00 = part_cell<T>(g, fi, d.i0, d.j0);
        g10 = part_cell<T>(g, fi, d.i0 + 1, d.j0);
        g01 = part_cell<T>(g, fi, d.i0, d.j0 + 1);
        g11 = part_cell<T>(g, fi, d.i0 + 1, d.j0 + 1);
      }
      out[fi][q] =
          border_rule(blend(d, g00, g10, g01, g11), gx, gy, fi ? b2 : b1);
    }
  }
#pragma unroll
  for (int fi = 0; fi < 2; ++fi) {
    if (fi >= nf) break;
    T* o = static_cast<T*>(b.o[fi]);
    if constexpr (V == 1) {
      store(o, r * k + j0, out[fi][0]);
    } else {
      store_vec<V>(o, r * k + j0, out[fi]);
    }
  }
}

// One grouped K12-block launch of V cells a thread.
template <bool kExact, int V, typename T>
int launch_gather_group(const BlockGatherGroup& g, int blocks, int n,
                        int nf, int b1, int b2, float dt0, int cmax,
                        cudaStream_t stream) {
  const auto kernel = advect_block_group_kernel<kExact, V, T>;
  const dim3 grid((g.k / V + kBlockX - 1) / kBlockX,
                  (g.m + kBlockY - 1) / kBlockY, blocks);
  kernel<<<grid, block_dim(), 0, stream>>>(g, n, nf, b1, b2, dt0, cmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fsc
