// Every per-thread design of the grouped K11-block and K12-block that
// dev/bench_block_stencils.py times beside the kept ones (csrc/
// block_group.cuh), on the same tables: the gradient at V = 1, 2, 4 and,
// in bf16, 8 cells a thread, p's edge cells loaded or taken from the
// neighbouring lanes by shuffles (kShuffle), a zero numerator its own
// quotient or divided (kSkip); the gathers at V = 1, 2, 4, each corner
// row's x-pair as one access where aligned, read-only or plain, or as two
// (kPair), the corners of a departure that leaves the block read out of
// line or inline (kCall); and each at least kMin blocks of 256 threads an
// SM (__launch_bounds__: at most 32 registers a thread at 8, 40 at 6).  Built into
// a copy of the kernel sources, never into the port's library.
#pragma once

#include "block_group.cuh"

#ifndef __noinline__  // a host build (the CPU shim)
#define __noinline__ __attribute__((noinline))
#endif

namespace variants {

using namespace fsc;

// K11-block grouped: the gradient of block blockIdx.z of the group, V
// cells of a row a thread (V = 1: one cell, as gradient_block_kernel),
// p's neighbours read from the table's sources.  u, v, p's row segment
// [j0, j0 + V) and the rows above and below it are one vector each; p's
// cells j0 - 1 and j0 + V are its two edge cells (kShuffle: taken from the
// neighbouring lanes' vectors, loaded at a warp's and a block's edges).
// kSkip takes a zero numerator as its own quotient (0/h for h > 0).
template <int V, bool kShuffle, bool kSkip, int kMin, typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY, kMin)
    gradient_group_variant_kernel(const __grid_constant__ GradGroup g,
                                int m, int k, int n, float h) {
  const GradBlock& b = g.block[blockIdx.z];
  const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  // A shuffle needs its warp's every lane: a lane past the block's side
  // computes on the last vector and stores nothing.
  if (r >= m || (!kShuffle && j0 >= k)) return;
  const bool live = j0 < k;
  const int jc = live ? j0 : k - V;
  const int ri = clampi(b.r0 + r, 1, n) - b.r0;
  const T* u = static_cast<const T*>(b.u);
  const T* v = static_cast<const T*>(b.v);
  const T* p = static_cast<const T*>(b.p);
  const int row = ri * k;
  const T* up = ri == 0 ? static_cast<const T*>(b.top) : p + row - k;
  const T* dn = ri == m - 1 ? static_cast<const T*>(b.bot) : p + row + k;
  const bool gy = b.r0 + r == 0 || b.r0 + r == n + 1;
  const auto grad = [&](float pr, float pl) {
    const float num = 0.5f * (pr - pl);
    return (kSkip && num == 0.0f) ? num : num / h;
  };
  if constexpr (V == 1) {
    const int ci = clampi(b.c0 + jc, 1, n) - b.c0;
    const float p_l =
        ci == 0 ? ldg(static_cast<const T*>(b.left), ri * b.lstride)
                : ldg(p, row + ci - 1);
    const float p_r =
        ci == k - 1
            ? ldg(static_cast<const T*>(b.right), ri * b.rstride)
            : ldg(p, row + ci + 1);
    const float un = ldg(u, row + ci) - grad(p_r, p_l);
    const float vn = ldg(v, row + ci) - grad(ldg(dn, ci),
                                                 ldg(up, ci));
    if (!live) return;
    const bool gx = b.c0 + j0 == 0 || b.c0 + j0 == n + 1;
    store(static_cast<T*>(b.uo), r * k + j0,
               border_rule(un, gx, gy, 1));
    store(static_cast<T*>(b.vo), r * k + j0,
               border_rule(vn, gx, gy, 2));
  } else {
    float uc[V], vc[V], pu[V], pd[V], mid[V], pc[V + 2];
    load_vec<V>(u, row + jc, uc);
    load_vec<V>(v, row + jc, vc);
    load_vec<V>(up, jc, pu);
    load_vec<V>(dn, jc, pd);
    load_vec<V>(p, row + jc, mid);
    // pc: p at columns jc - 1 .. jc + V; beyond a wall 0, which only the
    // ghost column's shifted cell would take, and it does not.
    const bool first = jc == 0;
    const bool last = jc + V == k;
    float before = 0.0f, after = 0.0f;
    if constexpr (kShuffle) {
      const float from_left = __shfl_up_sync(0xffffffffu, mid[V - 1], 1);
      const float from_right = __shfl_down_sync(0xffffffffu, mid[0], 1);
      const unsigned lane = threadIdx.x;
      before = from_left;
      after = from_right;
      if (first) {
        before = b.left ? ldg(static_cast<const T*>(b.left),
                                   ri * b.lstride)
                        : 0.0f;
      } else if (lane == 0) {
        before = ldg(p, row + jc - 1);
      }
      if (last) {
        after = b.right ? ldg(static_cast<const T*>(b.right),
                                   ri * b.rstride)
                        : 0.0f;
      } else if (lane == blockDim.x - 1) {
        after = ldg(p, row + jc + V);
      }
    } else {
      if (first) {
        if (b.left)
          before = ldg(static_cast<const T*>(b.left), ri * b.lstride);
      } else {
        before = ldg(p, row + jc - 1);
      }
      if (last) {
        if (b.right)
          after = ldg(static_cast<const T*>(b.right), ri * b.rstride);
      } else {
        after = ldg(p, row + jc + V);
      }
    }
    pc[0] = before;
#pragma unroll
    for (int q = 0; q < V; ++q) pc[q + 1] = mid[q];
    pc[V + 1] = after;
    if (!live) return;
    float a[V], e[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int s = ghost_shift<V>(q, b.c0 + j0, n + 2);
      const float un = shifted(uc, q, s) -
                       grad(shifted(pc, q + 2, s),
                            shifted(pc, q, s));
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

// One grouped K11-block launch of `width` cells a thread.
template <int V, bool kShuffle, bool kSkip, int kMin, typename T>
int launch_gradient_variant(const GradGroup& g, int blocks, int m, int k,
                          int n, float h, cudaStream_t stream) {
  const auto kernel =
      gradient_group_variant_kernel<V, kShuffle, kSkip, kMin, T>;
  const dim3 grid((k / V + kBlockX - 1) / kBlockX,
                  (m + kBlockY - 1) / kBlockY, blocks);
  kernel<<<grid, block_dim(), 0, stream>>>(g, m, k, n, h);
  return static_cast<int>(cudaGetLastError());
}

// Field fi's cell at global (i, j), read from the part that owns it.
template <typename T>
__device__ __forceinline__ float part_cell_variant(const BlockGatherGroup& g,
                                           int fi, int i, int j) {
  const GatherPart& s = g.part[(i / g.m) * g.py + j / g.k];
  return ldg(static_cast<const T*>(s.f[fi]), (i - s.r) * s.stride + (j - s.c));
}

// f[o] and f[o + 1]: two loads (kPair 0), or where o is even one access,
// on the read-only path (kPair 1) or plain, as K3's load_pair (kPair 2).
template <int kPair>
__device__ __forceinline__ void cell_pair(const float* f, int o, float& lo,
                                          float& hi) {
  if (kPair != 0 && (o & 1) == 0) {
    const float2 q = kPair == 1
                         ? __ldg(reinterpret_cast<const float2*>(f + o))
                         : *reinterpret_cast<const float2*>(f + o);
    lo = q.x;
    hi = q.y;
  } else {
    lo = ldg(f, o);
    hi = ldg(f, o + 1);
  }
}
template <int kPair>
__device__ __forceinline__ void cell_pair(const bf16* f, int o, float& lo,
                                          float& hi) {
  if (kPair != 0 && (o & 1) == 0) {
    const unsigned w = kPair == 1
                           ? __ldg(reinterpret_cast<const unsigned*>(f + o))
                           : *reinterpret_cast<const unsigned*>(f + o);
    lo = bf16_lo(w);
    hi = bf16_hi(w);
  } else {
    lo = ldg(f, o);
    hi = ldg(f, o + 1);
  }
}

// The four corners of a departure that leaves the block, each from the
// part that owns it; kept out of line by kCall (its registers then stay
// out of the common path).
template <typename T>
__device__ __noinline__ void corners_call(const BlockGatherGroup& g, int fi,
                                          int i0, int j0, float* c) {
  c[0] = part_cell_variant<T>(g, fi, i0, j0);
  c[1] = part_cell_variant<T>(g, fi, i0 + 1, j0);
  c[2] = part_cell_variant<T>(g, fi, i0, j0 + 1);
  c[3] = part_cell_variant<T>(g, fi, i0 + 1, j0 + 1);
}

// K12-block grouped: the gather of nf fields (border modes b1, b2) at
// block blockIdx.z of the group, V cells of a row a thread (V = 1: one
// cell, as advect_block_kernel): the cell's departure (backtrace_at, or
// window_backtrace in the window of cmax cells), then each of its four
// corners read from the part that owns it, from the block's own fields
// where all four lie in it (each corner row's x-pair as one access where
// aligned with kPair), the blend and the border rule of advect_block_kernel,
// expression for expression.
template <bool kExact, int V, int kPair, bool kCall, int kMin, typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY, kMin)
    advect_group_variant_kernel(const __grid_constant__ BlockGatherGroup g,
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
        cell_pair<kPair>(f, o, g00, g01);
        cell_pair<kPair>(f, o + k, g10, g11);
      } else if constexpr (kCall) {
        float c[4];
        corners_call<T>(g, fi, d.i0, d.j0, c);
        g00 = c[0];
        g10 = c[1];
        g01 = c[2];
        g11 = c[3];
      } else {
        g00 = part_cell_variant<T>(g, fi, d.i0, d.j0);
        g10 = part_cell_variant<T>(g, fi, d.i0 + 1, d.j0);
        g01 = part_cell_variant<T>(g, fi, d.i0, d.j0 + 1);
        g11 = part_cell_variant<T>(g, fi, d.i0 + 1, d.j0 + 1);
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
template <bool kExact, int V, int kPair, bool kCall, int kMin, typename T>
int launch_gather_variant(const BlockGatherGroup& g, int blocks, int n,
                        int nf, int b1, int b2, float dt0, int cmax,
                        cudaStream_t stream) {
  const auto kernel =
      advect_group_variant_kernel<kExact, V, kPair, kCall, kMin, T>;
  const dim3 grid((g.k / V + kBlockX - 1) / kBlockX,
                  (g.m + kBlockY - 1) / kBlockY, blocks);
  kernel<<<grid, block_dim(), 0, stream>>>(g, n, nf, b1, b2, dt0, cmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace variants
