// Shared device code of the Stable Fluids kernels for Hopper (sm_90a).
//
// Every 2-D kernel runs one thread per cell of the padded (side, side)
// float32 grid, row-major, cell (i, j) at i*side + j, interior 1..n with
// n = side-2; K1-K4 take a batch of such grids, one per grid layer of the
// launch (grid_dim, grid_offset).  A thread on the ghost ring evaluates the
// interior cell next to it and applies the mode-b border rule to that value
// (ops/boundary.py):
// edges mirror it (negated on the wall-normal component, b=1 at the
// left/right walls, b=2 at the top/bottom walls), corners take
// 0.5*(sy*v + sx*v).  So the border is derived in the same launch as the
// interior, never by a separate set_bnd pass, and every output has valid
// corners.  The 3-D kernels do the same on (side, side, side) volumes,
// [z, y, x] row-major, cell (k, i, j) at (k*side + i)*side + j, with the
// rule of ops/three_d.py (border_value3 below).
//
// The library is built with --fmad=false: each expression keeps the
// reference's order and rounding, so a kernel matches its plain PyTorch
// version to the last bit or so.  Where the TPU kernel's fast mode fuses on
// purpose, the code calls fmaf explicitly.
//
// K1-K3 and K5-K8 also have bf16 storage forms (JAX's bf16 mode,
// pallas_ops.py:125-149, and its jnp 3-D step): a kernel reads bf16 into
// float32, computes in float32 and rounds to bf16 (to nearest even, as
// torch.Tensor.to(torch.bfloat16) and astype(jnp.bfloat16) round) on
// store.  Each form is a template
// instantiation over its operands' types, chosen at launch; the helpers
// below (load, store, round_to, SweepParamsT) are at float the plain
// accesses they stand for, so the float32 kernels compile as before.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fsc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float load(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float load(const bf16* p, int i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int i, float v) { p[i] = v; }
__device__ __forceinline__ void store(bf16* p, int i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// v rounded to the storage type T and read back as float32.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

inline dim3 block_dim() { return dim3(kBlockX, kBlockY); }

// 2-D launches over a batch of nb (side, side) grids stored one after the
// other (nb <= 65535, checked by the wrapper): 32x8 threads over (x, y),
// one grid layer per grid of the batch, the TPU kernels' batch program
// axis (pallas_ops.py:311-312).
inline dim3 grid_dim(int side, int nb = 1) {
  return dim3((side + kBlockX - 1) / kBlockX, (side + kBlockY - 1) / kBlockY,
              nb);
}

// The first cell of the calling block's grid in a batch.  The wrappers keep
// a batch under 2^31 cells (as K17's), so it is an int, and a size_t
// offset measured 2-3% slower on one grid.  A kernel indexes every access
// at grid_offset + its in-grid index and never moves its __restrict__
// output pointers: moving them costs nvcc the proof that the inputs are
// read-only, and with it the read-only load path (LDG.E.CONSTANT), ~26% of
// K1's time on the H100 (PERF.md).
__device__ __forceinline__ int grid_offset(int side) {
  return static_cast<int>(blockIdx.z) * side * side;
}

// 3-D launches: 32x8 threads over (x, y), one grid layer per z plane.
inline dim3 grid_dim3(int side) {
  return dim3((side + kBlockX - 1) / kBlockX, (side + kBlockY - 1) / kBlockY,
              side);
}

// ---------------------------------------------------------------------------
// Vector accesses of the bf16 forms' vector kernels (K2's gradient, K3)
// ---------------------------------------------------------------------------
//
// V = 2, 4 or 8 consecutive cells of a row in one access: 2V bytes of bf16
// (16 at V = 8, one uint4), 4V bytes of float32 (two float4 at V = 8).
// The address must be aligned to the access's size (at most 16 bytes),
// which the wrappers check (cuda_ops.vector_width).  Inputs are read on
// the read-only path (__ldg).  A bf16 value widens to float32 exactly (its
// bits are the float's upper half), and each value rounds to bf16 as
// store() rounds it, so a vector kernel computes what the one-cell kernel
// computes, bit for bit.

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <int V>
__device__ __forceinline__ void load_vec(const bf16* __restrict__ p, int i,
                                         float (&o)[V]) {
  static_assert(V == 2 || V == 4 || V == 8, "a vector of 2, 4 or 8 cells");
  unsigned w[V / 2];
  if constexpr (V == 8) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p + i));
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
    w[3] = q.w;
  } else if constexpr (V == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p + i));
    w[0] = q.x;
    w[1] = q.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p + i));
  }
#pragma unroll
  for (int k = 0; k < V / 2; ++k) {
    o[2 * k] = bf16_lo(w[k]);
    o[2 * k + 1] = bf16_hi(w[k]);
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, int i,
                                         float (&o)[V]) {
  static_assert(V == 2 || V == 4 || V == 8, "a vector of 2, 4 or 8 cells");
  if constexpr (V == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p + i));
    o[0] = q.x;
    o[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + i + k));
      o[k] = q.x;
      o[k + 1] = q.y;
      o[k + 2] = q.z;
      o[k + 3] = q.w;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_vec(bf16* __restrict__ p, int i,
                                          const float (&o)[V]) {
  static_assert(V == 2 || V == 4 || V == 8, "a vector of 2, 4 or 8 cells");
  unsigned w[V / 2];
#pragma unroll
  for (int k = 0; k < V / 2; ++k)
    w[k] = bf16_bits(o[2 * k]) | (bf16_bits(o[2 * k + 1]) << 16);
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p + i) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p + i) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<unsigned*>(p + i) = w[0];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* __restrict__ p, int i,
                                          const float (&o)[V]) {
  static_assert(V == 2 || V == 4 || V == 8, "a vector of 2, 4 or 8 cells");
  if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p + i) = make_float2(o[0], o[1]);
  } else {
#pragma unroll
    for (int k = 0; k < V; k += 4)
      *reinterpret_cast<float4*>(p + i + k) =
          make_float4(o[k], o[k + 1], o[k + 2], o[k + 3]);
  }
}

// p[i] widened to float32, on the read-only path.
__device__ __forceinline__ float ldg(const float* p, int i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float ldg(const bf16* p, int i) {
  return __bfloat162float(__ldg(p + i));
}

// p[g] and p[g + 1] of a 4-byte aligned bf16 array: one 4-byte load where
// g is even, two 2-byte loads where it is odd.
__device__ __forceinline__ void load_pair(const bf16* __restrict__ p, int g,
                                          float& lo, float& hi) {
  if ((g & 1) == 0) {
    const unsigned w = *reinterpret_cast<const unsigned*>(p + g);
    lo = bf16_lo(w);
    hi = bf16_hi(w);
  } else {
    lo = load(p, g);
    hi = load(p, g + 1);
  }
}

__device__ __forceinline__ int clampi(int a, int lo, int hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}

// Whether every pointer that is not null is aligned to `bytes`.
template <typename... P>
inline bool aligned(int bytes, const P*... ptrs) {
  return ((ptrs == nullptr ||
           reinterpret_cast<size_t>(ptrs) % static_cast<size_t>(bytes) == 0) &&
          ...);
}

// Cell k of a thread's vector of V >= 2 cells that starts at column j0 of
// a row of side cells derives from cell k + ghost_shift: column 0 from
// column 1, column side-1 from column side-2, both in the same vector.
template <int V>
__device__ __forceinline__ int ghost_shift(int k, int j0, int side) {
  return (k == 0 && j0 == 0) ? 1 : ((k == V - 1 && j0 + V == side) ? -1 : 0);
}

// x[k + s] for s in {-1, 0, 1}; each alternative's index is clamped into x,
// so it is a constant once the loop over k is unrolled (no local memory).
template <int N>
__device__ __forceinline__ float shifted(const float (&x)[N], int k, int s) {
  const float below = x[k > 0 ? k - 1 : 0];
  const float above = x[k + 1 < N ? k + 1 : N - 1];
  return s > 0 ? above : (s < 0 ? below : x[k]);
}

// Flat index of the interior cell that padded cell (i, j) derives from.
__device__ __forceinline__ int interior_of(int i, int j, int side) {
  const int n = side - 2;
  return clampi(i, 1, n) * side + clampi(j, 1, n);
}

// The mode-b rule at a cell that is a ghost column (gx), a ghost row (gy),
// both (a corner) or neither, given the value v of its interior cell.
__device__ __forceinline__ float border_rule(float v, bool gx, bool gy,
                                             int b) {
  const float sx = (b == 1) ? -1.0f : 1.0f;
  const float sy = (b == 2) ? -1.0f : 1.0f;
  if (gx && gy) return 0.5f * (sy * v + sx * v);
  if (gx) return sx * v;
  if (gy) return sy * v;
  return v;
}

// The value of padded cell (i, j) given the value v of its interior cell.
__device__ __forceinline__ float border_value(float v, int i, int j, int side,
                                              int b) {
  const bool gx = (j == 0) || (j == side - 1);
  const bool gy = (i == 0) || (i == side - 1);
  return border_rule(v, gx, gy, b);
}

// ---------------------------------------------------------------------------
// Row slabs (the multi-device step, parallel/sharded.py)
// ---------------------------------------------------------------------------
//
// A slab kernel runs on a (rows, side) buffer that holds a band of
// full-width rows of the global grid, row r at r*side.  Ghost columns belong
// to every slab.  A global wall ghost row lies only in the buffer of the top
// slab (buffer row gtop) or of the bottom slab (gbot); -1 marks its absence.
// Each slab kernel takes them from the host, with the slab's first global
// row, as launch scalars: the TPU kernels read them from an SMEM vector
// (is_top, is_bot, row0).  A thread on a wall ghost row evaluates the row
// next to it, as the 2-D kernels' ghost threads do, so the edge rule and
// the corner average follow in the same launch.

// The buffer row whose value buffer row r takes.  A z-slab (below) uses it
// for planes.
__device__ __forceinline__ int slab_row_of(int r, int gtop, int gbot) {
  return r == gtop ? r + 1 : (r == gbot ? r - 1 : r);
}

// The value of buffer cell (r, j) given the value v of its interior cell.
__device__ __forceinline__ float slab_border_value(float v, int r, int j,
                                                   int side, int gtop,
                                                   int gbot, int b) {
  const bool gx = (j == 0) || (j == side - 1);
  const bool gy = (r == gtop) || (r == gbot);
  return border_rule(v, gx, gy, b);
}

// Row r of a (rows, side) slab field whose row above row 0 is the halo row
// top and whose row below row rows-1 is the halo row bot; with stride
// side*side, plane r of a z-slab and its halo planes.
template <typename T>
__device__ __forceinline__ const T* slab_row(const T* f, const T* top,
                                             const T* bot, int r, int rows,
                                             int stride) {
  return r < 0 ? top : (r >= rows ? bot : f + r * stride);
}

// 2-D launches over rows [lo, hi) of a slab buffer.
inline dim3 slab_grid_dim(int side, int rows) {
  return dim3((side + kBlockX - 1) / kBlockX, (rows + kBlockY - 1) / kBlockY);
}

// 3-D launches over `planes` planes of a z-slab buffer: 32x8 threads over
// (x, y), one grid layer per plane.
inline dim3 slab_grid_dim3(int side, int planes) {
  return dim3((side + kBlockX - 1) / kBlockX, (side + kBlockY - 1) / kBlockY,
              planes);
}

// Flat index of the interior cell that padded volume cell (k, i, j) derives
// from.
__device__ __forceinline__ int interior_of3(int k, int i, int j, int side) {
  const int n = side - 2;
  return (clampi(k, 1, n) * side + clampi(i, 1, n)) * side + clampi(j, 1, n);
}

// The value of padded volume cell (k, i, j) given the value v of its
// interior cell: the rule set_bnd3 (ops/three_d.py) derives with its face,
// edge and corner passes, evaluated at one cell.  A face is s*v, with the
// sign of the face's axis (b=1 flips x, b=2 flips y, b=3 flips z).  An edge
// with ghost axes a1 < a2 (order z, y, x) is the mean of its two face
// neighbours, 0.5*(s_a2*v + s_a1*v).  A corner is the mean of its three
// edge neighbours, third*((E_yx + E_zx) + E_zy), a multiplication by 1/3
// rounded to float32, in that order.  gx, gy, gz say which axes are ghost
// axes of the cell.
__device__ __forceinline__ float border_rule3(float v, bool gx, bool gy,
                                              bool gz, int b) {
  const float sx = (b == 1) ? -1.0f : 1.0f;
  const float sy = (b == 2) ? -1.0f : 1.0f;
  const float sz = (b == 3) ? -1.0f : 1.0f;
  const int ghosts = int(gx) + int(gy) + int(gz);
  if (ghosts == 0) return v;
  if (ghosts == 1) return gx ? sx * v : (gy ? sy * v : sz * v);
  const float e_yx = 0.5f * (sx * v + sy * v);
  const float e_zx = 0.5f * (sx * v + sz * v);
  const float e_zy = 0.5f * (sy * v + sz * v);
  if (ghosts == 2) return gz ? (gy ? e_zy : e_zx) : e_yx;
  const float third = static_cast<float>(1.0 / 3.0);
  return third * ((e_yx + e_zx) + e_zy);
}

__device__ __forceinline__ float border_value3(float v, int k, int i, int j,
                                               int side, int b) {
  return border_rule3(v, (j == 0) || (j == side - 1),
                      (i == 0) || (i == side - 1),
                      (k == 0) || (k == side - 1), b);
}

// ---------------------------------------------------------------------------
// Z-slabs (the 3-D multi-device step, parallel/sharded3d.py)
// ---------------------------------------------------------------------------
//
// A z-slab kernel runs on a (planes, side, side) buffer that holds a band of
// whole (y, x) planes of the global volume, plane k at k*side*side.  Ghost
// rows and columns belong to every plane; a global wall ghost plane lies
// only in the buffer of the top slab (buffer plane gtop) or of the bottom
// slab (gbot), -1 marking its absence, as the row slabs' wall rows do.  A
// thread on a wall ghost plane evaluates the plane next to it
// (slab_row_of), so faces, edges and corners follow in the same launch.

// Flat index of the interior cell that buffer cell (k, i, j) derives from.
__device__ __forceinline__ int slab_interior_of3(int k, int i, int j,
                                                 int side, int gtop,
                                                 int gbot) {
  const int n = side - 2;
  return (slab_row_of(k, gtop, gbot) * side + clampi(i, 1, n)) * side +
         clampi(j, 1, n);
}

// The value of buffer cell (k, i, j) given the value v of its interior
// cell.
__device__ __forceinline__ float slab_border_value3(float v, int k, int i,
                                                    int j, int side, int gtop,
                                                    int gbot, int b) {
  return border_rule3(v, (j == 0) || (j == side - 1),
                      (i == 0) || (i == side - 1), (k == gtop) || (k == gbot),
                      b);
}

// ---------------------------------------------------------------------------
// One Jacobi sweep at one interior cell (ops/diffuse.py, ops/three_d.py,
// ops/chebyshev.py)
// ---------------------------------------------------------------------------

enum SweepFlags {
  kPrep = 1,   // rhs holds the raw base: fold src and/or pre-scale it here
  kFast = 2,   // reciprocal form rhs/beta + (alpha/beta)*neigh
  kCheby = 4,  // Chebyshev three-term combine with x_{k-1}
  kDamp = 8,   // damped Jacobi (1-w)*x_k + w*S(x_k): K1 applies it after
               // sweep_update (jacobi.cu), so no other kernel carries it
};

// The operands of one sweep, stored as TX (x_k and src), TM (x_{k-1}) and
// TR (rhs); every kernel but the bf16 forms takes them all as float.
template <typename TX = float, typename TM = float, typename TR = float>
struct SweepParamsT {
  const TX* x;    // x_k; null means the zero guess
  const TR* rhs;  // right-hand side (raw base when kPrep)
  const TX* src;  // folded into rhs as rhs + src_dt*src when kPrep; may be null
  const TM* xm;   // x_{k-1} for kCheby; null means zero
  float alpha, beta, ab, inv_b, src_dt, w;
  int flags;
};
using SweepParams = SweepParamsT<>;

// The rhs at interior cell c, as the first sweep of a solve builds it
// (pallas_ops.py:415-428): base + dt*src, times 1/beta in fast mode,
// rounded to the rhs's storage type before any sweep reads it (bf16 mode
// restages it in its storage dtype, rdt, :416-428).
template <typename TX, typename TM, typename TR>
__device__ __forceinline__ float rhs_at(const SweepParamsT<TX, TM, TR>& p,
                                        int c) {
  float r = load(p.rhs, c);
  if (p.flags & kPrep) {
    if (p.src) r = r + p.src_dt * load(p.src, c);
    if (p.flags & kFast) r = r * p.inv_b;
    r = round_to<TR>(r);
  }
  return r;
}

// The Chebyshev combine w*S(x_k) + (1-w)*x_{k-1} of a Jacobi update val
// and x_{k-1} at its cell.
__device__ __forceinline__ float cheby_combine(float w, float val,
                                               float prev) {
  return w * val + (1.0f - w) * prev;
}

// The Jacobi update of a cell from its neighbour sum and rhs value r.
template <typename TX, typename TM, typename TR>
__device__ __forceinline__ float jacobi_update(
    const SweepParamsT<TX, TM, TR>& p, float neigh, float r) {
  return (p.flags & kFast) ? fmaf(p.ab, neigh, r)
                           : (r + p.alpha * neigh) / p.beta;
}

// x_{k+1} at interior cell c from its neighbour sum and rhs value r: the
// Jacobi update, then the Chebyshev combine read pointwise.
template <typename TX, typename TM, typename TR>
__device__ __forceinline__ float sweep_update(
    const SweepParamsT<TX, TM, TR>& p, int c, float neigh, float r) {
  float val = jacobi_update(p, neigh, r);
  if (p.flags & kCheby)
    val = cheby_combine(p.w, val, p.xm ? load(p.xm, c) : 0.0f);
  return val;
}

// 2-D: the neighbour sum in the order ((L+R)+U)+D of ops/diffuse.py:29.
template <typename TX, typename TM, typename TR>
__device__ __forceinline__ float sweep_at(const SweepParamsT<TX, TM, TR>& p,
                                          int c, int side, float r) {
  float neigh = 0.0f;
  if (p.x)
    neigh = ((load(p.x, c - 1) + load(p.x, c + 1)) + load(p.x, c - side)) +
            load(p.x, c + side);
  return sweep_update(p, c, neigh, r);
}

// 3-D: the neighbour sum in the order ((L+R)+(U+D))+(F+B) of
// ops/three_d.py (x, then y, then z neighbours).
template <typename TX, typename TM, typename TR>
__device__ __forceinline__ float sweep_at3(const SweepParamsT<TX, TM, TR>& p,
                                           int c, int side, float r) {
  float neigh = 0.0f;
  if (p.x) {
    const int plane = side * side;
    neigh = ((load(p.x, c - 1) + load(p.x, c + 1)) +
             (load(p.x, c - side) + load(p.x, c + side))) +
            (load(p.x, c - plane) + load(p.x, c + plane));
  }
  return sweep_update(p, c, neigh, r);
}

inline SweepParams make_sweep_params(const float* x, const float* rhs,
                                     const float* src, const float* xm,
                                     float alpha, float beta, float ab,
                                     float inv_b, float src_dt, float w,
                                     int flags) {
  SweepParams p;
  p.x = x;
  p.rhs = rhs;
  p.src = src;
  p.xm = xm;
  p.alpha = alpha;
  p.beta = beta;
  p.ab = ab;
  p.inv_b = inv_b;
  p.src_dt = src_dt;
  p.w = w;
  p.flags = flags;
  return p;
}

// ---------------------------------------------------------------------------
// Semi-Lagrangian backtrace (ops/advect.py)
// ---------------------------------------------------------------------------

struct Departure {
  int i0, j0;          // lower-left gather cell, each in [0, n]
  float s0, s1, t0, t1;  // bilinear weights
};

// Departure point of interior cell (ci, cj): (cj, ci) - dt0*(u, v), clamped
// to [0.5, n+0.5], truncated.  fminf/fmaxf also map a NaN velocity into the
// box, so the four gather reads stay inside the grid whatever the input.
// The coordinates are float32 whatever the velocities store.
// backtrace_at takes the cell's velocity (uc, vc) as values.
__device__ __forceinline__ Departure backtrace_at(float uc, float vc, int ci,
                                                  int cj, int side,
                                                  float dt0) {
  const float lo = 0.5f;
  const float hi = static_cast<float>(side - 2) + 0.5f;
  float x = static_cast<float>(cj) - dt0 * uc;
  float y = static_cast<float>(ci) - dt0 * vc;
  x = fminf(fmaxf(x, lo), hi);
  y = fminf(fmaxf(y, lo), hi);
  Departure d;
  d.j0 = static_cast<int>(x);
  d.i0 = static_cast<int>(y);
  d.s1 = x - static_cast<float>(d.j0);
  d.s0 = 1.0f - d.s1;
  d.t1 = y - static_cast<float>(d.i0);
  d.t0 = 1.0f - d.t1;
  return d;
}

template <typename T>
__device__ __forceinline__ Departure backtrace(const T* u, const T* v, int ci,
                                               int cj, int side, float dt0) {
  const int c = ci * side + cj;
  return backtrace_at(load(u, c), load(v, c), ci, cj, side, dt0);
}

// The reference's blend order (FluidSequential.c:136-137).
__device__ __forceinline__ float blend(const Departure& d, float g00,
                                       float g10, float g01, float g11) {
  return d.s0 * (d.t0 * g00 + d.t1 * g10) + d.s1 * (d.t0 * g01 + d.t1 * g11);
}

// One coordinate of an exact departure point: g - dt0*vel for the cell at
// global coordinate g, clamped to [0.5, n+0.5] (the expressions of
// backtrace_at and backtrace3, and of the multi-device exact gathers,
// parallel/sharded.py:249-256 and sharded3d.py:296-310 of the JAX package).
__device__ __forceinline__ float exact_coord(int g, float vel, int n,
                                             float dt0) {
  return fminf(fmaxf(static_cast<float>(g) - dt0 * vel, 0.5f),
               static_cast<float>(n) + 0.5f);
}

// One coordinate of a departure point under the window clamp of the
// multi-device gathers (pallas_sharded.py:1089-1096, sharded3d.py:354-356):
// exact_coord, then clamped to [g - cmax, g + cmax], in that order.
__device__ __forceinline__ float window_coord(int g, float vel, int n,
                                              float dt0, int cmax) {
  const float fg = static_cast<float>(g);
  const float c = static_cast<float>(cmax);
  return fminf(fmaxf(exact_coord(g, vel, n, dt0), fg - c), fg + c);
}

// Departure point of the cell at global (row gr, column gc) with velocity
// (uc, vc) under the window clamp, truncated.  i0 is a global row.
__device__ __forceinline__ Departure window_backtrace(float uc, float vc,
                                                      int gr, int gc, int n,
                                                      float dt0, int cmax) {
  const float x = window_coord(gc, uc, n, dt0, cmax);
  const float y = window_coord(gr, vc, n, dt0, cmax);
  Departure d;
  d.j0 = static_cast<int>(x);
  d.i0 = static_cast<int>(y);
  d.s1 = x - static_cast<float>(d.j0);
  d.s0 = 1.0f - d.s1;
  d.t1 = y - static_cast<float>(d.i0);
  d.t0 = 1.0f - d.t1;
  return d;
}

// Departure point of interior cell (ci, cj) of a (side, side) grid: exact
// (backtrace) for cmax <= 0, under the window clamp of cmax cells
// (window_backtrace, ops/advect.py advect_windowed) otherwise.
// departure_at takes the cell's velocity (uc, vc) as values.
__device__ __forceinline__ Departure departure_at(float uc, float vc, int ci,
                                                  int cj, int side, float dt0,
                                                  int cmax) {
  if (cmax <= 0) return backtrace_at(uc, vc, ci, cj, side, dt0);
  return window_backtrace(uc, vc, ci, cj, side - 2, dt0, cmax);
}

template <typename T>
__device__ __forceinline__ Departure departure(const T* u, const T* v, int ci,
                                               int cj, int side, float dt0,
                                               int cmax) {
  const int c = ci * side + cj;
  return departure_at(load(u, c), load(v, c), ci, cj, side, dt0, cmax);
}

// 3-D departure of interior cell (ck, ci, cj): (cj, ci, ck) - dt0*(u, v, w)
// clamped per axis to [0.5, n+0.5] and truncated (ops/three_d.py advect3).
struct Departure3 {
  int base;            // flat index of the lower gather corner
  float fx, fy, fz;    // trilinear weights of the upper corner per axis
};

// The truncated departure point (x, y, z) in a buffer whose plane 0 is
// global plane z0.
__device__ __forceinline__ Departure3 departure3(float x, float y, float z,
                                                 int side, int z0) {
  const int i0 = static_cast<int>(x);
  const int j0 = static_cast<int>(y);
  const int k0 = static_cast<int>(z);
  Departure3 d;
  d.base = ((k0 - z0) * side + j0) * side + i0;
  d.fx = x - static_cast<float>(i0);
  d.fy = y - static_cast<float>(j0);
  d.fz = z - static_cast<float>(k0);
  return d;
}

// The coordinates are float32 whatever the velocities store (T: float or
// bf16).
template <typename T>
__device__ __forceinline__ Departure3 backtrace3(const T* u, const T* v,
                                                 const T* w, int ck, int ci,
                                                 int cj, int side,
                                                 float dt0) {
  const int c = (ck * side + ci) * side + cj;
  const float lo = 0.5f;
  const float hi = static_cast<float>(side - 2) + 0.5f;
  float x = static_cast<float>(cj) - dt0 * load(u, c);
  float y = static_cast<float>(ci) - dt0 * load(v, c);
  float z = static_cast<float>(ck) - dt0 * load(w, c);
  x = fminf(fmaxf(x, lo), hi);
  y = fminf(fmaxf(y, lo), hi);
  z = fminf(fmaxf(z, lo), hi);
  return departure3(x, y, z, side, 0);
}

// 3-D departure of interior cell (ck, ci, cj) under the window clamp of
// cmax cells per axis (window_coord; ops/three_d.py advect3_windowed), the
// windowed twin of backtrace3.
template <typename T>
__device__ __forceinline__ Departure3 window_backtrace3(
    const T* u, const T* v, const T* w, int ck, int ci, int cj, int side,
    float dt0, int cmax) {
  const int c = (ck * side + ci) * side + cj;
  const int n = side - 2;
  return departure3(window_coord(cj, load(u, c), n, dt0, cmax),
                    window_coord(ci, load(v, c), n, dt0, cmax),
                    window_coord(ck, load(w, c), n, dt0, cmax), side, 0);
}

// The trilinear blend in the order of ops/three_d.py advect3:
// (1-fz)*((1-fy)*((1-fx)*g000 + fx*g001) + fy*(...)) + fz*(...), in
// float32 whatever f stores (T: float or bf16).
template <typename T>
__device__ __forceinline__ float trilinear(const Departure3& d,
                                           const T* __restrict__ f,
                                           int side) {
  const int plane = side * side;
  const T* g = f + d.base;
  const float gx = 1.0f - d.fx;
  const float gy = 1.0f - d.fy;
  const float gz = 1.0f - d.fz;
  return gz * (gy * (gx * load(g, 0) + d.fx * load(g, 1)) +
               d.fy * (gx * load(g, side) + d.fx * load(g, side + 1))) +
         d.fz * (gy * (gx * load(g, plane) + d.fx * load(g, plane + 1)) +
                 d.fy * (gx * load(g, plane + side) +
                         d.fx * load(g, plane + side + 1)));
}

}  // namespace fsc
