// Shared device code of the Stable Fluids kernels for Hopper (sm_90a).
//
// Every kernel runs one thread per cell of the padded (side, side) float32
// grid, row-major, cell (i, j) at i*side + j, interior 1..n with n = side-2.
// A thread on the ghost ring evaluates the interior cell next to it and
// applies the mode-b border rule to that value (ops/boundary.py): edges
// mirror it (negated on the wall-normal component, b=1 at the left/right
// walls, b=2 at the top/bottom walls), corners take 0.5*(sy*v + sx*v).  So
// the border is derived in the same launch as the interior, never by a
// separate set_bnd pass, and every output has valid corners.
//
// The library is built with --fmad=false: each expression keeps the
// reference's order and rounding, so a kernel matches its plain PyTorch
// version to the last bit or so.  Where the TPU kernel's fast mode fuses on
// purpose, the code calls fmaf explicitly.
#pragma once

#include <cuda_runtime.h>

namespace fsc {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

inline dim3 block_dim() { return dim3(kBlockX, kBlockY); }
inline dim3 grid_dim(int side) {
  return dim3((side + kBlockX - 1) / kBlockX, (side + kBlockY - 1) / kBlockY);
}

__device__ __forceinline__ int clampi(int a, int lo, int hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}

// Flat index of the interior cell that padded cell (i, j) derives from.
__device__ __forceinline__ int interior_of(int i, int j, int side) {
  const int n = side - 2;
  return clampi(i, 1, n) * side + clampi(j, 1, n);
}

// The value of padded cell (i, j) given the value v of its interior cell.
__device__ __forceinline__ float border_value(float v, int i, int j, int side,
                                              int b) {
  const bool gx = (j == 0) || (j == side - 1);
  const bool gy = (i == 0) || (i == side - 1);
  const float sx = (b == 1) ? -1.0f : 1.0f;
  const float sy = (b == 2) ? -1.0f : 1.0f;
  if (gx && gy) return 0.5f * (sy * v + sx * v);
  if (gx) return sx * v;
  if (gy) return sy * v;
  return v;
}

// ---------------------------------------------------------------------------
// One Jacobi sweep at one interior cell (ops/diffuse.py, ops/chebyshev.py)
// ---------------------------------------------------------------------------

enum SweepFlags {
  kPrep = 1,   // rhs holds the raw base: fold src and/or pre-scale it here
  kFast = 2,   // reciprocal form rhs/beta + (alpha/beta)*neigh
  kCheby = 4,  // Chebyshev three-term combine with x_{k-1}
};

struct SweepParams {
  const float* x;    // x_k; null means the zero guess
  const float* rhs;  // right-hand side (raw base when kPrep)
  const float* src;  // folded into rhs as rhs + src_dt*src when kPrep; may be null
  const float* xm;   // x_{k-1} for kCheby; null means zero
  float alpha, beta, ab, inv_b, src_dt, w;
  int flags;
};

// The rhs at interior cell c, as the first sweep of a solve builds it
// (pallas_ops.py:415-428): base + dt*src, times 1/beta in fast mode.
__device__ __forceinline__ float rhs_at(const SweepParams& p, int c) {
  float r = p.rhs[c];
  if (p.flags & kPrep) {
    if (p.src) r = r + p.src_dt * p.src[c];
    if (p.flags & kFast) r = r * p.inv_b;
  }
  return r;
}

// x_{k+1} at interior cell c with rhs value r: the neighbour sum in the
// order ((L+R)+U)+D of ops/diffuse.py:29, then the Jacobi update, then the
// Chebyshev combine w*S(x_k) + (1-w)*x_{k-1} read pointwise.
__device__ __forceinline__ float sweep_at(const SweepParams& p, int c, int side,
                                          float r) {
  float neigh = 0.0f;
  if (p.x) neigh = ((p.x[c - 1] + p.x[c + 1]) + p.x[c - side]) + p.x[c + side];
  float val = (p.flags & kFast) ? fmaf(p.ab, neigh, r)
                                : (r + p.alpha * neigh) / p.beta;
  if (p.flags & kCheby) {
    const float prev = p.xm ? p.xm[c] : 0.0f;
    val = p.w * val + (1.0f - p.w) * prev;
  }
  return val;
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
__device__ __forceinline__ Departure backtrace(const float* u, const float* v,
                                               int ci, int cj, int side,
                                               float dt0) {
  const int c = ci * side + cj;
  const float lo = 0.5f;
  const float hi = static_cast<float>(side - 2) + 0.5f;
  float x = static_cast<float>(cj) - dt0 * u[c];
  float y = static_cast<float>(ci) - dt0 * v[c];
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

// The reference's blend order (FluidSequential.c:136-137).
__device__ __forceinline__ float blend(const Departure& d, float g00,
                                       float g10, float g01, float g11) {
  return d.s0 * (d.t0 * g00 + d.t1 * g10) + d.s1 * (d.t0 * g01 + d.t1 * g11);
}

}  // namespace fsc
