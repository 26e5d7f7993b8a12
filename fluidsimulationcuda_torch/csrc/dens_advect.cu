// K4 dens_advect: the last density sweep and the advection gather in one
// launch.
//
// Replaces the TPU kernel _dens_fused_kernel
// (fluidsimulationcuda_tpu/kernels/pallas_ops.py:1211, pallas_call at
// :1480; wrapper fused_dens_advect :1424), the whole dens_step of
// FluidSequential.c:176-186.  The wrapper runs the first iters-1 sweeps
// with K1; this kernel evaluates the last sweep on the fly at the four
// gather points of each cell's departure point (with the Chebyshev combine
// and the derived border rule at ghost and corner points) and blends them.
// The diffused field is never written to device memory, which is what the
// TPU fusion (pallas_ops.py:1219-1234) existed for.  The departure point is
// exact for cmax <= 0 and window-clamped to cmax cells otherwise, as K3's
// (fsc_common.cuh: departure).
//
// Bound: memory latency more than bandwidth.  A cell reads u, v and, for
// each of four gather points, the five stencil points of x_{K-1}, rhs and
// for Chebyshev x_{K-2}: some 28 loads, almost all L1/L2 hits for a smooth
// flow, against one 4-byte write.  It saves one 2048^2 write and read of
// the diffused field against K1 followed by K3; whether that pays on Hopper
// is measured against the plain composition (PERF.md).  A launch takes a
// batch of grids, one per grid layer, as K1 does.
#include "fsc_common.cuh"

namespace {

// The last sweep's value at padded cell (gi, gj) of the grid that starts at
// cell off of the batch, border derived.
__device__ __forceinline__ float swept_at(const fsc::SweepParams& p,
                                          int off, int gi, int gj,
                                          int side, int b) {
  const int c = off + fsc::interior_of(gi, gj, side);
  const float val = fsc::sweep_at(p, c, side, fsc::rhs_at(p, c));
  return fsc::border_value(val, gi, gj, side, b);
}

__global__ void dens_advect_kernel(fsc::SweepParams p,
                                   const float* __restrict__ u,
                                   const float* __restrict__ v,
                                   float* __restrict__ out, int side, int b,
                                   float dt0, int cmax) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= side || j >= side) return;
  const int n = side - 2;
  const int off = fsc::grid_offset(side);
  const fsc::Departure d =
      fsc::departure(u + off, v + off, fsc::clampi(i, 1, n),
                     fsc::clampi(j, 1, n), side, dt0, cmax);
  const float g00 = swept_at(p, off, d.i0, d.j0, side, b);
  const float g10 = swept_at(p, off, d.i0 + 1, d.j0, side, b);
  const float g01 = swept_at(p, off, d.i0, d.j0 + 1, side, b);
  const float g11 = swept_at(p, off, d.i0 + 1, d.j0 + 1, side, b);
  out[off + i * side + j] =
      fsc::border_value(fsc::blend(d, g00, g10, g01, g11), i, j, side, b);
}

}  // namespace

// The sweep arguments (x .. flags) are those of fsc_jacobi_sweep for the
// last sweep; every pointer holds nb grids of side^2 cells; cmax <= 0
// gathers exactly.  Returns cudaGetLastError() after the launch.
extern "C" int fsc_dens_advect(const float* x, const float* rhs,
                               const float* src, const float* xm, float alpha,
                               float beta, float ab, float inv_b, float src_dt,
                               float w, int flags, const float* u,
                               const float* v, float* out, int side, int nb,
                               int b, float dt0, int cmax, void* stream) {
  const fsc::SweepParams p = fsc::make_sweep_params(
      x, rhs, src, xm, alpha, beta, ab, inv_b, src_dt, w, flags);
  dens_advect_kernel<<<fsc::grid_dim(side, nb), fsc::block_dim(), 0,
                       static_cast<cudaStream_t>(stream)>>>(p, u, v, out, side,
                                                            b, dt0, cmax);
  return static_cast<int>(cudaGetLastError());
}
