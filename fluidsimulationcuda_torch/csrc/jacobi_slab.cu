// K9 jacobi_slab: one Jacobi (or Chebyshev) sweep over rows [lo, hi) of a
// halo-extended row slab.
//
// Replaces the TPU kernel _jacobi_slab_kernel
// (fluidsimulationcuda_tpu/kernels/pallas_sharded.py:131, pallas_call at
// :290; wrapper fused_jacobi_slab :256), and is the sweep engine of the slab
// projection (:700) and of the slab density step (:1010).  The TPU kernel
// runs all sweeps of a halo exchange in VMEM, strip by strip, each strip
// with the whole K-row margin.  Here one launch is one sweep over the
// (m+2K, side) extended buffer, and the wrapper (kernels/cuda_sharded.py)
// ping-pongs between scratch buffers as K1's does, three of them for
// Chebyshev.  Sweep k computes rows [k, m+2K-k): the buffer's edge rows
// have no neighbour beyond them, and what they would hold reaches one row
// further in per sweep, so it never touches the m slab rows while k <= K.
//
// The global wall ghost rows (gtop, gbot: buffer rows, -1 when absent) take
// the set_bnd rule from the row next to them, and the corner average after
// it, in the launch that computes that row (fsc_common.cuh); ghost columns
// do the same on every row.  So the halo rows of a wall slab, zeros that lie
// outside the grid, never reach a valid cell.
//
// Bound: device memory, as K1: 12 bytes a cell (16 with Chebyshev), with the
// 2K halo rows of the buffer computed again by each slab.
#include "fsc_common.cuh"

namespace {

__global__ void jacobi_slab_kernel(fsc::SweepParams p, float* __restrict__ out,
                                   float* __restrict__ rhs_out, int side,
                                   int b, int lo, int hi, int gtop,
                                   int gbot) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = lo + static_cast<int>(blockIdx.y * blockDim.y + threadIdx.y);
  if (r >= hi || j >= side) return;
  const int n = side - 2;
  const int c = fsc::slab_row_of(r, gtop, gbot) * side + fsc::clampi(j, 1, n);
  const float rv = fsc::rhs_at(p, c);
  const float val = fsc::sweep_at(p, c, side, rv);
  // The first sweep of a folded or fast solve stores the rhs it built, once
  // per cell that is its own interior cell, for the sweeps after it.
  if (rhs_out != nullptr && c == r * side + j) rhs_out[c] = rv;
  out[r * side + j] =
      fsc::slab_border_value(val, r, j, side, gtop, gbot, b);
}

}  // namespace

// The sweep arguments (x .. flags) are those of fsc_jacobi_sweep, on
// (rows, side) buffers; rows [lo, hi) of out are written, and a sweep reads
// rows [lo-1, hi+1) of x.  Returns cudaGetLastError() after the launch.
extern "C" int fsc_jacobi_slab(const float* x, const float* rhs,
                               const float* src, const float* xm, float* out,
                               float* rhs_out, int side, int b, float alpha,
                               float beta, float ab, float inv_b,
                               float src_dt, float w, int flags, int lo,
                               int hi, int gtop, int gbot, void* stream) {
  if (hi <= lo) return 0;
  const fsc::SweepParams p = fsc::make_sweep_params(
      x, rhs, src, xm, alpha, beta, ab, inv_b, src_dt, w, flags);
  jacobi_slab_kernel<<<fsc::slab_grid_dim(side, hi - lo), fsc::block_dim(), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      p, out, rhs_out, side, b, lo, hi, gtop, gbot);
  return static_cast<int>(cudaGetLastError());
}
