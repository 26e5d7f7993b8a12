// K18 jacobi_slab_split: the first sweep of a slab Jacobi solve whose
// halo-extended window is read from three operands (top halo, slab, bottom
// halo), so no concatenated extended slab is built.
//
// Replaces the TPU kernel _jacobi_slab_split_kernel
// (fluidsimulationcuda_tpu/kernels/pallas_sharded.py:329, pallas_call at
// :506; wrapper fused_jacobi_slab_split :473).  The TPU kernel assembles
// each strip's window from three DMAs (K | tm | K rows) instead of reading
// a jnp-concatenated extended slab, which costs a full HBM copy per solve.
// Here the first sweep reads x and rhs through three row pointers (ext row r
// from the top halo for r < K, from the slab for K <= r < K+m, from the
// bottom halo after), computes rows [1, m+2K-1) of x_1 into an extended
// buffer, and stores the extended rhs it read as a by-product (pre-scaled by
// 1/beta in fast mode), the way K9's first sweep stores the rhs it builds
// (jacobi_slab.cu).  Sweeps 2..s are K9 launches on those extended buffers.
// So the halo assembly folds into the first sweep and no copy kernel runs.
// Each expression is K9's, in its order, so the result equals K9 on the
// concatenated slab bit for bit.
//
// Bound: device memory, as K9's first sweep: x and rhs read once (m+2K rows
// each), x_1 and the extended rhs written once (m+2K-2 rows each).
//
// No path launches it any more: B13's first launch is the tiled K9's
// split-source form (fsc_jacobi_slab_sweeps_split, jacobi_tiles.cu), T
// sweeps in shared-memory tiles read from the same three operands.  This
// one-sweep form stays as the head of the per-sweep chain that form is
// held to (cuda_ops.launch_sweeps(0), then the per-sweep K9), as
// jacobi_slab.cu stays for the tiled K9.
#include "fsc_common.cuh"

namespace {

// Row r of the extended (m+2K, side) window, from the operand that holds it.
__device__ __forceinline__ const float* split_row(const float* top,
                                                  const float* slab,
                                                  const float* bot, int r,
                                                  int K, int m, int side) {
  return r < K ? top + r * side
               : (r < K + m ? slab + (r - K) * side
                            : bot + (r - K - m) * side);
}

__global__ void jacobi_slab_split_kernel(
    const float* __restrict__ x, const float* __restrict__ x_top,
    const float* __restrict__ x_bot, const float* __restrict__ rhs,
    const float* __restrict__ rhs_top, const float* __restrict__ rhs_bot,
    float* __restrict__ out, float* __restrict__ rhs_out, int m, int K,
    int side, int b, fsc::SweepParams p, int gtop, int gbot) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = 1 + static_cast<int>(blockIdx.y * blockDim.y + threadIdx.y);
  if (r >= m + 2 * K - 1 || j >= side) return;
  const int n = side - 2;
  const int ri = fsc::slab_row_of(r, gtop, gbot);
  const int cj = fsc::clampi(j, 1, n);
  float rv = split_row(rhs_top, rhs, rhs_bot, ri, K, m, side)[cj];
  if (p.flags & fsc::kFast) rv = rv * p.inv_b;
  // The neighbour sum in the order ((L+R)+U)+D of fsc::sweep_at.
  float neigh = 0.0f;
  if (x != nullptr) {
    const float* xc = split_row(x_top, x, x_bot, ri, K, m, side);
    const float* xu = split_row(x_top, x, x_bot, ri - 1, K, m, side);
    const float* xd = split_row(x_top, x, x_bot, ri + 1, K, m, side);
    neigh = ((xc[cj - 1] + xc[cj + 1]) + xu[cj]) + xd[cj];
  }
  const float val = fsc::sweep_update(p, 0, neigh, rv);
  // The rhs, stored once per cell that is its own interior cell, as K9's
  // first sweep stores the rhs it builds; the later sweeps read only those.
  if (ri == r && cj == j) rhs_out[r * side + j] = rv;
  out[r * side + j] = fsc::slab_border_value(val, r, j, side, gtop, gbot, b);
}

}  // namespace

// x (m, side), x_top and x_bot (K, side) may be null together (the zero
// guess); rhs, rhs_top, rhs_bot likewise shaped, never null.  out and
// rhs_out are (m+2K, side) buffers; rows [1, m+2K-1) of out and the cells of
// those rows that are their own interior cells of rhs_out are written.
// flags: fsc::kFast or 0.  gtop, gbot: ext rows of the global wall ghost
// rows (-1 when absent).  Returns cudaGetLastError() after the launch.
extern "C" int fsc_jacobi_slab_split(const float* x, const float* x_top,
                                     const float* x_bot, const float* rhs,
                                     const float* rhs_top,
                                     const float* rhs_bot, float* out,
                                     float* rhs_out, int m, int K, int side,
                                     int b, float alpha, float beta, float ab,
                                     float inv_b, int flags, int gtop,
                                     int gbot, void* stream) {
  const fsc::SweepParams p = fsc::make_sweep_params(
      nullptr, nullptr, nullptr, nullptr, alpha, beta, ab, inv_b, 0.0f, 0.0f,
      flags & fsc::kFast);
  jacobi_slab_split_kernel<<<fsc::slab_grid_dim(side, m + 2 * K - 2),
                             fsc::block_dim(), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      x, x_top, x_bot, rhs, rhs_top, rhs_bot, out, rhs_out, m, K, side, b, p,
      gtop, gbot);
  return static_cast<int>(cudaGetLastError());
}
