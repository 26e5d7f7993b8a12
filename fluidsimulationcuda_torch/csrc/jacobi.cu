// K1 jacobi_sweep: one Jacobi (or Chebyshev) sweep of a batch of padded
// grids.
//
// Replaces the sweep body of the TPU kernel _jacobi_kernel
// (fluidsimulationcuda_tpu/kernels/pallas_ops.py:301, pallas_call at :645)
// and is the sweep engine of the projection (:899) and of the fused density
// step (:1480).  The TPU kernel fuses up to 20 sweeps per VMEM round-trip in
// row strips with K-deep margins; here one launch is one sweep and the
// wrapper ping-pongs between scratch tensors, so nothing is carried between
// blocks.  Like the TPU kernel's batch program axis, the launch's grid
// layers are the grids of a batch, each swept alone; grids [0, nb1) take
// boundary mode b and the rest b1, which is the u/v pair of
// fused_jacobi_pair (:671, the TPU kernel's nb1 at :393-400).  With the
// kDamp flag a sweep is damped Jacobi, (1-w)*x + w*sweep in the TPU
// kernel's order (damp, :432-459): the smoother of the multigrid pressure
// solve (ops/multigrid.py), w = 0.8.  1-w comes from the host, rounded to
// float32 once from the double 1 - damp as the TPU kernel takes it (:434);
// 1.0f - 0.8f on the device is one ulp away.  The damped form is its own
// instantiation, so the undamped sweep compiles as it did without it.
//
// Bound: device memory.  A sweep reads x (five points, four of them shared
// with neighbouring threads through L1/L2), rhs, and for Chebyshev x_{k-1},
// and writes one value: 12-16 bytes a cell, no reuse across launches beyond
// what the 50 MB L2 keeps of a 16 MB (2048^2) field.  The border is derived
// in the same launch (fsc_common.cuh), so a sweep costs one pass, not two.
#include "fsc_common.cuh"

namespace {

template <bool kDamped>
__global__ void jacobi_sweep_kernel(fsc::SweepParams p, float* __restrict__ out,
                                    float* __restrict__ rhs_out, int side,
                                    int b, int nb1, int b1, float omw) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= side || j >= side) return;
  const int off = fsc::grid_offset(side);
  const int mode = static_cast<int>(blockIdx.z) < nb1 ? b : b1;
  const int c = fsc::interior_of(i, j, side);
  const int g = off + c;
  const float r = fsc::rhs_at(p, g);
  float val = fsc::sweep_at(p, g, side, r);
  if (kDamped) val = omw * (p.x ? p.x[g] : 0.0f) + p.w * val;
  // The first sweep of a folded solve stores the rhs it built, once per
  // interior cell, for the sweeps after it.
  if (rhs_out != nullptr && c == i * side + j) rhs_out[g] = r;
  out[off + i * side + j] = fsc::border_value(val, i, j, side, mode);
}

}  // namespace

// Every pointer holds nb grids of side^2 cells.  x, src, xm and rhs_out may
// be null (see fsc::SweepParams); out must not alias any input.  Grids
// [0, nb1) take boundary mode b, grids [nb1, nb) mode b1.  omw is 1-w of
// the damped sweep (flags has kDamp; kCheby excluded), unread otherwise.
// Returns cudaGetLastError() after the launch.
extern "C" int fsc_jacobi_sweep(const float* x, const float* rhs,
                                const float* src, const float* xm, float* out,
                                float* rhs_out, int side, int b, float alpha,
                                float beta, float ab, float inv_b,
                                float src_dt, float w, int flags, int nb,
                                int nb1, int b1, float omw, void* stream) {
  const fsc::SweepParams p = fsc::make_sweep_params(
      x, rhs, src, xm, alpha, beta, ab, inv_b, src_dt, w, flags);
  const auto kernel = (flags & fsc::kDamp) ? jacobi_sweep_kernel<true>
                                           : jacobi_sweep_kernel<false>;
  kernel<<<fsc::grid_dim(side, nb), fsc::block_dim(), 0,
           static_cast<cudaStream_t>(stream)>>>(p, out, rhs_out, side, b, nb1,
                                                b1, omw);
  return static_cast<int>(cudaGetLastError());
}
