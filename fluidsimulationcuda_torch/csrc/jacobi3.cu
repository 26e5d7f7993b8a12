// K5 jacobi3_sweep: one 7-point Jacobi (or Chebyshev) sweep of a padded
// volume.
//
// Replaces the sweep body of the TPU kernel _jacobi3_kernel
// (fluidsimulationcuda_tpu/kernels/pallas_ops_3d.py:155), reached through
// fused_jacobi3 (:369) at the pallas_calls of _fused_jacobi3_call (:458)
// and, with the Chebyshev combine, _fused_jacobi3_cheby_call (:522).  The
// TPU kernel fuses several sweeps per VMEM round-trip over z-plane strips
// with margins and carries x_{k-1} between its calls; here one launch is
// one sweep, the wrapper rotates scratch volumes (kernels/cuda_ops.py
// _Sweeps), and nothing is carried between blocks.
//
// Bound: device memory.  A sweep reads x (seven points, six of them shared
// with neighbouring threads through L1/L2), rhs and, for Chebyshev,
// x_{k-1}, and writes one value: 12-16 bytes a cell, 60-80 us at 256^3 on
// 3.35 TB/s.  A 67 MB field does not stay in the 50 MB L2, so every sweep
// goes to HBM.  The ghost layer is derived in the same launch (fsc_common.cuh
// border_value3); the first sweep reads the guess as it is, ghost faces
// included, as ops/three_d.py diffuse3 does.
#include "fsc_common.cuh"

namespace {

__global__ void jacobi3_sweep_kernel(fsc::SweepParams p,
                                     float* __restrict__ out,
                                     float* __restrict__ rhs_out, int side,
                                     int b) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= side || j >= side) return;
  const int c = fsc::interior_of3(k, i, j, side);
  const int o = (k * side + i) * side + j;
  const float r = fsc::rhs_at(p, c);
  const float val = fsc::sweep_at3(p, c, side, r);
  // The first sweep of a folded solve stores the rhs it built, once per
  // interior cell, for the sweeps after it.
  if (rhs_out != nullptr && c == o) rhs_out[c] = r;
  out[o] = fsc::border_value3(val, k, i, j, side, b);
}

}  // namespace

// The arguments of fsc_jacobi_sweep (jacobi.cu) on a (side, side, side)
// volume.  Returns cudaGetLastError() after the launch.
extern "C" int fsc_jacobi3_sweep(const float* x, const float* rhs,
                                 const float* src, const float* xm, float* out,
                                 float* rhs_out, int side, int b, float alpha,
                                 float beta, float ab, float inv_b,
                                 float src_dt, float w, int flags,
                                 void* stream) {
  const fsc::SweepParams p = fsc::make_sweep_params(
      x, rhs, src, xm, alpha, beta, ab, inv_b, src_dt, w, flags);
  jacobi3_sweep_kernel<<<fsc::grid_dim3(side), fsc::block_dim(), 0,
                         static_cast<cudaStream_t>(stream)>>>(p, out, rhs_out,
                                                              side, b);
  return static_cast<int>(cudaGetLastError());
}
