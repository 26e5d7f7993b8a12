// K6 advect3: semi-Lagrangian backtrace and trilinear gather of one to
// three fields that share the backtrace.
//
// Replaces the TPU kernels _advect3_kernel (pallas_call at
// fluidsimulationcuda_tpu/kernels/pallas_ops_3d.py:728; advect3_shift_fused
// :1001) and _advect3_flat_kernel (pallas_call at :971; advect3_shift
// :992).  The TPU has no fast dynamic gather, so it decomposed the gather
// into (2C+1)^3 masked shifts over a VMEM window of z planes, each
// departure coordinate clamped to C = cmax cells around its cell.  Hopper
// gathers through L1/L2 directly, so the window costs nothing here: with
// cmax <= 0 this kernel is the exact gather of ops/three_d.py advect3 at
// any displacement; with cmax >= 1 it clamps each coordinate as the TPU
// kernel does (fsc_common.cuh window_coord, which K3, K4, K12 and K14
// share) and reads the eight points directly, which is ops/three_d.py
// advect3_windowed.  The two agree while the displacement stays at or
// below cmax on every axis.  The windowed form is its own instantiation,
// so the exact gather compiles as it did without it.
//
// Bound: device memory.  A cell reads u, v, w and eight gather points per
// field (neighbours of each other for a smooth flow, so mostly L1/L2 hits)
// and writes one value per field: 5 field passes for one field, 6 for the
// self-advected (u, v, w) triple, whose fields are the velocities.  Outputs
// are fresh tensors, so the three self-advections all read the
// pre-advection velocity (stable_fluids_3d.py:118-119).
#include "fsc_common.cuh"

namespace {

template <bool kWindowed>
__global__ void advect3_kernel(const float* __restrict__ d1,
                               const float* __restrict__ d2,
                               const float* __restrict__ d3,
                               const float* __restrict__ u,
                               const float* __restrict__ v,
                               const float* __restrict__ w,
                               float* __restrict__ o1, float* __restrict__ o2,
                               float* __restrict__ o3, int side, int b1,
                               int b2, int b3, float dt0, int cmax) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= side || j >= side) return;
  const int n = side - 2;
  const int ck = fsc::clampi(k, 1, n);
  const int ci = fsc::clampi(i, 1, n);
  const int cj = fsc::clampi(j, 1, n);
  const fsc::Departure3 d =
      kWindowed
          ? fsc::window_backtrace3(u, v, w, ck, ci, cj, side, dt0, cmax)
          : fsc::backtrace3(u, v, w, ck, ci, cj, side, dt0);
  const int o = (k * side + i) * side + j;
  o1[o] = fsc::border_value3(fsc::trilinear(d, d1, side), k, i, j, side, b1);
  if (d2 != nullptr)
    o2[o] = fsc::border_value3(fsc::trilinear(d, d2, side), k, i, j, side, b2);
  if (d3 != nullptr)
    o3[o] = fsc::border_value3(fsc::trilinear(d, d3, side), k, i, j, side, b3);
}

}  // namespace

// d2/o2 and d3/o3 null advect fewer fields (d3 needs d2).  dt0 = dt*n in
// float32; cmax <= 0 gathers exactly, cmax >= 1 in the window of cmax
// cells.  Returns cudaGetLastError() after the launch.
extern "C" int fsc_advect3(const float* d1, const float* d2, const float* d3,
                           const float* u, const float* v, const float* w,
                           float* o1, float* o2, float* o3, int side, int b1,
                           int b2, int b3, float dt0, int cmax,
                           void* stream) {
  const auto kernel =
      cmax > 0 ? advect3_kernel<true> : advect3_kernel<false>;
  kernel<<<fsc::grid_dim3(side), fsc::block_dim(), 0,
           static_cast<cudaStream_t>(stream)>>>(
      d1, d2, d3, u, v, w, o1, o2, o3, side, b1, b2, b3, dt0, cmax);
  return static_cast<int>(cudaGetLastError());
}
