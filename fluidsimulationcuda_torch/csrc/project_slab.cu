// K10 divergence_slab and K11 gradient_slab: the two stencils around the
// pressure solve, on a row slab whose rows beyond its edges come as halo
// rows.
//
// Replace the TPU kernels _divergence_slab_kernel and _gradient_slab_kernel
// (fluidsimulationcuda_tpu/kernels/pallas_sharded.py:1315 and :1330,
// pallas_calls at :1357 and :1378), the composed projection of the
// multi-device step, and the first and last stages of the slab projection
// _project_slab_kernel (:570, pallas_call at :700), whose middle stage is K9
// with alpha=1, beta=4 from a zero guess.  The TPU kernels read the halo
// rows from (8, side) blocks received from the neighbours; here a halo is a
// pointer to the one row the stencil needs (the last row above the slab,
// the first below it), so the slab projection runs them on its extended
// buffer with no copy: the divergence over the buffer's inner rows, the
// gradient over its m slab rows.
//
// The divergence takes h = 1/n and computes (-0.5*h)*(du + (v_dn - v_up));
// the gradient computes u - (0.5*dp)/h, a division by h (:1315-1346).
// Both derive the ghost columns and the wall ghost rows (gtop, gbot) in the
// same launch (fsc_common.cuh): divergence with b=0, gradient with b=1 for
// u and b=2 for v.
//
// Bound: device memory, as K2: 12 bytes a cell for the divergence, 20 for
// the gradient.
#include "fsc_common.cuh"

namespace {

__global__ void divergence_slab_kernel(const float* __restrict__ u,
                                       const float* __restrict__ v,
                                       const float* __restrict__ vtop,
                                       const float* __restrict__ vbot,
                                       float* __restrict__ out, int rows,
                                       int side, int gtop, int gbot,
                                       float coef) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= rows || j >= side) return;
  const int ri = fsc::slab_row_of(r, gtop, gbot);
  const int cj = fsc::clampi(j, 1, side - 2);
  const float* ur = u + ri * side;
  const float v_up = fsc::slab_row(v, vtop, vbot, ri - 1, rows, side)[cj];
  const float v_dn = fsc::slab_row(v, vtop, vbot, ri + 1, rows, side)[cj];
  const float d = coef * ((ur[cj + 1] - ur[cj - 1]) + (v_dn - v_up));
  out[r * side + j] = fsc::slab_border_value(d, r, j, side, gtop, gbot, 0);
}

__global__ void gradient_slab_kernel(const float* __restrict__ u,
                                     const float* __restrict__ v,
                                     const float* __restrict__ p,
                                     const float* __restrict__ ptop,
                                     const float* __restrict__ pbot,
                                     float* __restrict__ uo,
                                     float* __restrict__ vo, int rows,
                                     int side, int gtop, int gbot, float h) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= rows || j >= side) return;
  const int ri = fsc::slab_row_of(r, gtop, gbot);
  const int cj = fsc::clampi(j, 1, side - 2);
  const int c = ri * side + cj;
  const float p_up = fsc::slab_row(p, ptop, pbot, ri - 1, rows, side)[cj];
  const float p_dn = fsc::slab_row(p, ptop, pbot, ri + 1, rows, side)[cj];
  const float un = u[c] - (0.5f * (p[c + 1] - p[c - 1])) / h;
  const float vn = v[c] - (0.5f * (p_dn - p_up)) / h;
  uo[r * side + j] = fsc::slab_border_value(un, r, j, side, gtop, gbot, 1);
  vo[r * side + j] = fsc::slab_border_value(vn, r, j, side, gtop, gbot, 2);
}

}  // namespace

// u, v, out: (rows, side); vtop/vbot: the rows above and below v.
// coef = -0.5*h in float32.  Returns cudaGetLastError() after the launch.
extern "C" int fsc_divergence_slab(const float* u, const float* v,
                                   const float* vtop, const float* vbot,
                                   float* out, int rows, int side, int gtop,
                                   int gbot, float coef, void* stream) {
  divergence_slab_kernel<<<fsc::slab_grid_dim(side, rows), fsc::block_dim(),
                           0, static_cast<cudaStream_t>(stream)>>>(
      u, v, vtop, vbot, out, rows, side, gtop, gbot, coef);
  return static_cast<int>(cudaGetLastError());
}

// u, v, p, uo, vo: (rows, side); ptop/pbot: the rows above and below p.
// h = 1/n in float32.  Returns cudaGetLastError() after the launch.
extern "C" int fsc_gradient_slab(const float* u, const float* v,
                                 const float* p, const float* ptop,
                                 const float* pbot, float* uo, float* vo,
                                 int rows, int side, int gtop, int gbot,
                                 float h, void* stream) {
  gradient_slab_kernel<<<fsc::slab_grid_dim(side, rows), fsc::block_dim(), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      u, v, p, ptop, pbot, uo, vo, rows, side, gtop, gbot, h);
  return static_cast<int>(cudaGetLastError());
}
