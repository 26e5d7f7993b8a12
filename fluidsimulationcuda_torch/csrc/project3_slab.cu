// K15 divergence3_slab and K16 gradient3_slab: the two stencils around the
// pressure solve of the 3-D multi-device step, on a z-slab whose planes
// beyond its edges come as halo planes.
//
// The TPU step computes these in jnp, not Pallas (_divergence3_fast and
// _gradient3_fast, fluidsimulationcuda_tpu/parallel/sharded3d.py:567-597,
// with the ghost layer from _apply_bnd3_direct :516); they are K7 and K8
// (project3.cu) on an (mz, side, side) slab, written as kernels as the
// port's other stencils are.  A halo is a pointer to the one plane the
// stencil needs (the last plane above the slab, the first below it), w for
// the divergence and p for the gradient.  Both derive the full ghost layer
// in the same launch, wall planes from gtop/gbot (fsc_common.cuh):
// divergence with b=0, gradient with b=1 for u, b=2 for v and b=3 for w.
//
// The divergence computes (-0.5*h)*((du + dv) + dw) with h = 1/n; the
// gradient u - (0.5*dp)/h, a division by h (sharded3d.py:567-597).
//
// Bound: device memory, as K7 and K8: 16 bytes a cell for the divergence,
// 28 for the gradient.
#include "fsc_common.cuh"

namespace {

__global__ void divergence3_slab_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ wtop,
    const float* __restrict__ wbot, float* __restrict__ out, int planes,
    int side, int gtop, int gbot, float coef) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= side || j >= side) return;
  const int n = side - 2;
  const int plane = side * side;
  const int ki = fsc::slab_row_of(k, gtop, gbot);
  const int cp = fsc::clampi(i, 1, n) * side + fsc::clampi(j, 1, n);
  const int c = ki * plane + cp;
  const float w_up = fsc::slab_row(w, wtop, wbot, ki - 1, planes, plane)[cp];
  const float w_dn = fsc::slab_row(w, wtop, wbot, ki + 1, planes, plane)[cp];
  const float d = coef * (((u[c + 1] - u[c - 1]) + (v[c + side] - v[c - side])) +
                          (w_dn - w_up));
  out[(k * side + i) * side + j] =
      fsc::slab_border_value3(d, k, i, j, side, gtop, gbot, 0);
}

__global__ void gradient3_slab_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ p,
    const float* __restrict__ ptop, const float* __restrict__ pbot,
    float* __restrict__ uo, float* __restrict__ vo, float* __restrict__ wo,
    int planes, int side, int gtop, int gbot, float h) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= side || j >= side) return;
  const int n = side - 2;
  const int plane = side * side;
  const int ki = fsc::slab_row_of(k, gtop, gbot);
  const int cp = fsc::clampi(i, 1, n) * side + fsc::clampi(j, 1, n);
  const int c = ki * plane + cp;
  const float p_up = fsc::slab_row(p, ptop, pbot, ki - 1, planes, plane)[cp];
  const float p_dn = fsc::slab_row(p, ptop, pbot, ki + 1, planes, plane)[cp];
  const float un = u[c] - (0.5f * (p[c + 1] - p[c - 1])) / h;
  const float vn = v[c] - (0.5f * (p[c + side] - p[c - side])) / h;
  const float wn = w[c] - (0.5f * (p_dn - p_up)) / h;
  const int o = (k * side + i) * side + j;
  uo[o] = fsc::slab_border_value3(un, k, i, j, side, gtop, gbot, 1);
  vo[o] = fsc::slab_border_value3(vn, k, i, j, side, gtop, gbot, 2);
  wo[o] = fsc::slab_border_value3(wn, k, i, j, side, gtop, gbot, 3);
}

}  // namespace

// u, v, w, out: (planes, side, side); wtop/wbot: the planes above and below
// w.  coef = -0.5*h in float32.  Returns cudaGetLastError() after the
// launch.
extern "C" int fsc_divergence3_slab(const float* u, const float* v,
                                    const float* w, const float* wtop,
                                    const float* wbot, float* out, int planes,
                                    int side, int gtop, int gbot, float coef,
                                    void* stream) {
  divergence3_slab_kernel<<<fsc::slab_grid_dim3(side, planes),
                            fsc::block_dim(), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      u, v, w, wtop, wbot, out, planes, side, gtop, gbot, coef);
  return static_cast<int>(cudaGetLastError());
}

// u, v, w, p, uo, vo, wo: (planes, side, side); ptop/pbot: the planes above
// and below p.  h = 1/n in float32.  Returns cudaGetLastError() after the
// launch.
extern "C" int fsc_gradient3_slab(const float* u, const float* v,
                                  const float* w, const float* p,
                                  const float* ptop, const float* pbot,
                                  float* uo, float* vo, float* wo, int planes,
                                  int side, int gtop, int gbot, float h,
                                  void* stream) {
  gradient3_slab_kernel<<<fsc::slab_grid_dim3(side, planes), fsc::block_dim(),
                          0, static_cast<cudaStream_t>(stream)>>>(
      u, v, w, p, ptop, pbot, uo, vo, wo, planes, side, gtop, gbot, h);
  return static_cast<int>(cudaGetLastError());
}
