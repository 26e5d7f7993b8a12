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
//
// Their bf16 forms are the projection of the bf16 z-slab step, which keeps
// a float32 divergence and pressure (K7's and K8's bf16 rule, project3.cu):
// fsc_divergence3_slab_bf16 reads bf16 u, v, w and bf16 w halo planes and
// writes float32; fsc_gradient3_slab_bf16 reads bf16 u, v, w, a float32 p
// and float32 p halo planes and writes bf16, rounded once at the store.
#include "fsc_common.cuh"

namespace {

template <typename TI>
__global__ void divergence3_slab_kernel(
    const TI* __restrict__ u, const TI* __restrict__ v,
    const TI* __restrict__ w, const TI* __restrict__ wtop,
    const TI* __restrict__ wbot, float* __restrict__ out, int planes,
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
  const float w_up =
      fsc::load(fsc::slab_row(w, wtop, wbot, ki - 1, planes, plane), cp);
  const float w_dn =
      fsc::load(fsc::slab_row(w, wtop, wbot, ki + 1, planes, plane), cp);
  const float d =
      coef * (((fsc::load(u, c + 1) - fsc::load(u, c - 1)) +
               (fsc::load(v, c + side) - fsc::load(v, c - side))) +
              (w_dn - w_up));
  out[(k * side + i) * side + j] =
      fsc::slab_border_value3(d, k, i, j, side, gtop, gbot, 0);
}

template <typename TU>
__global__ void gradient3_slab_kernel(
    const TU* __restrict__ u, const TU* __restrict__ v,
    const TU* __restrict__ w, const float* __restrict__ p,
    const float* __restrict__ ptop, const float* __restrict__ pbot,
    TU* __restrict__ uo, TU* __restrict__ vo, TU* __restrict__ wo, int planes,
    int side, int gtop, int gbot, float h) {
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
  const float un = fsc::load(u, c) - (0.5f * (p[c + 1] - p[c - 1])) / h;
  const float vn =
      fsc::load(v, c) - (0.5f * (p[c + side] - p[c - side])) / h;
  const float wn = fsc::load(w, c) - (0.5f * (p_dn - p_up)) / h;
  const int o = (k * side + i) * side + j;
  fsc::store(uo, o, fsc::slab_border_value3(un, k, i, j, side, gtop, gbot, 1));
  fsc::store(vo, o, fsc::slab_border_value3(vn, k, i, j, side, gtop, gbot, 2));
  fsc::store(wo, o, fsc::slab_border_value3(wn, k, i, j, side, gtop, gbot, 3));
}

template <typename TI>
int launch_divergence(const void* u, const void* v, const void* w,
                      const void* wtop, const void* wbot, float* out,
                      int planes, int side, int gtop, int gbot, float coef,
                      void* stream) {
  const auto kernel = divergence3_slab_kernel<TI>;
  kernel<<<fsc::slab_grid_dim3(side, planes), fsc::block_dim(), 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TI*>(u), static_cast<const TI*>(v),
      static_cast<const TI*>(w), static_cast<const TI*>(wtop),
      static_cast<const TI*>(wbot), out, planes, side, gtop, gbot, coef);
  return static_cast<int>(cudaGetLastError());
}

template <typename TU>
int launch_gradient(const void* u, const void* v, const void* w,
                    const float* p, const float* ptop, const float* pbot,
                    void* uo, void* vo, void* wo, int planes, int side,
                    int gtop, int gbot, float h, void* stream) {
  const auto kernel = gradient3_slab_kernel<TU>;
  kernel<<<fsc::slab_grid_dim3(side, planes), fsc::block_dim(), 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TU*>(u), static_cast<const TU*>(v),
      static_cast<const TU*>(w), p, ptop, pbot, static_cast<TU*>(uo),
      static_cast<TU*>(vo), static_cast<TU*>(wo), planes, side, gtop, gbot,
      h);
  return static_cast<int>(cudaGetLastError());
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
  return launch_divergence<float>(u, v, w, wtop, wbot, out, planes, side,
                                  gtop, gbot, coef, stream);
}

// The bf16 form: bf16 u, v, w and w halo planes; a float32 divergence.
extern "C" int fsc_divergence3_slab_bf16(const void* u, const void* v,
                                         const void* w, const void* wtop,
                                         const void* wbot, float* out,
                                         int planes, int side, int gtop,
                                         int gbot, float coef, void* stream) {
  return launch_divergence<fsc::bf16>(u, v, w, wtop, wbot, out, planes, side,
                                      gtop, gbot, coef, stream);
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
  return launch_gradient<float>(u, v, w, p, ptop, pbot, uo, vo, wo, planes,
                                side, gtop, gbot, h, stream);
}

// The bf16 form: bf16 u, v, w and outputs; a float32 p and p halo planes.
extern "C" int fsc_gradient3_slab_bf16(const void* u, const void* v,
                                       const void* w, const float* p,
                                       const float* ptop, const float* pbot,
                                       void* uo, void* vo, void* wo,
                                       int planes, int side, int gtop,
                                       int gbot, float h, void* stream) {
  return launch_gradient<fsc::bf16>(u, v, w, p, ptop, pbot, uo, vo, wo,
                                    planes, side, gtop, gbot, h, stream);
}
