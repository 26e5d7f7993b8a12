// K7 divergence3 and K8 gradient3: the two stencils around the 3-D
// pressure solve.
//
// Replace the TPU kernels divergence3_p (pallas_call at
// fluidsimulationcuda_tpu/kernels/pallas_ops_3d.py:1085) and gradient3_p
// (:1101), which tile z-plane strips with one-plane halos taken from the
// neighbouring strips; the pressure sweeps between them are K5
// (jacobi3.cu) with alpha=1, beta=6 from a zero guess.  Here one thread
// reads its six neighbours straight from device memory.
//
// Bound: device memory, 16 bytes a cell for the divergence (u, v, w in; div
// out) and 28 for the gradient (u, v, w, p in; u, v, w out): 80 and 140 us
// at 256^3 on 3.35 TB/s.  Each derives its ghost layer in the same launch
// (fsc_common.cuh border_value3): divergence with b=0, the gradient with
// b=1 for u, b=2 for v and b=3 for w.
//
// Their bf16 forms are the projection of the bf16 3-D step, which keeps a
// float32 divergence and pressure (the 2-D bf16 projection's rule, K2's
// <bf16, float> forms): fsc_divergence3_bf16 reads bf16 u, v, w and writes
// float32; fsc_gradient3_bf16 reads bf16 u, v, w and a float32 p and
// writes bf16, rounded once at the store.
#include "fsc_common.cuh"

namespace {

template <typename TI, typename TO>
__global__ void divergence3_kernel(const TI* __restrict__ u,
                                   const TI* __restrict__ v,
                                   const TI* __restrict__ w,
                                   TO* __restrict__ out, int side,
                                   float coef) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= side || j >= side) return;
  const int c = fsc::interior_of3(k, i, j, side);
  const int plane = side * side;
  const float d =
      coef * (((fsc::load(u, c + 1) - fsc::load(u, c - 1)) +
               (fsc::load(v, c + side) - fsc::load(v, c - side))) +
              (fsc::load(w, c + plane) - fsc::load(w, c - plane)));
  fsc::store(out, (k * side + i) * side + j,
             fsc::border_value3(d, k, i, j, side, 0));
}

template <typename TU>
__global__ void gradient3_kernel(const TU* __restrict__ u,
                                 const TU* __restrict__ v,
                                 const TU* __restrict__ w,
                                 const float* __restrict__ p,
                                 TU* __restrict__ uo, TU* __restrict__ vo,
                                 TU* __restrict__ wo, int side, float h) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= side || j >= side) return;
  const int c = fsc::interior_of3(k, i, j, side);
  const int plane = side * side;
  const int o = (k * side + i) * side + j;
  const float un = fsc::load(u, c) - (0.5f * (p[c + 1] - p[c - 1])) / h;
  const float vn =
      fsc::load(v, c) - (0.5f * (p[c + side] - p[c - side])) / h;
  const float wn =
      fsc::load(w, c) - (0.5f * (p[c + plane] - p[c - plane])) / h;
  fsc::store(uo, o, fsc::border_value3(un, k, i, j, side, 1));
  fsc::store(vo, o, fsc::border_value3(vn, k, i, j, side, 2));
  fsc::store(wo, o, fsc::border_value3(wn, k, i, j, side, 3));
}

}  // namespace

// coef = -0.5*h in float32.  Returns cudaGetLastError() after the launch.
extern "C" int fsc_divergence3(const float* u, const float* v, const float* w,
                               float* out, int side, float coef,
                               void* stream) {
  const auto kernel = divergence3_kernel<float, float>;
  kernel<<<fsc::grid_dim3(side), fsc::block_dim(), 0,
           static_cast<cudaStream_t>(stream)>>>(u, v, w, out, side, coef);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form: bf16 u, v, w; a float32 divergence.
extern "C" int fsc_divergence3_bf16(const void* u, const void* v,
                                    const void* w, float* out, int side,
                                    float coef, void* stream) {
  const auto kernel = divergence3_kernel<fsc::bf16, float>;
  kernel<<<fsc::grid_dim3(side), fsc::block_dim(), 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const fsc::bf16*>(u), static_cast<const fsc::bf16*>(v),
      static_cast<const fsc::bf16*>(w), out, side, coef);
  return static_cast<int>(cudaGetLastError());
}

// h = 1/n in float32.  Returns cudaGetLastError() after the launch.
extern "C" int fsc_gradient3(const float* u, const float* v, const float* w,
                             const float* p, float* uo, float* vo, float* wo,
                             int side, float h, void* stream) {
  const auto kernel = gradient3_kernel<float>;
  kernel<<<fsc::grid_dim3(side), fsc::block_dim(), 0,
           static_cast<cudaStream_t>(stream)>>>(u, v, w, p, uo, vo, wo, side,
                                                h);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form: bf16 u, v, w and outputs, a float32 p.
extern "C" int fsc_gradient3_bf16(const void* u, const void* v,
                                  const void* w, const float* p, void* uo,
                                  void* vo, void* wo, int side, float h,
                                  void* stream) {
  const auto kernel = gradient3_kernel<fsc::bf16>;
  kernel<<<fsc::grid_dim3(side), fsc::block_dim(), 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const fsc::bf16*>(u), static_cast<const fsc::bf16*>(v),
      static_cast<const fsc::bf16*>(w), p, static_cast<fsc::bf16*>(uo),
      static_cast<fsc::bf16*>(vo), static_cast<fsc::bf16*>(wo), side, h);
  return static_cast<int>(cudaGetLastError());
}
