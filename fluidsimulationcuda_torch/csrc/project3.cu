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
#include "fsc_common.cuh"

namespace {

__global__ void divergence3_kernel(const float* __restrict__ u,
                                   const float* __restrict__ v,
                                   const float* __restrict__ w,
                                   float* __restrict__ out, int side,
                                   float coef) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= side || j >= side) return;
  const int c = fsc::interior_of3(k, i, j, side);
  const int plane = side * side;
  const float d = coef * (((u[c + 1] - u[c - 1]) + (v[c + side] - v[c - side])) +
                          (w[c + plane] - w[c - plane]));
  out[(k * side + i) * side + j] = fsc::border_value3(d, k, i, j, side, 0);
}

__global__ void gradient3_kernel(const float* __restrict__ u,
                                 const float* __restrict__ v,
                                 const float* __restrict__ w,
                                 const float* __restrict__ p,
                                 float* __restrict__ uo,
                                 float* __restrict__ vo,
                                 float* __restrict__ wo, int side, float h) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= side || j >= side) return;
  const int c = fsc::interior_of3(k, i, j, side);
  const int plane = side * side;
  const int o = (k * side + i) * side + j;
  const float un = u[c] - (0.5f * (p[c + 1] - p[c - 1])) / h;
  const float vn = v[c] - (0.5f * (p[c + side] - p[c - side])) / h;
  const float wn = w[c] - (0.5f * (p[c + plane] - p[c - plane])) / h;
  uo[o] = fsc::border_value3(un, k, i, j, side, 1);
  vo[o] = fsc::border_value3(vn, k, i, j, side, 2);
  wo[o] = fsc::border_value3(wn, k, i, j, side, 3);
}

}  // namespace

// coef = -0.5*h in float32.  Returns cudaGetLastError() after the launch.
extern "C" int fsc_divergence3(const float* u, const float* v, const float* w,
                               float* out, int side, float coef,
                               void* stream) {
  divergence3_kernel<<<fsc::grid_dim3(side), fsc::block_dim(), 0,
                       static_cast<cudaStream_t>(stream)>>>(u, v, w, out, side,
                                                            coef);
  return static_cast<int>(cudaGetLastError());
}

// h = 1/n in float32.  Returns cudaGetLastError() after the launch.
extern "C" int fsc_gradient3(const float* u, const float* v, const float* w,
                             const float* p, float* uo, float* vo, float* wo,
                             int side, float h, void* stream) {
  gradient3_kernel<<<fsc::grid_dim3(side), fsc::block_dim(), 0,
                     static_cast<cudaStream_t>(stream)>>>(u, v, w, p, uo, vo,
                                                          wo, side, h);
  return static_cast<int>(cudaGetLastError());
}
