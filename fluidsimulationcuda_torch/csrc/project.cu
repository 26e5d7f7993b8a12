// K2 divergence and gradient: the two stencils around the pressure solve.
//
// Replace the first and last stages of the TPU kernel _project_kernel
// (fluidsimulationcuda_tpu/kernels/pallas_ops.py:724, pallas_call at :899),
// whose middle stage is K1 jacobi_sweep with alpha=1, beta=4 from a zero
// guess, and its unfused forms divergence_p (:1613, pallas_call :1622) and
// gradient_p (:1635, pallas_call :1645).  The TPU fused the three stages to
// keep div and p in VMEM across a strip; here each stage is a launch and
// div and p go through device memory, which the L2 mostly holds at 2048^2.
// Each launch takes a batch of grids, one per grid layer, as the TPU
// kernels' batch program axis does.
//
// Bound: device memory, 12 bytes a cell for the divergence (u, v in; div
// out) and 20 for the gradient (u, v, p in; u, v out).  Each derives its
// border in the same launch (fsc_common.cuh): divergence with b=0, the
// gradient with b=1 for u and b=2 for v.
#include "fsc_common.cuh"

namespace {

__global__ void divergence_kernel(const float* __restrict__ u,
                                  const float* __restrict__ v,
                                  float* __restrict__ out, int side,
                                  float coef) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= side || j >= side) return;
  const int off = fsc::grid_offset(side);
  const int c = off + fsc::interior_of(i, j, side);
  const float d = coef * ((u[c + 1] - u[c - 1]) + (v[c + side] - v[c - side]));
  out[off + i * side + j] = fsc::border_value(d, i, j, side, 0);
}

__global__ void gradient_kernel(const float* __restrict__ u,
                                const float* __restrict__ v,
                                const float* __restrict__ p,
                                float* __restrict__ uo, float* __restrict__ vo,
                                int side, float h) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= side || j >= side) return;
  const int off = fsc::grid_offset(side);
  const int c = off + fsc::interior_of(i, j, side);
  const float un = u[c] - (0.5f * (p[c + 1] - p[c - 1])) / h;
  const float vn = v[c] - (0.5f * (p[c + side] - p[c - side])) / h;
  uo[off + i * side + j] = fsc::border_value(un, i, j, side, 1);
  vo[off + i * side + j] = fsc::border_value(vn, i, j, side, 2);
}

}  // namespace

// Every pointer holds nb grids of side^2 cells; coef = -0.5*h in float32.
// Returns cudaGetLastError() after the launch.
extern "C" int fsc_divergence(const float* u, const float* v, float* out,
                              int side, int nb, float coef, void* stream) {
  divergence_kernel<<<fsc::grid_dim(side, nb), fsc::block_dim(), 0,
                      static_cast<cudaStream_t>(stream)>>>(u, v, out, side,
                                                           coef);
  return static_cast<int>(cudaGetLastError());
}

// Every pointer holds nb grids of side^2 cells; h = 1/n in float32.
// Returns cudaGetLastError() after the launch.
extern "C" int fsc_gradient(const float* u, const float* v, const float* p,
                            float* uo, float* vo, int side, int nb, float h,
                            void* stream) {
  gradient_kernel<<<fsc::grid_dim(side, nb), fsc::block_dim(), 0,
                    static_cast<cudaStream_t>(stream)>>>(u, v, p, uo, vo, side,
                                                         h);
  return static_cast<int>(cudaGetLastError());
}
