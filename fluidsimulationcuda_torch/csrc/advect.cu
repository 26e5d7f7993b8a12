// K3 advect: semi-Lagrangian backtrace and bilinear gather of one or two
// fields that share the backtrace.
//
// Replaces the TPU kernel _advect_kernel
// (fluidsimulationcuda_tpu/kernels/pallas_ops.py:935, pallas_call at :1182;
// wrappers advect_shift :1085 and advect_shift_fused :1100).  The TPU has no
// fast dynamic gather, so it decomposed the gather into (2C+1)^2 masked
// shifts over a VMEM window and was exact only while the displacement stayed
// below C cells.  Hopper gathers through L1/L2 directly, so this kernel reads
// the four points of each departure point directly.  With cmax <= 0 it is
// the exact gather of ops/advect.py at any displacement; with cmax > 0 the
// departure point is also clamped to cmax cells around its cell
// (fsc_common.cuh: departure, the clamp K12 shares), which is the TPU
// kernel's semantics (ops/advect.py advect_windowed): equal to the exact
// gather while the displacement stays at or below cmax, clamped above it.
//
// Bound: device memory.  A cell reads u, v and four gather points per field
// (mostly neighbours of each other for a smooth flow, so L1/L2 hits) and
// writes one value per field: about 16 bytes a cell for the u/v pair.
// Outputs are fresh tensors: both self-advections read the pre-advection
// velocity (stable_fluids_2d.py:106-107).  A launch takes a batch of grids,
// one per grid layer; each gathers from its own grid.
//
// The bf16 form (the TPU kernel's bf16 storage mode, fluids and outputs in
// bf16; pallas_ops.py:956-968) is the template instantiation at bf16: the
// departure coordinates and the blend stay float32 (a grid index past 256
// has no exact bf16 value), only the loads and stores are bf16.  About 8
// bytes a cell for the pair.
#include "fsc_common.cuh"

namespace {

template <typename T = float>
__global__ void advect_kernel(const T* __restrict__ d1,
                              const T* __restrict__ d2,
                              const T* __restrict__ u,
                              const T* __restrict__ v,
                              T* __restrict__ o1, T* __restrict__ o2,
                              int side, int b1, int b2, float dt0, int cmax) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= side || j >= side) return;
  const int n = side - 2;
  const int off = fsc::grid_offset(side);
  const fsc::Departure d =
      fsc::departure(u + off, v + off, fsc::clampi(i, 1, n),
                     fsc::clampi(j, 1, n), side, dt0, cmax);
  const int g = off + d.i0 * side + d.j0;
  const float a = fsc::blend(d, fsc::load(d1, g), fsc::load(d1, g + side),
                             fsc::load(d1, g + 1),
                             fsc::load(d1, g + side + 1));
  fsc::store(o1, off + i * side + j, fsc::border_value(a, i, j, side, b1));
  if (d2 != nullptr) {
    const float e = fsc::blend(d, fsc::load(d2, g), fsc::load(d2, g + side),
                               fsc::load(d2, g + 1),
                               fsc::load(d2, g + side + 1));
    fsc::store(o2, off + i * side + j, fsc::border_value(e, i, j, side, b2));
  }
}

}  // namespace

// Every pointer holds nb grids of side^2 cells; d2/o2 null advects one
// field.  dt0 = dt*n in float32; cmax <= 0 gathers exactly.  Returns
// cudaGetLastError() after the launch.
extern "C" int fsc_advect(const float* d1, const float* d2, const float* u,
                          const float* v, float* o1, float* o2, int side,
                          int nb, int b1, int b2, float dt0, int cmax,
                          void* stream) {
  const auto kernel = advect_kernel<>;
  kernel<<<fsc::grid_dim(side, nb), fsc::block_dim(), 0,
           static_cast<cudaStream_t>(stream)>>>(d1, d2, u, v, o1, o2, side, b1,
                                                b2, dt0, cmax);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form: every pointer holds bf16, as fsc_advect's float32.
// Returns cudaGetLastError() after the launch.
extern "C" int fsc_advect_bf16(const void* d1, const void* d2, const void* u,
                               const void* v, void* o1, void* o2, int side,
                               int nb, int b1, int b2, float dt0, int cmax,
                               void* stream) {
  using fsc::bf16;
  const auto kernel = advect_kernel<bf16>;
  kernel<<<fsc::grid_dim(side, nb), fsc::block_dim(), 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(d1), static_cast<const bf16*>(d2),
      static_cast<const bf16*>(u), static_cast<const bf16*>(v),
      static_cast<bf16*>(o1), static_cast<bf16*>(o2), side, b1, b2, dt0, cmax);
  return static_cast<int>(cudaGetLastError());
}
