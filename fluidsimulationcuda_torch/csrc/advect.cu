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
// bf16; pallas_ops.py:956-968) reads and writes bf16; the departure
// coordinates and the blend stay float32 (a grid index past 256 has no
// exact bf16 value).  About 8 bytes a cell for the pair.  Its one-cell
// kernel, advect_kernel<bf16>, issues as many loads and stores a cell as
// the float32 form, each of 2 bytes, so it kept about the float32 cell
// rate on half the bytes (0.02802 ms against 0.03121 for the 2048² pair,
// PERF.md).  So the bf16 form runs advect_vec_kernel<V>: a thread owns V
// consecutive cells of a row, loads u and v with one 2V-byte load each and
// writes each output field with one such store; a gather reads the two
// corners of a row with one 4-byte load where the first is even, two
// 2-byte loads where it is odd.  The departure of each cell is
// fsc::departure_at's float32 expressions in the reference's order, so the
// result is the one-cell kernel's bit for bit.  A ghost cell takes its
// interior neighbour's departure and gather, which lies in the same vector
// (column 0 in the first vector of its row, column side-1 in the last);
// ghost rows evaluate rows 1 and n.  V is a template argument, chosen at
// launch by the wrapper (cuda_ops.vector_width): the first width of
// cuda_ops.VECTOR_WIDTHS that divides side with every pointer aligned to
// its access, else V = 1, the one-cell kernel.
//
// Measured on the H100 (PERF.md §6, dev/bench_bf16_stencils.py), V = 4
// took 18-22% less time than V = 8 on the step's velocities at 2048²,
// 8192² and on the datagen batch (0.02223 against 0.02787 ms for the
// 2048² pair) and was within 5.3% of it on smooth and shear ones, where
// V = 8 was mostly the faster.  The path takes V = 4, and V = 8 is not
// built.  Why V = 4 wins on the step's velocities is not verified (no
// profiler ran); one guess is the L1 traffic of a warp's gathers, which
// span V times the one-cell kernel's columns.  Staging a block's footprint
// box in shared memory (as K4 does) was slower than the direct gathers on
// every flow but random ones over the window, and was not kept.
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

// The four gather corners of departure d at flat index g of field f (a
// grid of rows of `stride` cells, 4-byte aligned), blended.
__device__ __forceinline__ float gather(const fsc::bf16* __restrict__ f,
                                        const fsc::Departure& d, int g,
                                        int stride) {
  float g00, g01, g10, g11;
  fsc::load_pair(f, g, g00, g01);
  fsc::load_pair(f, g + stride, g10, g11);
  return fsc::blend(d, g00, g10, g01, g11);
}

template <int V>
__global__ void __launch_bounds__(fsc::kBlockX * fsc::kBlockY)
    advect_vec_kernel(const fsc::bf16* __restrict__ d1,
                      const fsc::bf16* __restrict__ d2,
                      const fsc::bf16* __restrict__ u,
                      const fsc::bf16* __restrict__ v,
                      fsc::bf16* __restrict__ o1, fsc::bf16* __restrict__ o2,
                      int side, int b1, int b2, float dt0, int cmax) {
  const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= side || j0 >= side) return;
  const int n = side - 2;
  const int off = fsc::grid_offset(side);
  const int ci = fsc::clampi(i, 1, n);
  float uc[V], vc[V];
  fsc::load_vec<V>(u, off + ci * side + j0, uc);
  fsc::load_vec<V>(v, off + ci * side + j0, vc);
  float a[V], e[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int s = fsc::ghost_shift<V>(k, j0, side);
    const fsc::Departure d =
        fsc::departure_at(fsc::shifted(uc, k, s), fsc::shifted(vc, k, s), ci,
                          j0 + k + s, side, dt0, cmax);
    const int g = off + d.i0 * side + d.j0;
    a[k] = fsc::border_value(gather(d1, d, g, side), i, j0 + k, side, b1);
    if (d2 != nullptr)
      e[k] = fsc::border_value(gather(d2, d, g, side), i, j0 + k, side, b2);
  }
  fsc::store_vec<V>(o1, off + i * side + j0, a);
  if (d2 != nullptr) fsc::store_vec<V>(o2, off + i * side + j0, e);
}

using AdvectVec = void (*)(const fsc::bf16*, const fsc::bf16*,
                           const fsc::bf16*, const fsc::bf16*, fsc::bf16*,
                           fsc::bf16*, int, int, int, float, int);

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

// The bf16 form: every pointer holds bf16, as fsc_advect's float32.  width
// is V, the cells a thread: 1 runs the one-cell kernel, 2 or 4
// advect_vec_kernel<V>, which takes side a multiple of V and every pointer
// aligned to 2V bytes; anything else is refused with
// cudaErrorInvalidValue.  Returns cudaGetLastError() after the launch.
extern "C" int fsc_advect_bf16(const void* d1, const void* d2, const void* u,
                               const void* v, void* o1, void* o2, int side,
                               int nb, int b1, int b2, float dt0, int cmax,
                               int width, void* stream) {
  using fsc::bf16;
  const auto* d1b = static_cast<const bf16*>(d1);
  const auto* d2b = static_cast<const bf16*>(d2);
  const auto* ub = static_cast<const bf16*>(u);
  const auto* vb = static_cast<const bf16*>(v);
  auto* o1b = static_cast<bf16*>(o1);
  auto* o2b = static_cast<bf16*>(o2);
  const auto st = static_cast<cudaStream_t>(stream);
  if (width == 1) {
    const auto kernel = advect_kernel<bf16>;
    kernel<<<fsc::grid_dim(side, nb), fsc::block_dim(), 0, st>>>(
        d1b, d2b, ub, vb, o1b, o2b, side, b1, b2, dt0, cmax);
    return static_cast<int>(cudaGetLastError());
  }
  const AdvectVec kernel = width == 4   ? advect_vec_kernel<4>
                           : width == 2 ? advect_vec_kernel<2>
                                        : nullptr;
  if (kernel == nullptr || side % width != 0 ||
      !fsc::aligned(2 * width, d1, d2, u, v, o1, o2))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((side / width + fsc::kBlockX - 1) / fsc::kBlockX,
                  (side + fsc::kBlockY - 1) / fsc::kBlockY, nb);
  kernel<<<grid, fsc::block_dim(), 0, st>>>(d1b, d2b, ub, vb, o1b, o2b, side,
                                            b1, b2, dt0, cmax);
  return static_cast<int>(cudaGetLastError());
}
