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
//
// The bf16 forms (the TPU kernels' bf16 storage mode) read bf16 u and v and
// compute in float32: the divergence writes float32 (fused_project's
// stage, pallas_ops.py:791-797) or bf16 (divergence_p, :1622); the
// gradient reads a float32 (fused_project, :828-834) or bf16 (gradient_p,
// :1645) pressure and writes bf16.  Each is a template instantiation over
// those types, chosen at launch: 6 and 8 bytes a cell for the divergence,
// 14 and 12 for the gradient.  The gradient's one-cell kernel issued as
// many loads and stores a cell as the float32 form, each of 2 bytes (45-57%
// of its bound, PERF.md), so the bf16 gradient runs gradient_vec_kernel<V>:
// a thread owns V = 8 (or 4, 2) consecutive cells of a row, loads u, v and
// p's rows above and below with one 2V-byte load each (2V floats of a
// float32 p: two 16-byte loads at V = 8), writes uo and vo with one such
// store each, and takes p's centre row as its own vector plus the values
// left and right of it, two scalar loads that the neighbouring threads'
// vectors have brought into L1 (taking them from the neighbouring lanes by
// warp shuffle measured 2-26% slower on the H100, PERF.md §6, and was not
// kept).  The arithmetic and the border rules are the one-cell kernel's,
// in the same order, so the bits are its bits; a ghost column takes its
// interior neighbour's value, which lies in the same vector.  V is chosen
// at launch as K3's is (advect.cu, cuda_ops.vector_width), else V = 1, the
// one-cell kernel.
#include "fsc_common.cuh"

namespace {

template <typename TI = float, typename TO = float>
__global__ void divergence_kernel(const TI* __restrict__ u,
                                  const TI* __restrict__ v,
                                  TO* __restrict__ out, int side,
                                  float coef) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= side || j >= side) return;
  const int off = fsc::grid_offset(side);
  const int c = off + fsc::interior_of(i, j, side);
  const float d = coef * ((fsc::load(u, c + 1) - fsc::load(u, c - 1)) +
                          (fsc::load(v, c + side) - fsc::load(v, c - side)));
  fsc::store(out, off + i * side + j, fsc::border_value(d, i, j, side, 0));
}

template <typename TU = float, typename TP = float>
__global__ void gradient_kernel(const TU* __restrict__ u,
                                const TU* __restrict__ v,
                                const TP* __restrict__ p,
                                TU* __restrict__ uo, TU* __restrict__ vo,
                                int side, float h) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= side || j >= side) return;
  const int off = fsc::grid_offset(side);
  const int c = off + fsc::interior_of(i, j, side);
  const float un = fsc::load(u, c) -
                   (0.5f * (fsc::load(p, c + 1) - fsc::load(p, c - 1))) / h;
  const float vn =
      fsc::load(v, c) -
      (0.5f * (fsc::load(p, c + side) - fsc::load(p, c - side))) / h;
  fsc::store(uo, off + i * side + j, fsc::border_value(un, i, j, side, 1));
  fsc::store(vo, off + i * side + j, fsc::border_value(vn, i, j, side, 2));
}

template <int V, typename TP>
__global__ void __launch_bounds__(fsc::kBlockX * fsc::kBlockY)
    gradient_vec_kernel(const fsc::bf16* __restrict__ u,
                        const fsc::bf16* __restrict__ v,
                        const TP* __restrict__ p, fsc::bf16* __restrict__ uo,
                        fsc::bf16* __restrict__ vo, int side, float h) {
  const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= side || j0 >= side) return;
  const int n = side - 2;
  const int off = fsc::grid_offset(side);
  // The vector's first cell on its interior row; c - 1 and c + V lie in the
  // grid whatever the column.
  const int c = off + fsc::clampi(i, 1, n) * side + j0;
  float uc[V], vc[V], pu[V], pd[V], mid[V], pc[V + 2];
  fsc::load_vec<V>(u, c, uc);
  fsc::load_vec<V>(v, c, vc);
  fsc::load_vec<V>(p, c - side, pu);
  fsc::load_vec<V>(p, c + side, pd);
  fsc::load_vec<V>(p, c, mid);
  // pc: p at columns j0 - 1 .. j0 + V.
  pc[0] = fsc::load(p, c - 1);
#pragma unroll
  for (int k = 0; k < V; ++k) pc[k + 1] = mid[k];
  pc[V + 1] = fsc::load(p, c + V);
  float a[V], e[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int s = fsc::ghost_shift<V>(k, j0, side);
    const float un =
        fsc::shifted(uc, k, s) -
        (0.5f * (fsc::shifted(pc, k + 2, s) - fsc::shifted(pc, k, s))) / h;
    const float vn =
        fsc::shifted(vc, k, s) -
        (0.5f * (fsc::shifted(pd, k, s) - fsc::shifted(pu, k, s))) / h;
    a[k] = fsc::border_value(un, i, j0 + k, side, 1);
    e[k] = fsc::border_value(vn, i, j0 + k, side, 2);
  }
  fsc::store_vec<V>(uo, off + i * side + j0, a);
  fsc::store_vec<V>(vo, off + i * side + j0, e);
}

template <typename TP>
using GradientVec = void (*)(const fsc::bf16*, const fsc::bf16*, const TP*,
                             fsc::bf16*, fsc::bf16*, int, float);

// The bf16 gradient of a TP pressure in V-cell vectors (width 2, 4 or 8) or
// one cell a thread (width 1); refused with cudaErrorInvalidValue unless
// side is a multiple of the width and every pointer is aligned to its
// access.
template <typename TP>
int launch_gradient_bf16(const fsc::bf16* u, const fsc::bf16* v, const TP* p,
                         fsc::bf16* uo, fsc::bf16* vo, int side, int nb,
                         float h, int width, cudaStream_t st) {
  if (width == 1) {
    const auto kernel = gradient_kernel<fsc::bf16, TP>;
    kernel<<<fsc::grid_dim(side, nb), fsc::block_dim(), 0, st>>>(
        u, v, p, uo, vo, side, h);
    return static_cast<int>(cudaGetLastError());
  }
  const GradientVec<TP> kernel = width == 8   ? gradient_vec_kernel<8, TP>
                                 : width == 4 ? gradient_vec_kernel<4, TP>
                                 : width == 2 ? gradient_vec_kernel<2, TP>
                                              : nullptr;
  const int p_bytes = static_cast<int>(sizeof(TP)) * width;
  if (kernel == nullptr || side % width != 0 ||
      !fsc::aligned(2 * width, u, v, uo, vo) ||
      !fsc::aligned(p_bytes < 16 ? p_bytes : 16, p))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((side / width + fsc::kBlockX - 1) / fsc::kBlockX,
                  (side + fsc::kBlockY - 1) / fsc::kBlockY, nb);
  kernel<<<grid, fsc::block_dim(), 0, st>>>(u, v, p, uo, vo, side, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every pointer holds nb grids of side^2 cells; coef = -0.5*h in float32.
// Returns cudaGetLastError() after the launch.
extern "C" int fsc_divergence(const float* u, const float* v, float* out,
                              int side, int nb, float coef, void* stream) {
  const auto kernel = divergence_kernel<>;
  kernel<<<fsc::grid_dim(side, nb), fsc::block_dim(), 0,
           static_cast<cudaStream_t>(stream)>>>(u, v, out, side, coef);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form: u and v hold bf16, out float32 (out_bf16 = 0) or bf16.
// Returns cudaGetLastError() after the launch.
extern "C" int fsc_divergence_bf16(const void* u, const void* v, void* out,
                                   int side, int nb, float coef, int out_bf16,
                                   void* stream) {
  const auto* ub = static_cast<const fsc::bf16*>(u);
  const auto* vb = static_cast<const fsc::bf16*>(v);
  const auto st = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    const auto kernel = divergence_kernel<fsc::bf16, fsc::bf16>;
    kernel<<<fsc::grid_dim(side, nb), fsc::block_dim(), 0, st>>>(
        ub, vb, static_cast<fsc::bf16*>(out), side, coef);
  } else {
    const auto kernel = divergence_kernel<fsc::bf16, float>;
    kernel<<<fsc::grid_dim(side, nb), fsc::block_dim(), 0, st>>>(
        ub, vb, static_cast<float*>(out), side, coef);
  }
  return static_cast<int>(cudaGetLastError());
}

// Every pointer holds nb grids of side^2 cells; h = 1/n in float32.
// Returns cudaGetLastError() after the launch.
extern "C" int fsc_gradient(const float* u, const float* v, const float* p,
                            float* uo, float* vo, int side, int nb, float h,
                            void* stream) {
  const auto kernel = gradient_kernel<>;
  kernel<<<fsc::grid_dim(side, nb), fsc::block_dim(), 0,
           static_cast<cudaStream_t>(stream)>>>(u, v, p, uo, vo, side, h);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form: u, v, uo and vo hold bf16, p float32 (p_bf16 = 0) or
// bf16.  width is V, the cells a thread: 1 runs the one-cell kernel, 2, 4
// or 8 gradient_vec_kernel<V>, which takes side a multiple of V and every
// pointer aligned to its V-cell access (at most 16 bytes); anything else is
// refused with cudaErrorInvalidValue.  Returns cudaGetLastError() after the
// launch.
extern "C" int fsc_gradient_bf16(const void* u, const void* v, const void* p,
                                 void* uo, void* vo, int side, int nb, float h,
                                 int p_bf16, int width, void* stream) {
  const auto* ub = static_cast<const fsc::bf16*>(u);
  const auto* vb = static_cast<const fsc::bf16*>(v);
  auto* uob = static_cast<fsc::bf16*>(uo);
  auto* vob = static_cast<fsc::bf16*>(vo);
  const auto st = static_cast<cudaStream_t>(stream);
  if (p_bf16)
    return launch_gradient_bf16(ub, vb, static_cast<const fsc::bf16*>(p),
                                uob, vob, side, nb, h, width, st);
  return launch_gradient_bf16(ub, vb, static_cast<const float*>(p), uob, vob,
                              side, nb, h, width, st);
}
