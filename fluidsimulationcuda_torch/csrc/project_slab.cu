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
//
// K10-block divergence_block and K11-block gradient_block: the same two
// stencils on an (m, k) block of the 2-D block route at global origin
// (r0, c0) (_divergence_local and _gradient_local,
// fluidsimulationcuda_tpu/parallel/sharded.py:317 and :329, jnp, which
// extend the block by a one-cell halo from its four neighbours).  A halo
// is a pointer to the one row (top, bottom) or the one column (left,
// right, contiguous) the stencil needs, null beyond a wall, where no cell
// reads it.  A ghost cell of the grid in the block takes the border rule
// of its interior neighbour's value, which lies in the block.  Each has a
// bf16 form (fsc_divergence_block_bf16, fsc_gradient_block_bf16): bf16
// operands, halos and outputs, widened at the loads, the arithmetic float32
// and each output rounded to bf16 at the store (JAX's block route keeps
// div, p, u and v in bf16; it rounds every operation).
//
// K11-block grouped (fsc_gradient_block_group, and _bf16): the gradient of
// every block of a device in one launch, the path of every cuda block
// step since the per-block launch above, which stays as the form it is
// held against.  p's neighbour rows and columns are read from the
// neighbouring blocks' own arrays (copies where they lie on another
// device), so no Blocks.halos of p is built; the kernel and its table are
// in block_group.cuh.
//
// Bound: 20 bytes a cell in float32, 10 in bf16, as K11-block.
#include "block_group.cuh"
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

// Cell (ri, ci) of an (m, k) block or, one cell past its edge, of the
// halo there (top and bottom rows, left and right columns), as float.
template <typename T>
__device__ __forceinline__ float block_at(const T* f, const T* top,
                                          const T* bot, const T* left,
                                          const T* right, int ri, int ci,
                                          int m, int k) {
  if (ri < 0) return fsc::load(top, ci);
  if (ri >= m) return fsc::load(bot, ci);
  if (ci < 0) return fsc::load(left, ri);
  if (ci >= k) return fsc::load(right, ri);
  return fsc::load(f, ri * k + ci);
}

template <typename T>
__global__ void divergence_block_kernel(
    const T* __restrict__ u, const T* __restrict__ v,
    const T* __restrict__ u_left, const T* __restrict__ u_right,
    const T* __restrict__ v_top, const T* __restrict__ v_bot,
    T* __restrict__ out, int m, int k, int n, int r0, int c0, float coef) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= m || j >= k) return;
  const int ri = fsc::clampi(r0 + r, 1, n) - r0;
  const int ci = fsc::clampi(c0 + j, 1, n) - c0;
  const float u_l = block_at<T>(u, nullptr, nullptr, u_left, u_right, ri,
                                ci - 1, m, k);
  const float u_r = block_at<T>(u, nullptr, nullptr, u_left, u_right, ri,
                                ci + 1, m, k);
  const float v_up = block_at<T>(v, v_top, v_bot, nullptr, nullptr, ri - 1,
                                 ci, m, k);
  const float v_dn = block_at<T>(v, v_top, v_bot, nullptr, nullptr, ri + 1,
                                 ci, m, k);
  const float d = coef * ((u_r - u_l) + (v_dn - v_up));
  fsc::store(out, r * k + j,
             fsc::border_rule(d, c0 + j == 0 || c0 + j == n + 1,
                              r0 + r == 0 || r0 + r == n + 1, 0));
}

template <typename T>
__global__ void gradient_block_kernel(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ p,
    const T* __restrict__ p_top, const T* __restrict__ p_bot,
    const T* __restrict__ p_left, const T* __restrict__ p_right,
    T* __restrict__ uo, T* __restrict__ vo, int m, int k, int n, int r0,
    int c0, float h) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= m || j >= k) return;
  const int ri = fsc::clampi(r0 + r, 1, n) - r0;
  const int ci = fsc::clampi(c0 + j, 1, n) - c0;
  const int c = ri * k + ci;
  const float p_l = block_at<T>(p, p_top, p_bot, p_left, p_right, ri,
                                ci - 1, m, k);
  const float p_r = block_at<T>(p, p_top, p_bot, p_left, p_right, ri,
                                ci + 1, m, k);
  const float p_up = block_at<T>(p, p_top, p_bot, p_left, p_right, ri - 1,
                                 ci, m, k);
  const float p_dn = block_at<T>(p, p_top, p_bot, p_left, p_right, ri + 1,
                                 ci, m, k);
  const float un = fsc::load(u, c) - (0.5f * (p_r - p_l)) / h;
  const float vn = fsc::load(v, c) - (0.5f * (p_dn - p_up)) / h;
  const bool gx = c0 + j == 0 || c0 + j == n + 1;
  const bool gy = r0 + r == 0 || r0 + r == n + 1;
  fsc::store(uo, r * k + j, fsc::border_rule(un, gx, gy, 1));
  fsc::store(vo, r * k + j, fsc::border_rule(vn, gx, gy, 2));
}

template <typename T>
int divergence_block(const void* u, const void* v, const void* u_left,
                     const void* u_right, const void* v_top,
                     const void* v_bot, void* out, int m, int k, int n,
                     int r0, int c0, float coef, void* stream) {
  if (!fsc::block_in_grid(m, k, n, r0, c0, v_top, v_bot, u_left, u_right))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = divergence_block_kernel<T>;
  kernel<<<fsc::slab_grid_dim(k, m), fsc::block_dim(), 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(v),
      static_cast<const T*>(u_left), static_cast<const T*>(u_right),
      static_cast<const T*>(v_top), static_cast<const T*>(v_bot),
      static_cast<T*>(out), m, k, n, r0, c0, coef);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gradient_block(const void* u, const void* v, const void* p,
                   const void* p_top, const void* p_bot, const void* p_left,
                   const void* p_right, void* uo, void* vo, int m, int k,
                   int n, int r0, int c0, float h, void* stream) {
  if (!fsc::block_in_grid(m, k, n, r0, c0, p_top, p_bot, p_left, p_right))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = gradient_block_kernel<T>;
  kernel<<<fsc::slab_grid_dim(k, m), fsc::block_dim(), 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(v),
      static_cast<const T*>(p), static_cast<const T*>(p_top),
      static_cast<const T*>(p_bot), static_cast<const T*>(p_left),
      static_cast<const T*>(p_right), static_cast<T*>(uo),
      static_cast<T*>(vo), m, k, n, r0, c0, h);
  return static_cast<int>(cudaGetLastError());
}

// One grouped K11-block launch (fsc_gradient_block_group's arguments) with
// every operand stored as T, `width` cells a thread: 1 or 2 in float32, 1,
// 2, 4 or 8 in bf16 (gradient_block_group_kernel's designs).
template <typename T>
int gradient_group(const void* ptrs, const void* ints, int blocks, int m,
                   int k, int n, float h, int width, void* stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  fsc::GradGroup g;
  // h positive and finite: 0/h is then the zero numerator itself.
  const bool widths = width == 1 || width == 2 ||
                      (kBf16 && (width == 4 || width == 8));
  if (!(h > 0.0f && h <= 3.4e38f) || !widths || k % width != 0 ||
      !fsc::grad_table<T>(static_cast<const void* const*>(ptrs),
                          static_cast<const int*>(ints), blocks, m, k, n,
                          width, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if constexpr (kBf16) {
    if (width == 8)
      return fsc::launch_gradient_group<8, T>(g, blocks, m, k, n, h, s);
    if (width == 4)
      return fsc::launch_gradient_group<4, T>(g, blocks, m, k, n, h, s);
  }
  return width == 2
             ? fsc::launch_gradient_group<2, T>(g, blocks, m, k, n, h, s)
             : fsc::launch_gradient_group<1, T>(g, blocks, m, k, n, h, s);
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

// K10-block: u, v, out (m, k) at global origin (r0, c0); u_left/u_right
// u's columns left and right of the block (m floats each), v_top/v_bot v's
// rows above and below it (k floats each), null beyond a wall.  coef =
// -0.5*h in float32.  Returns cudaErrorInvalidValue for a block outside
// the grid or a missing halo, otherwise cudaGetLastError() after the
// launch.
extern "C" int fsc_divergence_block(const float* u, const float* v,
                                    const float* u_left,
                                    const float* u_right, const float* v_top,
                                    const float* v_bot, float* out, int m,
                                    int k, int n, int r0, int c0, float coef,
                                    void* stream) {
  return divergence_block<float>(u, v, u_left, u_right, v_top, v_bot, out, m,
                                 k, n, r0, c0, coef, stream);
}

// K10-block's bf16 form: every operand and out bf16, the rest as
// fsc_divergence_block's.
extern "C" int fsc_divergence_block_bf16(const void* u, const void* v,
                                         const void* u_left,
                                         const void* u_right,
                                         const void* v_top, const void* v_bot,
                                         void* out, int m, int k, int n,
                                         int r0, int c0, float coef,
                                         void* stream) {
  return divergence_block<fsc::bf16>(u, v, u_left, u_right, v_top, v_bot,
                                     out, m, k, n, r0, c0, coef, stream);
}

// K11-block: u, v, p, uo, vo (m, k) at global origin (r0, c0); p_top,
// p_bot (k floats), p_left, p_right (m floats): p's halo, null beyond a
// wall.  h = 1/n in float32.  Returns as fsc_divergence_block.
extern "C" int fsc_gradient_block(const float* u, const float* v,
                                  const float* p, const float* p_top,
                                  const float* p_bot, const float* p_left,
                                  const float* p_right, float* uo, float* vo,
                                  int m, int k, int n, int r0, int c0,
                                  float h, void* stream) {
  return gradient_block<float>(u, v, p, p_top, p_bot, p_left, p_right, uo,
                               vo, m, k, n, r0, c0, h, stream);
}

// K11-block's bf16 form: every operand, uo and vo bf16, the rest as
// fsc_gradient_block's.
extern "C" int fsc_gradient_block_bf16(const void* u, const void* v,
                                       const void* p, const void* p_top,
                                       const void* p_bot, const void* p_left,
                                       const void* p_right, void* uo,
                                       void* vo, int m, int k, int n, int r0,
                                       int c0, float h, void* stream) {
  return gradient_block<fsc::bf16>(u, v, p, p_top, p_bot, p_left, p_right,
                                   uo, vo, m, k, n, r0, c0, h, stream);
}

// K11-block grouped: the gradient of `blocks` (m, k) blocks (at most
// kStencilBlocks) in one launch.  ptrs holds 9 pointers a block (u, v, p,
// uo, vo, then p's neighbours: the row above and below, k cells each, the
// column left and right, m cells each; null beyond a wall), ints 4 a block
// (r0, c0, and the row strides of the left and right columns: k in the
// neighbour's own array, 1 in a copy).  h = 1/n in float32, `width` the
// cells a thread (1 or 2).  Returns cudaErrorInvalidValue for a bad
// table, width or alignment, otherwise cudaGetLastError() after the
// launch.
extern "C" int fsc_gradient_block_group(const void* ptrs, const void* ints,
                                        int blocks, int m, int k, int n,
                                        float h, int width, void* stream) {
  return gradient_group<float>(ptrs, ints, blocks, m, k, n, h, width,
                               stream);
}

// K11-block grouped, bf16 form: every operand bf16, widths 1, 2, 4 and 8,
// the rest as fsc_gradient_block_group's.
extern "C" int fsc_gradient_block_group_bf16(const void* ptrs,
                                             const void* ints, int blocks,
                                             int m, int k, int n, float h,
                                             int width, void* stream) {
  return gradient_group<fsc::bf16>(ptrs, ints, blocks, m, k, n, h, width,
                                   stream);
}
