// K13 jacobi3_slab: one 7-point Jacobi (or Chebyshev) sweep over planes
// [lo, hi) of a plane-halo-extended z-slab.
//
// Replaces the TPU kernel _jacobi3_slab_kernel
// (fluidsimulationcuda_tpu/kernels/pallas_sharded_3d.py:105), reached
// through fused_jacobi3_slab (:310, pallas_call at :349) and, as one
// Chebyshev chain segment, fused_cheby3_slab (:381, pallas_call at :442).
// It is K5 (jacobi3.cu) restricted to a range of planes of an
// (mz + 2H, side, side) buffer, with wall planes.  The TPU kernel runs all
// sweeps of a halo exchange in VMEM, strip by strip, folding the border rule
// into its neighbour reads; here one launch is one sweep, and the wrapper
// (kernels/cuda_sharded_3d.py) rotates scratch buffers with
// cuda_ops._Sweeps, which also resumes a Chebyshev chain at a given sweep
// with x_{k-1} carried in and hands both final iterates back.  Sweep k
// computes planes [k, mz+2H-k): the buffer's edge planes have no neighbour
// beyond them, and what they would hold reaches one plane further in per
// sweep, so it never touches the mz slab planes while k < H.
//
// The global wall ghost planes (gtop, gbot: buffer planes, -1 when absent)
// take the set_bnd3 rule from the plane next to them, and ghost rows and
// columns do the same on every plane (fsc_common.cuh slab_border_value3):
// the full ghost layer, in the launch that computes it.  The first sweep of
// a solve reads the guess as it is, ghost faces included (the TPU kernel's
// unfolded first sweep, pallas_sharded_3d.py:252); later sweeps, and a
// chained segment's first, read faces derived from the interior, which is
// what the TPU kernel's folded reads compute.
//
// Bound: device memory, as K5: 12 bytes a cell (16 with Chebyshev) over the
// planes a sweep computes, the 2H halo planes computed again by each slab.
// It runs in K5's vector form (jacobi3_walk.cuh, jacobi3_slab_vec_kernel)
// on the plane range, or one cell a thread (jacobi3_slab_kernel) where the
// wrapper finds no width for the side and the operands.
//
// The bf16 form (fsc_jacobi3_slab_bf16) is the per-sweep K5's bf16 rule
// (jacobi3.cu) on a z-slab segment: the rhs is bf16, built and rounded by
// the caller before any sweep reads it; the iterate stays float32 from the
// solve's first sweep to its last, across the segments and the halo
// exchanges between them, so only the solve's last sweep writes bf16.  The
// first sweep of a solve reads the caller's bf16 guess, a Chebyshev
// solve's second the bf16 guess as x_{k-1}, every other sweep float32
// scratch: each a template instantiation over the types of x, x_{k-1} and
// out, chosen at launch, in the same two forms.
#include "fsc_common.cuh"
#include "jacobi3_walk.cuh"

namespace {

template <typename TX = float, typename TM = float, typename TR = float,
          typename TO = float>
__global__ void jacobi3_slab_kernel(fsc::SweepParamsT<TX, TM, TR> p,
                                    TO* __restrict__ out,
                                    TR* __restrict__ rhs_out, int side,
                                    int b, int lo, int gtop, int gbot) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = lo + static_cast<int>(blockIdx.z);
  if (i >= side || j >= side) return;
  const int c = fsc::slab_interior_of3(k, i, j, side, gtop, gbot);
  const int o = (k * side + i) * side + j;
  const float r = fsc::rhs_at(p, c);
  const float val = fsc::sweep_at3(p, c, side, r);
  // The first sweep of a fast solve stores the rhs it built, once per cell
  // that is its own interior cell, for the sweeps after it.
  if (rhs_out != nullptr && c == o) fsc::store(rhs_out, c, r);
  fsc::store(out, o,
             fsc::slab_border_value3(val, k, i, j, side, gtop, gbot, b));
}

// The vector form over planes [lo, hi) of the buffer.
template <typename TX, typename TM, typename TR, typename TO>
__global__ void __launch_bounds__(fsc::kBlockX * fsc::kBlockY)
    jacobi3_slab_vec_kernel(fsc::SweepParamsT<TX, TM, TR> p,
                            TO* __restrict__ out,
                            TR* __restrict__ rhs_out, int side, int b, int lo,
                            int hi, int gtop, int gbot, int walk) {
  fsc::sweep3_walk<fsc::kSweep3Width>(p, out, rhs_out, side, b, lo, hi,
                                      gtop, gbot, walk);
}

// One bf16-form sweep: x and src stored as TX, x_{k-1} as TM, out as TO;
// rhs and rhs_out bf16; width cells a thread (1: the one-cell kernel).
template <typename TX, typename TM, typename TO>
int launch_bf16(const void* x, const void* rhs, const void* src,
                const void* xm, void* out, void* rhs_out, int side, int b,
                float alpha, float beta, float ab, float inv_b, float src_dt,
                float w, int flags, int lo, int hi, int gtop, int gbot,
                int width, int walk, cudaStream_t stream) {
  fsc::SweepParamsT<TX, TM, fsc::bf16> p;
  p.x = static_cast<const TX*>(x);
  p.rhs = static_cast<const fsc::bf16*>(rhs);
  p.src = static_cast<const TX*>(src);
  p.xm = static_cast<const TM*>(xm);
  p.alpha = alpha;
  p.beta = beta;
  p.ab = ab;
  p.inv_b = inv_b;
  p.src_dt = src_dt;
  p.w = w;
  p.flags = flags;
  auto* o = static_cast<TO*>(out);
  auto* ro = static_cast<fsc::bf16*>(rhs_out);
  if (width == 1) {
    const auto kernel = jacobi3_slab_kernel<TX, TM, fsc::bf16, TO>;
    kernel<<<fsc::slab_grid_dim3(side, hi - lo), fsc::block_dim(), 0,
             stream>>>(p, o, ro, side, b, lo, gtop, gbot);
    return static_cast<int>(cudaGetLastError());
  }
  if (width != fsc::kSweep3Width)
    return static_cast<int>(cudaErrorInvalidValue);
  return fsc::launch_walk(jacobi3_slab_vec_kernel<TX, TM, fsc::bf16, TO>, p,
                          o, ro, side, b, lo, hi, gtop, gbot, walk, stream);
}

template <typename TX, typename TM>
int launch_bf16_out(bool out_bf16, const void* x, const void* rhs,
                    const void* src, const void* xm, void* out, void* rhs_out,
                    int side, int b, float alpha, float beta, float ab,
                    float inv_b, float src_dt, float w, int flags, int lo,
                    int hi, int gtop, int gbot, int width, int walk,
                    cudaStream_t stream) {
  const auto launch = out_bf16 ? launch_bf16<TX, TM, fsc::bf16>
                               : launch_bf16<TX, TM, float>;
  return launch(x, rhs, src, xm, out, rhs_out, side, b, alpha, beta, ab,
                inv_b, src_dt, w, flags, lo, hi, gtop, gbot, width, walk,
                stream);
}

}  // namespace

// The sweep arguments (x .. flags) are those of fsc_jacobi3_sweep, on
// (planes, side, side) buffers; planes [lo, hi) of out are written, and a
// sweep reads planes [lo-1, hi+1) of x.  width and walk choose the form
// (fsc_jacobi3_sweep's).  Returns cudaGetLastError() after the launch.
extern "C" int fsc_jacobi3_slab(const float* x, const float* rhs,
                                const float* src, const float* xm, float* out,
                                float* rhs_out, int side, int b, float alpha,
                                float beta, float ab, float inv_b,
                                float src_dt, float w, int flags, int lo,
                                int hi, int gtop, int gbot, int width,
                                int walk, void* stream) {
  if (hi <= lo) return 0;
  const fsc::SweepParams p = fsc::make_sweep_params(
      x, rhs, src, xm, alpha, beta, ab, inv_b, src_dt, w, flags);
  const auto s = static_cast<cudaStream_t>(stream);
  if (width == 1) {
    const auto kernel = jacobi3_slab_kernel<>;
    kernel<<<fsc::slab_grid_dim3(side, hi - lo), fsc::block_dim(), 0, s>>>(
        p, out, rhs_out, side, b, lo, gtop, gbot);
    return static_cast<int>(cudaGetLastError());
  }
  if (width != fsc::kSweep3Width)
    return static_cast<int>(cudaErrorInvalidValue);
  return fsc::launch_walk(jacobi3_slab_vec_kernel<float, float, float, float>,
                          p, out, rhs_out, side, b, lo, hi, gtop, gbot, walk,
                          s);
}

// The bf16 form: rhs (and rhs_out) hold bf16; types says which of x (1),
// xm (2) and out (4) hold bf16, the others float32, and width and walk
// choose the form (fsc_jacobi3_sweep_bf16's).  src is stored as x.  The
// other arguments are fsc_jacobi3_slab's.
extern "C" int fsc_jacobi3_slab_bf16(const void* x, const void* rhs,
                                     const void* src, const void* xm,
                                     void* out, void* rhs_out, int side,
                                     int b, float alpha, float beta, float ab,
                                     float inv_b, float src_dt, float w,
                                     int flags, int lo, int hi, int gtop,
                                     int gbot, int types, int width, int walk,
                                     void* stream) {
  if (hi <= lo) return 0;
  const bool out_bf16 = (types & 4) != 0;
  const auto launch =
      (types & 1) ? ((types & 2) ? launch_bf16_out<fsc::bf16, fsc::bf16>
                                 : launch_bf16_out<fsc::bf16, float>)
                  : ((types & 2) ? launch_bf16_out<float, fsc::bf16>
                                 : launch_bf16_out<float, float>);
  return launch(out_bf16, x, rhs, src, xm, out, rhs_out, side, b, alpha, beta,
                ab, inv_b, src_dt, w, flags, lo, hi, gtop, gbot, width, walk,
                static_cast<cudaStream_t>(stream));
}
