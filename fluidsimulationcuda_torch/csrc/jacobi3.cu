// K5 jacobi3_sweep: one 7-point Jacobi (or Chebyshev) sweep of a padded
// volume.
//
// Replaces the sweep body of the TPU kernel _jacobi3_kernel
// (fluidsimulationcuda_tpu/kernels/pallas_ops_3d.py:155), reached through
// fused_jacobi3 (:369) at the pallas_calls of _fused_jacobi3_call (:458)
// and, with the Chebyshev combine, _fused_jacobi3_cheby_call (:522).  The
// TPU kernel fuses several sweeps per VMEM round-trip over z-plane strips
// with margins and carries x_{k-1} between its calls; here one launch is
// one sweep, the wrapper rotates scratch volumes (kernels/cuda_ops.py
// _Sweeps), and nothing is carried between blocks.
//
// Bound: device memory.  A sweep reads x (seven points, six of them shared
// with neighbouring threads through L1/L2), rhs and, for Chebyshev,
// x_{k-1}, and writes one value: 12-16 bytes a cell, 60-80 us at 256^3 on
// 3.35 TB/s.  A 67 MB field does not stay in the 50 MB L2, so every sweep
// goes to HBM.  The ghost layer is derived in the same launch (fsc_common.cuh
// border_value3); the first sweep reads the guess as it is, ghost faces
// included, as ops/three_d.py diffuse3 does.  It runs in the vector form of
// jacobi3_walk.cuh, 4 cells of a row a thread walking 3 planes in z
// (jacobi3_sweep_vec_kernel: a middle float32 sweep at 256^3 in 0.0726 ms,
// 83% of its bound, against the one-cell kernel's 0.0880; PERF.md), or,
// where the wrapper finds no width for the side and the operands, one cell
// a thread (jacobi3_sweep_kernel).  Two sweeps a launch (a two-level
// wavefront in z, dev/sweep3_pair/) measured 1.4x two launches of the
// vector form and are not built.
//
// The bf16 form (fsc_jacobi3_sweep_bf16) is the per-sweep K1's bf16 rule
// (jacobi.cu) on a volume: rhs and the rhs it builds are bf16, rounded
// before any sweep reads them; the iterate stays float32 from the first
// sweep to the last.  A solve's first sweep reads the caller's bf16 guess,
// a Chebyshev solve's second the bf16 guess as x_{k-1}, the middle sweeps
// float32 scratch, and its last writes bf16: each a template
// instantiation over the types of x, x_{k-1} and out, chosen at launch.
// It runs in the same two forms (the vector form 0.64-0.70x the one-cell
// kernel's time at 256^3, PERF.md).
#include "fsc_common.cuh"
#include "jacobi3_walk.cuh"

namespace {

template <typename TX = float, typename TM = float, typename TR = float,
          typename TO = float>
__global__ void jacobi3_sweep_kernel(fsc::SweepParamsT<TX, TM, TR> p,
                                     TO* __restrict__ out,
                                     TR* __restrict__ rhs_out, int side,
                                     int b) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= side || j >= side) return;
  const int c = fsc::interior_of3(k, i, j, side);
  const int o = (k * side + i) * side + j;
  const float r = fsc::rhs_at(p, c);
  const float val = fsc::sweep_at3(p, c, side, r);
  // The first sweep of a folded solve stores the rhs it built, once per
  // interior cell, for the sweeps after it.
  if (rhs_out != nullptr && c == o) fsc::store(rhs_out, c, r);
  fsc::store(out, o, fsc::border_value3(val, k, i, j, side, b));
}

// The vector form over the whole volume: planes [0, side), the wall ghost
// planes 0 and side-1.
template <typename TX, typename TM, typename TR, typename TO>
__global__ void __launch_bounds__(fsc::kBlockX * fsc::kBlockY)
    jacobi3_sweep_vec_kernel(fsc::SweepParamsT<TX, TM, TR> p,
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
                float w, int flags, int width, int walk,
                cudaStream_t stream) {
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
    const auto kernel = jacobi3_sweep_kernel<TX, TM, fsc::bf16, TO>;
    kernel<<<fsc::grid_dim3(side), fsc::block_dim(), 0, stream>>>(
        p, o, ro, side, b);
    return static_cast<int>(cudaGetLastError());
  }
  if (width != fsc::kSweep3Width)
    return static_cast<int>(cudaErrorInvalidValue);
  return fsc::launch_walk(jacobi3_sweep_vec_kernel<TX, TM, fsc::bf16, TO>, p,
                          o, ro, side, b, 0, side, 0, side - 1, walk, stream);
}

template <typename TX, typename TM>
int launch_bf16_out(bool out_bf16, const void* x, const void* rhs,
                    const void* src, const void* xm, void* out, void* rhs_out,
                    int side, int b, float alpha, float beta, float ab,
                    float inv_b, float src_dt, float w, int flags, int width,
                    int walk, cudaStream_t stream) {
  const auto launch = out_bf16 ? launch_bf16<TX, TM, fsc::bf16>
                               : launch_bf16<TX, TM, float>;
  return launch(x, rhs, src, xm, out, rhs_out, side, b, alpha, beta, ab,
                inv_b, src_dt, w, flags, width, walk, stream);
}

}  // namespace

// The arguments of fsc_jacobi_sweep (jacobi.cu) on a (side, side, side)
// volume, and the form: width 1 runs the one-cell kernel, 4
// (fsc::kSweep3Width) the vector form, each thread walking `walk` planes,
// which takes side a multiple of 4 and every operand aligned to its
// 16-byte access; anything else is refused with cudaErrorInvalidValue.
// Returns cudaGetLastError() after the launch.
extern "C" int fsc_jacobi3_sweep(const float* x, const float* rhs,
                                 const float* src, const float* xm, float* out,
                                 float* rhs_out, int side, int b, float alpha,
                                 float beta, float ab, float inv_b,
                                 float src_dt, float w, int flags, int width,
                                 int walk, void* stream) {
  const fsc::SweepParams p = fsc::make_sweep_params(
      x, rhs, src, xm, alpha, beta, ab, inv_b, src_dt, w, flags);
  const auto s = static_cast<cudaStream_t>(stream);
  if (width == 1) {
    const auto kernel = jacobi3_sweep_kernel<>;
    kernel<<<fsc::grid_dim3(side), fsc::block_dim(), 0, s>>>(p, out, rhs_out,
                                                             side, b);
    return static_cast<int>(cudaGetLastError());
  }
  if (width != fsc::kSweep3Width)
    return static_cast<int>(cudaErrorInvalidValue);
  return fsc::launch_walk(jacobi3_sweep_vec_kernel<float, float, float, float>,
                          p, out, rhs_out, side, b, 0, side, 0, side - 1,
                          walk, s);
}

// The bf16 form: rhs (and rhs_out) hold bf16; types says which of x (1),
// xm (2) and out (4) hold bf16, the others float32.  src is stored as x.
// width is the cells a thread: 1 runs the one-cell kernel, 4
// (fsc::kSweep3Width) the vector form, each thread walking `walk` planes,
// which takes side a multiple of 4 and every operand aligned to its 4-cell
// access; anything else is refused with cudaErrorInvalidValue.  Returns
// cudaGetLastError() after the launch.
extern "C" int fsc_jacobi3_sweep_bf16(const void* x, const void* rhs,
                                      const void* src, const void* xm,
                                      void* out, void* rhs_out, int side,
                                      int b, float alpha, float beta,
                                      float ab, float inv_b, float src_dt,
                                      float w, int flags, int types,
                                      int width, int walk, void* stream) {
  const bool out_bf16 = (types & 4) != 0;
  const auto launch =
      (types & 1) ? ((types & 2) ? launch_bf16_out<fsc::bf16, fsc::bf16>
                                 : launch_bf16_out<fsc::bf16, float>)
                  : ((types & 2) ? launch_bf16_out<float, fsc::bf16>
                                 : launch_bf16_out<float, float>);
  return launch(out_bf16, x, rhs, src, xm, out, rhs_out, side, b, alpha, beta,
                ab, inv_b, src_dt, w, flags, width, walk,
                static_cast<cudaStream_t>(stream));
}
