// K1 jacobi_sweep: one Jacobi (or Chebyshev) sweep of a batch of padded
// grids, the per-sweep form of K1.
//
// Replaces, one sweep a launch, the sweep body of the TPU kernel
// _jacobi_kernel (fluidsimulationcuda_tpu/kernels/pallas_ops.py:301,
// pallas_call at :645), which fuses up to 20 sweeps per VMEM round-trip in
// row strips with K-deep margins.  The solves of the 2-D step run on the
// tiled K1 (jacobi_tiles.cu), which computes what this kernel's launches
// compute, T sweeps a launch, and the multigrid smoother on its damped
// form, K1-damp; this kernel is the per-sweep chain both are held against
// and timed beside (cuda_ops.launch_sweeps(0)).  Like the TPU kernel's batch
// program axis, the launch's grid layers are the grids of a batch, each
// swept alone; grids [0, nb1) take boundary mode b and the rest b1, which
// is the u/v pair of fused_jacobi_pair (:671, the TPU kernel's nb1 at
// :393-400).  With the kDamp flag a sweep is damped Jacobi, (1-w)*x +
// w*sweep in the TPU kernel's order (damp, :432-459): the smoother of the
// multigrid pressure solve (ops/multigrid.py), w = 0.8.  1-w comes from the
// host, rounded to float32 once from the double 1 - damp as the TPU kernel
// takes it (:434); 1.0f - 0.8f on the device is one ulp away.  The damped
// form is its own instantiation, so the undamped sweep compiles as it did
// without it.
//
// Bound: device memory.  A launch reads x (five points, four of them
// shared with neighbouring threads through L1/L2), rhs, and for Chebyshev
// x_{k-1}, and writes one value: 12-16 bytes a cell a sweep, where the
// solve needs 8-12 bytes a cell in all (kernels/checks.py: _sweeps_cost),
// so a 20-sweep solve on one launch a sweep runs at 2-5% of its bound.  The
// tiled K1 keeps the iterate in shared memory between sweeps for that
// reason.  The border is derived in the same launch (fsc_common.cuh), so a
// sweep costs one pass, not two.
//
// The bf16 form (fsc_jacobi_sweep_bf16) is the TPU kernel's bf16 storage
// mode (xs2/rhs2 in bf16, buf_b/buf_c in float32, pallas_ops.py:315-316):
// rhs and the rhs it builds are bf16, rounded before any sweep reads them;
// the iterate stays float32 from the first sweep to the last.  So a solve's
// first sweep reads the caller's bf16 guess, its second the bf16 guess as
// x_{k-1} (Chebyshev), the middle sweeps float32 scratch, and its last
// writes bf16: each a template instantiation over the types of x, x_{k-1}
// and out, chosen at launch.
#include "fsc_common.cuh"

namespace {

template <bool kDamped, typename TX = float, typename TM = float,
          typename TR = float, typename TO = float>
__global__ void jacobi_sweep_kernel(fsc::SweepParamsT<TX, TM, TR> p,
                                    TO* __restrict__ out,
                                    TR* __restrict__ rhs_out, int side,
                                    int b, int nb1, int b1, float omw) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= side || j >= side) return;
  const int off = fsc::grid_offset(side);
  const int mode = static_cast<int>(blockIdx.z) < nb1 ? b : b1;
  const int c = fsc::interior_of(i, j, side);
  const int g = off + c;
  const float r = fsc::rhs_at(p, g);
  float val = fsc::sweep_at(p, g, side, r);
  if (kDamped) val = omw * (p.x ? fsc::load(p.x, g) : 0.0f) + p.w * val;
  // The first sweep of a folded solve stores the rhs it built, once per
  // interior cell, for the sweeps after it.
  if (rhs_out != nullptr && c == i * side + j) fsc::store(rhs_out, g, r);
  fsc::store(out, off + i * side + j,
             fsc::border_value(val, i, j, side, mode));
}

// One bf16-form sweep: x and src stored as TX, x_{k-1} as TM, out as TO;
// rhs and rhs_out bf16.
template <typename TX, typename TM, typename TO>
int launch_bf16(const void* x, const void* rhs, const void* src,
                const void* xm, void* out, void* rhs_out, int side, int b,
                float alpha, float beta, float ab, float inv_b, float src_dt,
                float w, int flags, int nb, int nb1, int b1,
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
  const auto kernel = jacobi_sweep_kernel<false, TX, TM, fsc::bf16, TO>;
  kernel<<<fsc::grid_dim(side, nb), fsc::block_dim(), 0, stream>>>(
      p, static_cast<TO*>(out), static_cast<fsc::bf16*>(rhs_out), side, b,
      nb1, b1, 0.0f);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TM>
int launch_bf16_out(bool out_bf16, const void* x, const void* rhs,
                    const void* src, const void* xm, void* out, void* rhs_out,
                    int side, int b, float alpha, float beta, float ab,
                    float inv_b, float src_dt, float w, int flags, int nb,
                    int nb1, int b1, cudaStream_t stream) {
  const auto launch = out_bf16 ? launch_bf16<TX, TM, fsc::bf16>
                               : launch_bf16<TX, TM, float>;
  return launch(x, rhs, src, xm, out, rhs_out, side, b, alpha, beta, ab,
                inv_b, src_dt, w, flags, nb, nb1, b1, stream);
}

}  // namespace

// Every pointer holds nb grids of side^2 cells.  x, src, xm and rhs_out may
// be null (see fsc::SweepParams); out must not alias any input.  Grids
// [0, nb1) take boundary mode b, grids [nb1, nb) mode b1.  omw is 1-w of
// the damped sweep (flags has kDamp; kCheby excluded), unread otherwise.
// Returns cudaGetLastError() after the launch.
extern "C" int fsc_jacobi_sweep(const float* x, const float* rhs,
                                const float* src, const float* xm, float* out,
                                float* rhs_out, int side, int b, float alpha,
                                float beta, float ab, float inv_b,
                                float src_dt, float w, int flags, int nb,
                                int nb1, int b1, float omw, void* stream) {
  const fsc::SweepParams p = fsc::make_sweep_params(
      x, rhs, src, xm, alpha, beta, ab, inv_b, src_dt, w, flags);
  const auto kernel = (flags & fsc::kDamp) ? jacobi_sweep_kernel<true>
                                           : jacobi_sweep_kernel<false>;
  kernel<<<fsc::grid_dim(side, nb), fsc::block_dim(), 0,
           static_cast<cudaStream_t>(stream)>>>(p, out, rhs_out, side, b, nb1,
                                                b1, omw);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form: rhs (and rhs_out) hold bf16; types says which of x (1),
// xm (2) and out (4) hold bf16, the others float32.  src is stored as x.
// The damped sweep has no bf16 form.  Returns cudaGetLastError() after the
// launch.
extern "C" int fsc_jacobi_sweep_bf16(const void* x, const void* rhs,
                                     const void* src, const void* xm,
                                     void* out, void* rhs_out, int side, int b,
                                     float alpha, float beta, float ab,
                                     float inv_b, float src_dt, float w,
                                     int flags, int nb, int nb1, int b1,
                                     float omw, int types, void* stream) {
  (void)omw;
  const bool out_bf16 = (types & 4) != 0;
  const auto launch =
      (types & 1) ? ((types & 2) ? launch_bf16_out<fsc::bf16, fsc::bf16>
                                 : launch_bf16_out<fsc::bf16, float>)
                  : ((types & 2) ? launch_bf16_out<float, fsc::bf16>
                                 : launch_bf16_out<float, float>);
  return launch(out_bf16, x, rhs, src, xm, out, rhs_out, side, b, alpha, beta,
                ab, inv_b, src_dt, w, flags, nb, nb1, b1,
                static_cast<cudaStream_t>(stream));
}
