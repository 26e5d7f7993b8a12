// The two-sweep form of the per-sweep K5 and K13 (jacobi3_pair.cuh):
// measured on the H100 and not built into the port's library, since two
// sweeps of the one-sweep walk (csrc/jacobi3_walk.cuh) beat it at every
// shape the steps use (PERF.md §6).  dev/bench_sweep3.py --pairs builds it
// beside csrc/ and times it; its entry points take the walk's operands
// with level s+1's plane range.
#include "jacobi3_pair.cuh"

namespace {

// The two-sweep form (jacobi3_pair.cuh) over planes [lo, hi) of a buffer:
// NW warps a block, the rhs stored as TR; at most 64 registers a thread, so
// that 1024 threads fit an SM.
template <int NW, typename TR>
__global__ void __launch_bounds__(fsc::kBlockX * NW,
                                  1024 / (fsc::kBlockX * NW))
    jacobi3_pair_kernel(fsc::SweepParamsT<float, float, TR> p,
                        float* __restrict__ out, int side, int b, int lo,
                        int hi, int planes, int gtop, int gbot, int walk) {
  fsc::sweep3_pair<NW>(p, out, side, b, lo, hi, planes, gtop, gbot, walk);
}

// One pair launch with the rhs stored as TR.
template <typename TR>
int pair_launch(const float* x, const void* rhs, float* out, int side, int b,
                float alpha, float beta, float ab, int flags, int lo, int hi,
                int planes, int gtop, int gbot, int rows, int walk,
                cudaStream_t stream) {
  fsc::SweepParamsT<float, float, TR> p;
  p.x = x;
  p.rhs = static_cast<const TR*>(rhs);
  p.src = nullptr;
  p.xm = nullptr;
  p.alpha = alpha;
  p.beta = beta;
  p.ab = ab;
  p.inv_b = 0.0f;
  p.src_dt = 0.0f;
  p.w = 0.0f;
  p.flags = flags;
  return fsc::launch_pair(jacobi3_pair_kernel<8, TR>,
                          jacobi3_pair_kernel<10, TR>,
                          jacobi3_pair_kernel<16, TR>, p, out, side, b,
                          lo, hi, planes, gtop, gbot, rows, walk, stream);
}

}  // namespace

// Sweeps s and s+1 of a Jacobi solve in one launch (jacobi3_pair.cuh) on
// a (side, side, side) volume: x (x_s) and out (x_{s+2}) float32, the rhs
// bf16 where rhs_bf16, else float32; alpha, beta, ab and flags are
// fsc_jacobi3_sweep's (kFast or none).  rows (6, 8 or 14) are a tile's
// interior rows and walk the planes of level s+1 a block walks.  Refused
// with cudaErrorInvalidValue as fsc::launch_pair says.  Returns
// cudaGetLastError() after the launch.
extern "C" int fsc_jacobi3_sweep_pair(const float* x, const void* rhs,
                                      float* out, int side, int b,
                                      float alpha, float beta, float ab,
                                      int flags, int rhs_bf16, int rows,
                                      int walk, void* stream) {
  const auto launch = rhs_bf16 ? pair_launch<fsc::bf16> : pair_launch<float>;
  return launch(x, rhs, out, side, b, alpha, beta, ab, flags, 0, side, side,
                0, side - 1, rows, walk, static_cast<cudaStream_t>(stream));
}

// Sweeps s and s+1 of a Jacobi solve in one launch (jacobi3_pair.cuh) on
// (planes, side, side) buffers: level s+1 written at planes [lo, hi),
// level s computed at planes [lo-1, hi+1) where they lie in the buffer, so
// a launch reads planes [lo-2, hi+2) of x.  The other arguments are
// fsc_jacobi3_sweep_pair's.
extern "C" int fsc_jacobi3_slab_pair(const float* x, const void* rhs,
                                     float* out, int side, int b, float alpha,
                                     float beta, float ab, int flags, int lo,
                                     int hi, int planes, int gtop, int gbot,
                                     int rhs_bf16, int rows, int walk,
                                     void* stream) {
  const auto launch = rhs_bf16 ? pair_launch<fsc::bf16> : pair_launch<float>;
  return launch(x, rhs, out, side, b, alpha, beta, ab, flags, lo, hi, planes,
                gtop, gbot, rows, walk, static_cast<cudaStream_t>(stream));
}
