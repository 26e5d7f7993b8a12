// K6 advect3: semi-Lagrangian backtrace and trilinear gather of one to
// three fields that share the backtrace.
//
// Replaces the TPU kernels _advect3_kernel (pallas_call at
// fluidsimulationcuda_tpu/kernels/pallas_ops_3d.py:728; advect3_shift_fused
// :1001) and _advect3_flat_kernel (pallas_call at :971; advect3_shift
// :992).  The TPU has no fast dynamic gather, so it decomposed the gather
// into (2C+1)^3 masked shifts over a VMEM window of z planes, each
// departure coordinate clamped to C = cmax cells around its cell.  Hopper
// gathers directly, so the window costs nothing here: with cmax <= 0 this
// kernel is the exact gather of ops/three_d.py advect3 at any
// displacement; with cmax >= 1 it clamps each coordinate as the TPU kernel
// does (fsc_common.cuh window_coord, which K3, K4, K12 and K14 share),
// which is ops/three_d.py advect3_windowed.  The two agree while the
// displacement stays at or below cmax on every axis.  The windowed form is
// its own instantiation, so the exact gather compiles without it.
//
// Bound: not HBM (5 field passes for one field, 6 for the self-advected
// (u, v, w) triple, whose fields are the velocities) but the latency of
// its loads: a cell issues 3 velocity loads and 8 corner loads per field,
// 27 for the triple, almost all L1 or L2 hits.
//
// A block covers a brick of 32 x 8 cells over kBrickZ = 2 planes: each
// thread first finds both its departures (six velocity loads in flight),
// then gathers each field for both planes (sixteen corner loads in
// flight).  Two planes read each other's gather planes through the same
// L1, and a thread has twice the independent loads of one plane per
// thread.  Measured on the H100 (PERF.md), this is at least as fast as one
// plane per thread on every input timed and up to 18% faster; three or
// four planes are faster on random velocities but slower on smooth ones,
// the flows the steps run.  Staging the brick's footprint in shared memory
// was measured too and was about twice as slow on every input: for a
// smooth flow L1 already holds each footprint value for all the gathers
// that read it, and for a random one the shared-memory reads meet as many
// bank conflicts as the direct loads meet cache lines, while the copies and
// barriers add their own time.  Outputs are fresh tensors, so the three
// self-advections all read the pre-advection velocity
// (stable_fluids_3d.py:118-119).
//
// The gather body of advect3_body.cuh, which K14 grouped and K6's bf16
// form run, did not replace this float32 kernel: no design of it was as
// fast on every flow timed (PERF.md §6; on the step's own states its 2 x 2
// cells a thread were 8-11% faster, on random velocities 8% slower).
//
// The bf16 form (fsc_advect3_bf16, on that body) reads bf16 fields and
// velocities, finds each departure and blends in float32, derives the
// ghost layer in float32 and rounds to bf16 at the store (ops/three_d.py
// advect3 on bf16 fields): bf16 coordinates could not resolve a fraction
// of a cell at these sides.
#include "advect3_body.cuh"

namespace {

constexpr int kBrickZ = 2;

template <bool kWindowed>
__global__ void advect3_kernel(const float* __restrict__ d1,
                               const float* __restrict__ d2,
                               const float* __restrict__ d3,
                               const float* __restrict__ u,
                               const float* __restrict__ v,
                               const float* __restrict__ w,
                               float* __restrict__ o1,
                               float* __restrict__ o2,
                               float* __restrict__ o3,
                               int side, int b1, int b2, int b3, float dt0,
                               int cmax) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int k0 = blockIdx.z * kBrickZ;
  if (i >= side || j >= side) return;
  const int n = side - 2;
  const int ci = fsc::clampi(i, 1, n);
  const int cj = fsc::clampi(j, 1, n);
  // Every plane's departure first, so that all their velocity loads are in
  // flight together.
  fsc::Departure3 d[kBrickZ] = {};
#pragma unroll
  for (int z = 0; z < kBrickZ; ++z) {
    const int ck = fsc::clampi(k0 + z, 1, n);
    d[z] = kWindowed
               ? fsc::window_backtrace3(u, v, w, ck, ci, cj, side, dt0, cmax)
               : fsc::backtrace3(u, v, w, ck, ci, cj, side, dt0);
  }
  // Then each field's gathers over the brick.
  auto gather = [&](const float* __restrict__ f, float* __restrict__ o,
                    int bb) {
#pragma unroll
    for (int z = 0; z < kBrickZ; ++z) {
      const int k = k0 + z;
      if (k < side)
        fsc::store(o, (k * side + i) * side + j,
                   fsc::border_value3(fsc::trilinear(d[z], f, side), k, i, j,
                                      side, bb));
    }
  };
  gather(d1, o1, b1);
  if (d2 != nullptr) gather(d2, o2, b2);
  if (d3 != nullptr) gather(d3, o3, b3);
}

int launch(const float* d1, const float* d2, const float* d3,
           const float* u, const float* v, const float* w, float* o1,
           float* o2, float* o3,
           int side, int b1, int b2, int b3, float dt0, int cmax,
           void* stream) {
  const auto kernel =
      cmax > 0 ? advect3_kernel<true> : advect3_kernel<false>;
  const dim3 grid((side + fsc::kBlockX - 1) / fsc::kBlockX,
                  (side + fsc::kBlockY - 1) / fsc::kBlockY,
                  (side + kBrickZ - 1) / kBrickZ);
  kernel<<<grid, fsc::block_dim(), 0, static_cast<cudaStream_t>(stream)>>>(
      d1, d2, d3, u, v, w, o1, o2, o3, side, b1, b2, b3, dt0, cmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d2/o2 and d3/o3 null advect fewer fields (d3 needs d2).  dt0 = dt*n in
// float32; cmax <= 0 gathers exactly, cmax >= 1 in the window of cmax
// cells.  Returns cudaGetLastError() after the launch.
extern "C" int fsc_advect3(const float* d1, const float* d2, const float* d3,
                           const float* u, const float* v, const float* w,
                           float* o1, float* o2, float* o3, int side, int b1,
                           int b2, int b3, float dt0, int cmax,
                           void* stream) {
  return launch(d1, d2, d3, u, v, w, o1, o2, o3, side, b1, b2, b3, dt0, cmax,
                stream);
}

// The bf16 form: every field, velocity and output bf16; the arguments of
// fsc_advect3.  It runs the gather body of advect3_body.cuh on the whole
// volume (one slab of side planes at plane 0, its wall planes 0 and
// side-1): bit for bit what advect3_kernel computed on bf16, with the
// thread's work chosen by measurement on the H100 (PERF.md §6,
// dev/bench_advect3_body.py): a brick of 2 planes and 2 cells a thread,
// the design that lost least to each flow's best on the flows the steps
// run, at most 12% (the triple at 256³ on the step's state after 4 steps
// 0.14948 ms, where the one-cell brick of 2 planes took 0.17168 and 2 x 4
// cells 0.14047, which lost 26% on the smooth flow).
namespace {

constexpr int kVolumeBrick = 2;
constexpr int kVolumeVec = 2;

template <bool kExact>
int volume_bf16(const void* d1, const void* d2, const void* d3,
                const void* u, const void* v, const void* w, void* o1,
                void* o2, void* o3, int side, int b1, int b2, int b3,
                float dt0, int cmax, void* stream) {
  return fsc::launch_volume<kExact, kVolumeBrick, kVolumeVec, fsc::bf16>(
      d1, d2, d3, u, v, w, o1, o2, o3, side, b1, b2, b3, dt0, cmax,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int fsc_advect3_bf16(const void* d1, const void* d2,
                                const void* d3, const void* u, const void* v,
                                const void* w, void* o1, void* o2, void* o3,
                                int side, int b1, int b2, int b3, float dt0,
                                int cmax, void* stream) {
  return (cmax > 0 ? volume_bf16<false> : volume_bf16<true>)(
      d1, d2, d3, u, v, w, o1, o2, o3, side, b1, b2, b3, dt0, cmax, stream);
}
