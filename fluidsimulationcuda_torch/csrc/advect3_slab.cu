// K14 advect3_slab: the semi-Lagrangian trilinear gather of one to three
// fields on a z-slab, windowed from plane-halo-extended copies of the
// fields, or exact from the assembled fields.
//
// Replaces the TPU kernel _advect3_flat_slab_kernel
// (fluidsimulationcuda_tpu/kernels/pallas_sharded_3d.py:483, pallas_call at
// :530; wrapper advect3_flat_slab :510).  The TPU kernel gathers one field
// per call by masked shifts over a VMEM window, which limits it to
// cmax <= 2 (advect3_slab_plan :465), and leaves the ghost layer raw for
// the step to derive (sharded3d.py:692-702).  Here each thread reads its
// eight points directly, at global plane plane0 + k, for up to three fields
// that share the backtrace (the (u, v, w) self-advection is one launch
// where the TPU step made three calls, sharded3d.py:731-733), and derives
// the full ghost layer in the same launch: a ghost row, column or wall
// plane takes its value from its interior neighbour's gather
// (fsc_common.cuh slab_border_value3).
//
// Windowed form (fsc_advect3_slab): the departure point is clamped per axis
// to [0.5, n+0.5] and then to [g - cmax, g + cmax] around the cell's own
// global coordinate (fsc_common.cuh window_coord), so the gather equals the
// exact one (K6) while the displacement stays at or below cmax and is
// clamped, not refused, above it.  The eight reads then lie within cmax+1
// planes of the cell's own plane: inside a halo of `halo` >= cmax+1 planes,
// which the wrapper checks.  Any cmax below the slab's plane count works.
//
// Exact form (fsc_advect3_slab_exact): the TPU step's exact all-gather
// advection, _advect3_local_exact
// (fluidsimulationcuda_tpu/parallel/sharded3d.py:288, jnp, no pallas_call;
// its Pallas z-slab route refuses "exact").  Each coordinate takes the
// global clamp alone (exact_coord, the expressions of K6's backtrace3), and
// the eight points are read from the whole assembled (side, side, side)
// field at their global planes: the buffer is the assembled field, its
// plane plane0 the slab's plane 0 (halo = plane0).  This is the form the
// z-slab step takes on slabs thinner than the window.  Each form is its own
// instantiation.
//
// Bound: device memory, as K6: u, v, w and eight gather points per field
// (neighbours of each other for a smooth flow, so mostly L1/L2 hits) and
// one write per field.
//
// The bf16 forms (fsc_advect3_slab_bf16, fsc_advect3_slab_exact_bf16) read
// bf16 fields and velocities (the exact form's fields the bf16 volumes the
// step assembles), find each departure and blend in float32, derive the
// ghost layer in float32 and round to bf16 at the store: K6's bf16 form
// (advect3.cu) on a slab.  bf16 coordinates could not resolve a fraction of
// a cell at these sides.
#include "advect3_body.cuh"

namespace {

template <bool kExact, typename T>
__global__ void advect3_slab_kernel(
    const T* __restrict__ d1, const T* __restrict__ d2,
    const T* __restrict__ d3, const T* __restrict__ u,
    const T* __restrict__ v, const T* __restrict__ w, T* __restrict__ o1,
    T* __restrict__ o2, T* __restrict__ o3, int side, int halo, int b1,
    int b2, int b3, float dt0, int plane0, int cmax, int gtop, int gbot) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int k = blockIdx.z;
  if (i >= side || j >= side) return;
  const int n = side - 2;
  const int ki = fsc::slab_row_of(k, gtop, gbot);
  const int ci = fsc::clampi(i, 1, n);
  const int cj = fsc::clampi(j, 1, n);
  const int c = (ki * side + ci) * side + cj;
  const int gk = plane0 + ki;
  const float uc = fsc::load(u, c);
  const float vc = fsc::load(v, c);
  const float wc = fsc::load(w, c);
  const fsc::Departure3 d =
      kExact ? fsc::departure3(fsc::exact_coord(cj, uc, n, dt0),
                               fsc::exact_coord(ci, vc, n, dt0),
                               fsc::exact_coord(gk, wc, n, dt0), side,
                               plane0 - halo)
             : fsc::departure3(fsc::window_coord(cj, uc, n, dt0, cmax),
                               fsc::window_coord(ci, vc, n, dt0, cmax),
                               fsc::window_coord(gk, wc, n, dt0, cmax),
                               side, plane0 - halo);
  const int o = (k * side + i) * side + j;
  fsc::store(o1, o,
             fsc::slab_border_value3(fsc::trilinear(d, d1, side), k, i, j,
                                     side, gtop, gbot, b1));
  if (d2 != nullptr)
    fsc::store(o2, o,
               fsc::slab_border_value3(fsc::trilinear(d, d2, side), k, i, j,
                                       side, gtop, gbot, b2));
  if (d3 != nullptr)
    fsc::store(o3, o,
               fsc::slab_border_value3(fsc::trilinear(d, d3, side), k, i, j,
                                       side, gtop, gbot, b3));
}

template <bool kExact, typename T>
int launch(const void* d1, const void* d2, const void* d3, const void* u,
           const void* v, const void* w, void* o1, void* o2, void* o3, int mz,
           int side, int halo, int b1, int b2, int b3, float dt0, int plane0,
           int cmax, int gtop, int gbot, void* stream) {
  const auto kernel = advect3_slab_kernel<kExact, T>;
  kernel<<<fsc::slab_grid_dim3(side, mz), fsc::block_dim(), 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(d1), static_cast<const T*>(d2),
      static_cast<const T*>(d3), static_cast<const T*>(u),
      static_cast<const T*>(v), static_cast<const T*>(w), static_cast<T*>(o1),
      static_cast<T*>(o2), static_cast<T*>(o3), side, halo, b1, b2, b3, dt0,
      plane0, cmax, gtop, gbot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d1..d3: (mz + 2*halo, side, side) extended fields, slab plane k at buffer
// plane halo + k; u, v, w, o1..o3: (mz, side, side).  d2/o2 and d3/o3 null
// gather fewer fields (d3 needs d2).  dt0 = dt*n in float32; plane0 is the
// slab's first global plane; gtop/gbot are slab planes (-1: absent).
// Returns cudaGetLastError() after the launch.
extern "C" int fsc_advect3_slab(const float* d1, const float* d2,
                                const float* d3, const float* u,
                                const float* v, const float* w, float* o1,
                                float* o2, float* o3, int mz, int side,
                                int halo, int b1, int b2, int b3, float dt0,
                                int plane0, int cmax, int gtop, int gbot,
                                void* stream) {
  return launch<false, float>(d1, d2, d3, u, v, w, o1, o2, o3, mz, side, halo,
                              b1, b2, b3, dt0, plane0, cmax, gtop, gbot,
                              stream);
}

// d1..d3: the assembled (side, side, side) fields, slab plane k at plane
// plane0 + k; the rest as fsc_advect3_slab's.
extern "C" int fsc_advect3_slab_exact(const float* d1, const float* d2,
                                      const float* d3, const float* u,
                                      const float* v, const float* w,
                                      float* o1, float* o2, float* o3, int mz,
                                      int side, int b1, int b2, int b3,
                                      float dt0, int plane0, int gtop,
                                      int gbot, void* stream) {
  return launch<true, float>(d1, d2, d3, u, v, w, o1, o2, o3, mz, side,
                             plane0, b1, b2, b3, dt0, plane0, 0, gtop, gbot,
                             stream);
}

// The bf16 forms: every field, velocity and output bf16; the arguments of
// fsc_advect3_slab and fsc_advect3_slab_exact.
extern "C" int fsc_advect3_slab_bf16(const void* d1, const void* d2,
                                     const void* d3, const void* u,
                                     const void* v, const void* w, void* o1,
                                     void* o2, void* o3, int mz, int side,
                                     int halo, int b1, int b2, int b3,
                                     float dt0, int plane0, int cmax,
                                     int gtop, int gbot, void* stream) {
  return launch<false, fsc::bf16>(d1, d2, d3, u, v, w, o1, o2, o3, mz, side,
                                  halo, b1, b2, b3, dt0, plane0, cmax, gtop,
                                  gbot, stream);
}

extern "C" int fsc_advect3_slab_exact_bf16(const void* d1, const void* d2,
                                           const void* d3, const void* u,
                                           const void* v, const void* w,
                                           void* o1, void* o2, void* o3,
                                           int mz, int side, int b1, int b2,
                                           int b3, float dt0, int plane0,
                                           int gtop, int gbot, void* stream) {
  return launch<true, fsc::bf16>(d1, d2, d3, u, v, w, o1, o2, o3, mz, side,
                                 plane0, b1, b2, b3, dt0, plane0, 0, gtop,
                                 gbot, stream);
}

// ---------------------------------------------------------------------------
// K14 grouped: one launch over every slab of a device
// ---------------------------------------------------------------------------
//
// The gather of every listed slab of the volume in one launch, on the body
// of advect3_body.cuh: a corner at global plane g is read from the array of
// the slab that owns g (GroupSources), the slab's own array where it lies
// on this device, or a copy of the planes the launch reads where it does
// not, so no extended slab (_ext) and no assembled volume (_gather) is
// built.  Each slab computes, bit for bit, what advect3_slab_kernel
// computes on _ext's or _gather's buffer: the same coordinates, window or
// global clamp, blend order and ghost layer.  It replaces the per-slab
// launches on every path; they stay as the form it is held to.
//
// The thread's work, chosen by measurement on the H100 (PERF.md §6,
// dev/bench_advect3_body.py; advect3_body.cuh says what was timed): in
// float32 a brick of 2 planes and 2 cells a thread, the fastest on every
// flow the steps run (0.18206 ms for the triple over the 8 slabs of 256³
// on the step's state after 4 steps, against 0.18815 for 1 x 2 and
// 0.22688 for 1 x 4); in bf16 one plane and 4 cells a thread (0.18416
// against 0.19675 for 2 x 2; its density 0.11432 against 0.12487), within
// 5% of the best on the smooth flow too.  Rows of a side the width does
// not divide take one cell a thread.
namespace {

template <typename T>
constexpr int kGroupBrick = sizeof(T) == 2 ? 1 : 2;
template <typename T>
constexpr int kGroupVec = sizeof(T) == 2 ? 4 : 2;

template <bool kExact, typename T>
int group(const void* const* srcs, const int* starts, int nsrc,
          const void* const* slabs, const int* walls, int nslab, int mz,
          int side, int nf, int b1, int b2, int b3, float dt0, int cmax,
          void* stream) {
  return fsc::launch_group<kExact, kGroupBrick<T>, kGroupVec<T>, T>(
      srcs, starts, nsrc, slabs, walls, nslab, mz, side, nf, b1, b2, b3, dt0,
      cmax, static_cast<cudaStream_t>(stream));
}

}  // namespace

// The windowed gather of nf (1-3) fields over nslab (at most
// fsc::kGatherSlabs) slabs of mz planes in one launch.  srcs holds 3
// pointers a slab of the volume (nsrc of them, at most
// fsc::kGatherSources): each field's array for that slab (its own, or a
// copy of some of its planes on this device; null where the launch reads
// none of its planes), starts the global plane of each array's first
// plane.  slabs holds 6 pointers a slab written: u, v, w, o1, o2, o3 (null
// outputs past nf); walls 3 ints a slab: its first global plane and its
// wall planes gtop, gbot (slab planes, -1: absent).  dt0 = dt*n in
// float32; the departures are clamped to cmax cells, which the arrays must
// cover.  No output aliases an input.  Returns cudaErrorInvalidValue for a
// count out of range, otherwise cudaGetLastError() after the launch.
extern "C" int fsc_advect3_group(const void* const* srcs, const int* starts,
                                 int nsrc, const void* const* slabs,
                                 const int* walls, int nslab, int mz,
                                 int side, int nf, int b1, int b2, int b3,
                                 float dt0, int cmax, void* stream) {
  return group<false, float>(srcs, starts, nsrc, slabs, walls, nslab, mz,
                             side, nf, b1, b2, b3, dt0, cmax, stream);
}

// The exact form: every coordinate takes the global clamp alone, so the
// arrays must hold every plane of the volume (cmax is not read).
extern "C" int fsc_advect3_group_exact(const void* const* srcs,
                                       const int* starts, int nsrc,
                                       const void* const* slabs,
                                       const int* walls, int nslab, int mz,
                                       int side, int nf, int b1, int b2,
                                       int b3, float dt0, int cmax,
                                       void* stream) {
  return group<true, float>(srcs, starts, nsrc, slabs, walls, nslab, mz,
                            side, nf, b1, b2, b3, dt0, cmax, stream);
}

// The bf16 forms: every field, velocity and output bf16, gathered in
// float32 and rounded at the store; the arguments of the float32 forms.
extern "C" int fsc_advect3_group_bf16(const void* const* srcs,
                                      const int* starts, int nsrc,
                                      const void* const* slabs,
                                      const int* walls, int nslab, int mz,
                                      int side, int nf, int b1, int b2,
                                      int b3, float dt0, int cmax,
                                      void* stream) {
  return group<false, fsc::bf16>(srcs, starts, nsrc, slabs, walls, nslab, mz,
                                 side, nf, b1, b2, b3, dt0, cmax, stream);
}

extern "C" int fsc_advect3_group_exact_bf16(const void* const* srcs,
                                            const int* starts, int nsrc,
                                            const void* const* slabs,
                                            const int* walls, int nslab,
                                            int mz, int side, int nf, int b1,
                                            int b2, int b3, float dt0,
                                            int cmax, void* stream) {
  return group<true, fsc::bf16>(srcs, starts, nsrc, slabs, walls, nslab, mz,
                                side, nf, b1, b2, b3, dt0, cmax, stream);
}
