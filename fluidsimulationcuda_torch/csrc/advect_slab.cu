// K12 advect_slab: the semi-Lagrangian gather of one or two fields on a row
// slab, windowed from halo-extended copies of the fields, or exact from the
// assembled fields.
//
// Replaces the TPU kernel _advect_slab_kernel
// (fluidsimulationcuda_tpu/kernels/pallas_sharded.py:1055, pallas_call at
// :1246; wrapper advect_slab :1206), and is the gather of the slab density
// step _dens_slab_kernel (:815, pallas_call at :1010), which reads the
// diffused field straight from K9's swept buffer.  The TPU kernels gather
// by (2*cmax+1)^2 masked shifts over a VMEM window; here each thread reads
// its four points directly, at global row row0 + r.
//
// Windowed form (fsc_advect_slab): the departure point is clamped to
// [0.5, n+0.5] and then to [g - cmax, g + cmax] around the cell's own global
// coordinate (fsc_common.cuh: window_backtrace), so the gather equals the
// exact one (K3) while the displacement stays at or below cmax and is
// clamped, not refused, above it.  The four reads then lie within cmax+1
// rows of the cell's own row: inside a halo of `halo` >= cmax+1 rows, which
// the wrapper checks.
//
// Exact form (fsc_advect_slab_exact): the TPU step's exact all-gather
// advection, _advect_local (fluidsimulationcuda_tpu/parallel/sharded.py:245,
// jnp, no pallas_call; its Pallas slab route refuses "exact").  The
// departure point takes the global clamp alone, K3's backtrace_at at the
// cell's global row, and the four points are read from the whole assembled
// (side, side) field at their global rows: the buffer is the assembled
// field, its row row0 the slab's row 0 (halo = row0).  Any displacement is
// gathered as the single-device step gathers it.  The form is its own
// instantiation, so neither carries the other's clamp.
//
// A ghost column or wall ghost row takes its value from its interior
// neighbour's gather (fsc_common.cuh), in both forms.
//
// Bound: device memory, as K3: u, v and four gather points per field (L1/L2
// hits for a smooth flow) and one write per field.
//
// K12-block advect_block: both forms on an (m, k) block of the 2-D block
// route, at global row r0 + r and column c0 + j: the windowed form
// (fsc_advect_block) from the block extended by a halo of `halo` >= cmax+1
// cells on every side (_advect_local_windowed,
// fluidsimulationcuda_tpu/parallel/sharded.py:274, jnp, whose
// (2*cmax+1)^2 masked shifts read what one gather reads after the window
// clamp), the exact form (fsc_advect_block_exact) from the assembled
// field (_advect_local, :245).  u and v may be views with a row stride
// (the u/v pair gathers its own cells from its buffers).  A ghost cell of
// the grid in the block takes the border rule of its interior neighbour's
// gather, which lies in the block.  Both have bf16 forms
// (fsc_advect_block_bf16, fsc_advect_block_exact_bf16): bf16 fields,
// velocities and outputs, the backtrace coordinates and the blend float32
// (a grid index past 256 has no exact bf16 value; JAX's block route
// computes them in bf16 and loses the cell there, ROADMAP §C), each result
// rounded to bf16 at the store.
//
// K12-block grouped (fsc_advect_block_group, _exact, and their _bf16
// forms): both forms on every block of a device in one launch, the path
// of every cuda block step since the per-block launches above, which stay
// as the forms it is held against.  Each corner of a departure is read
// from the block that owns its global cell (row gi / m, column gj / k, at
// its local offset; a copy of the cells the launch reads where that block
// lies on another device), so no Blocks.ext and no Blocks.gather is
// built; the kernel and its table are in block_group.cuh.
#include "block_group.cuh"
#include "fsc_common.cuh"

namespace {

template <bool kExact>
__global__ void advect_slab_kernel(const float* __restrict__ d1,
                                   const float* __restrict__ d2,
                                   const float* __restrict__ u,
                                   const float* __restrict__ v,
                                   float* __restrict__ o1,
                                   float* __restrict__ o2, int m, int side,
                                   int halo, int b1, int b2, float dt0,
                                   int row0, int cmax, int gtop, int gbot) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= m || j >= side) return;
  const int n = side - 2;
  const int ri = fsc::slab_row_of(r, gtop, gbot);
  const int cj = fsc::clampi(j, 1, n);
  const int c = ri * side + cj;
  const fsc::Departure d =
      kExact ? fsc::backtrace_at(u[c], v[c], row0 + ri, cj, side, dt0)
             : fsc::window_backtrace(u[c], v[c], row0 + ri, cj, n, dt0,
                                     cmax);
  const int g = (d.i0 - row0 + halo) * side + d.j0;
  const float a = fsc::blend(d, d1[g], d1[g + side], d1[g + 1],
                             d1[g + side + 1]);
  o1[r * side + j] = fsc::slab_border_value(a, r, j, side, gtop, gbot, b1);
  if (d2 != nullptr) {
    const float e = fsc::blend(d, d2[g], d2[g + side], d2[g + 1],
                               d2[g + side + 1]);
    o2[r * side + j] = fsc::slab_border_value(e, r, j, side, gtop, gbot, b2);
  }
}

template <bool kExact>
int launch(const float* d1, const float* d2, const float* u, const float* v,
           float* o1, float* o2, int m, int side, int halo, int b1, int b2,
           float dt0, int row0, int cmax, int gtop, int gbot, void* stream) {
  const auto kernel = advect_slab_kernel<kExact>;
  kernel<<<fsc::slab_grid_dim(side, m), fsc::block_dim(), 0,
           static_cast<cudaStream_t>(stream)>>>(d1, d2, u, v, o1, o2, m, side,
                                                halo, b1, b2, dt0, row0, cmax,
                                                gtop, gbot);
  return static_cast<int>(cudaGetLastError());
}

// K12-block: the gather of one or two fields at the (m, k) block at global
// origin (r0, c0): from the assembled (n+2)^2 fields (kExact) or from the
// blocks extended by `halo` cells, window cmax.
template <bool kExact, typename T>
__global__ void advect_block_kernel(const T* __restrict__ d1,
                                    const T* __restrict__ d2,
                                    const T* __restrict__ u,
                                    const T* __restrict__ v, int ustride,
                                    T* __restrict__ o1, T* __restrict__ o2,
                                    int m, int k, int n, int r0, int c0,
                                    int halo, int cmax, int b1, int b2,
                                    float dt0) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= m || j >= k) return;
  // The interior cell the cell derives from, in global coordinates.
  const int gi = fsc::clampi(r0 + r, 1, n);
  const int gj = fsc::clampi(c0 + j, 1, n);
  const int c = (gi - r0) * ustride + (gj - c0);
  const float uc = fsc::load(u, c);
  const float vc = fsc::load(v, c);
  const fsc::Departure d =
      kExact ? fsc::backtrace_at(uc, vc, gi, gj, n + 2, dt0)
             : fsc::window_backtrace(uc, vc, gi, gj, n, dt0, cmax);
  const int width = kExact ? n + 2 : k + 2 * halo;
  const int g = kExact ? d.i0 * width + d.j0
                       : (d.i0 - r0 + halo) * width + (d.j0 - c0 + halo);
  const bool gx = c0 + j == 0 || c0 + j == n + 1;
  const bool gy = r0 + r == 0 || r0 + r == n + 1;
  const float a =
      fsc::blend(d, fsc::load(d1, g), fsc::load(d1, g + width),
                 fsc::load(d1, g + 1), fsc::load(d1, g + width + 1));
  fsc::store(o1, r * k + j, fsc::border_rule(a, gx, gy, b1));
  if (d2 != nullptr) {
    const float e =
        fsc::blend(d, fsc::load(d2, g), fsc::load(d2, g + width),
                   fsc::load(d2, g + 1), fsc::load(d2, g + width + 1));
    fsc::store(o2, r * k + j, fsc::border_rule(e, gx, gy, b2));
  }
}

template <bool kExact, typename T>
int launch_block(const void* d1, const void* d2, const void* u,
                 const void* v, int ustride, void* o1, void* o2, int m,
                 int k, int n, int r0, int c0, int halo, int cmax, int b1,
                 int b2, float dt0, void* stream) {
  if (m < 2 || k < 2 || r0 < 0 || c0 < 0 || r0 + m > n + 2 ||
      c0 + k > n + 2 || (!kExact && (cmax < 0 || halo < cmax + 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = advect_block_kernel<kExact, T>;
  kernel<<<fsc::slab_grid_dim(k, m), fsc::block_dim(), 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(d1), static_cast<const T*>(d2),
      static_cast<const T*>(u), static_cast<const T*>(v), ustride,
      static_cast<T*>(o1), static_cast<T*>(o2), m, k, n, r0, c0, halo, cmax,
      b1, b2, dt0);
  return static_cast<int>(cudaGetLastError());
}

// One grouped K12-block launch (fsc_advect_block_group's arguments) with
// every field, velocity and output stored as T, `width` cells a thread: 1,
// 2 or 4, and for the exact form in float32 1 or 2
// (advect_block_group_kernel's designs).
template <bool kExact, typename T>
int gather_group(const void* parts, const void* part_ints, int nparts,
                 const void* blks, const void* blk_ints, int nblocks, int m,
                 int k, int n, int py, int nf, int b1, int b2, float dt0,
                 int cmax, int width, void* stream) {
  constexpr bool kWide = !kExact || sizeof(T) == 2;
  fsc::BlockGatherGroup g;
  if (!(width == 1 || width == 2 || (kWide && width == 4)) ||
      k % width != 0 ||
      (!kExact && (cmax < 0 || cmax + 1 > m || cmax + 1 > k)) ||
      !fsc::gather_table<T>(static_cast<const void* const*>(parts),
                            static_cast<const int*>(part_ints), nparts,
                            static_cast<const void* const*>(blks),
                            static_cast<const int*>(blk_ints), nblocks, m, k,
                            n, py, nf, width, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if constexpr (kWide) {
    if (width == 4)
      return fsc::launch_gather_group<kExact, 4, T>(g, nblocks, n, nf, b1, b2,
                                                    dt0, cmax, s);
  }
  return width == 2 ? fsc::launch_gather_group<kExact, 2, T>(
                          g, nblocks, n, nf, b1, b2, dt0, cmax, s)
                    : fsc::launch_gather_group<kExact, 1, T>(
                          g, nblocks, n, nf, b1, b2, dt0, cmax, s);
}

}  // namespace

// d1, d2: (m + 2*halo, side) extended fields, slab row r at buffer row
// halo + r; u, v, o1, o2: (m, side).  d2/o2 null gathers one field.
// dt0 = dt*n in float32.  Returns cudaGetLastError() after the launch.
extern "C" int fsc_advect_slab(const float* d1, const float* d2,
                               const float* u, const float* v, float* o1,
                               float* o2, int m, int side, int halo, int b1,
                               int b2, float dt0, int row0, int cmax,
                               int gtop, int gbot, void* stream) {
  return launch<false>(d1, d2, u, v, o1, o2, m, side, halo, b1, b2, dt0,
                       row0, cmax, gtop, gbot, stream);
}

// d1, d2: the assembled (side, side) fields, slab row r at row row0 + r;
// u, v, o1, o2: (m, side).  d2/o2 null gathers one field.  dt0 = dt*n in
// float32.  Returns cudaGetLastError() after the launch.
extern "C" int fsc_advect_slab_exact(const float* d1, const float* d2,
                                     const float* u, const float* v,
                                     float* o1, float* o2, int m, int side,
                                     int b1, int b2, float dt0, int row0,
                                     int gtop, int gbot, void* stream) {
  return launch<true>(d1, d2, u, v, o1, o2, m, side, row0, b1, b2, dt0, row0,
                      0, gtop, gbot, stream);
}

// K12-block windowed: d1, d2 the (m + 2*halo, k + 2*halo) extended fields,
// block cell (r, c) at buffer cell (halo + r, halo + c); u, v the (m, k)
// velocities with row stride ustride; o1, o2: (m, k).  d2/o2 null gathers
// one field.  dt0 = dt*n in float32.  Returns cudaErrorInvalidValue for a
// block outside the grid or a halo under cmax+1, otherwise
// cudaGetLastError() after the launch.
extern "C" int fsc_advect_block(const float* d1, const float* d2,
                                const float* u, const float* v, int ustride,
                                float* o1, float* o2, int m, int k, int n,
                                int r0, int c0, int halo, int cmax, int b1,
                                int b2, float dt0, void* stream) {
  return launch_block<false, float>(d1, d2, u, v, ustride, o1, o2, m, k, n,
                                    r0, c0, halo, cmax, b1, b2, dt0, stream);
}

// K12-block windowed, bf16 form: d1, d2, u, v, o1 and o2 bf16, the rest as
// fsc_advect_block's.
extern "C" int fsc_advect_block_bf16(const void* d1, const void* d2,
                                     const void* u, const void* v,
                                     int ustride, void* o1, void* o2, int m,
                                     int k, int n, int r0, int c0, int halo,
                                     int cmax, int b1, int b2, float dt0,
                                     void* stream) {
  return launch_block<false, fsc::bf16>(d1, d2, u, v, ustride, o1, o2, m, k,
                                        n, r0, c0, halo, cmax, b1, b2, dt0,
                                        stream);
}

// K12-block exact: d1, d2 the assembled (n+2, n+2) fields; the rest as
// fsc_advect_block's.
extern "C" int fsc_advect_block_exact(const float* d1, const float* d2,
                                      const float* u, const float* v,
                                      int ustride, float* o1, float* o2,
                                      int m, int k, int n, int r0, int c0,
                                      int b1, int b2, float dt0,
                                      void* stream) {
  return launch_block<true, float>(d1, d2, u, v, ustride, o1, o2, m, k, n,
                                   r0, c0, 0, 0, b1, b2, dt0, stream);
}

// K12-block exact, bf16 form: d1, d2, u, v, o1 and o2 bf16, the rest as
// fsc_advect_block_exact's.
extern "C" int fsc_advect_block_exact_bf16(const void* d1, const void* d2,
                                           const void* u, const void* v,
                                           int ustride, void* o1, void* o2,
                                           int m, int k, int n, int r0,
                                           int c0, int b1, int b2, float dt0,
                                           void* stream) {
  return launch_block<true, fsc::bf16>(d1, d2, u, v, ustride, o1, o2, m, k,
                                       n, r0, c0, 0, 0, b1, b2, dt0, stream);
}

// K12-block grouped: the gather of nf (1 or 2) fields at `nblocks` (m, k)
// blocks (at most kStencilBlocks) in one launch, windowed (cmax cells,
// cmax + 1 <= m, k).  parts holds the field's px * py blocks as the launch
// sees them, in mesh order (py of a row), nparts of them (at most
// kGatherParts): 2 pointers a part (each field's array, null where the
// launch reads none of its cells) and in part_ints 3 ints (the global row
// and column of the array's element 0, its row stride).  blks holds 4
// pointers a block (u, v, o1, o2; o2 null for one field) and blk_ints 2
// (r0, c0).  dt0 = dt*n in float32, `width` the cells a thread (1, 2, 4).
// Returns cudaErrorInvalidValue for a bad table, window, width or
// alignment, otherwise cudaGetLastError() after the launch.
extern "C" int fsc_advect_block_group(const void* parts,
                                      const void* part_ints, int nparts,
                                      const void* blks, const void* blk_ints,
                                      int nblocks, int m, int k, int n,
                                      int py, int nf, int b1, int b2,
                                      float dt0, int cmax, int width,
                                      void* stream) {
  return gather_group<false, float>(parts, part_ints, nparts, blks,
                                    blk_ints, nblocks, m, k, n, py, nf, b1,
                                    b2, dt0, cmax, width, stream);
}

// K12-block grouped, exact: the global clamp alone (cmax ignored), widths
// 1 and 2, the rest as fsc_advect_block_group's.
extern "C" int fsc_advect_block_group_exact(
    const void* parts, const void* part_ints, int nparts, const void* blks,
    const void* blk_ints, int nblocks, int m, int k, int n, int py, int nf,
    int b1, int b2, float dt0, int cmax, int width, void* stream) {
  return gather_group<true, float>(parts, part_ints, nparts, blks, blk_ints,
                                   nblocks, m, k, n, py, nf, b1, b2, dt0,
                                   cmax, width, stream);
}

// The bf16 forms: bf16 fields, velocities and outputs, widths 1, 2 and 4,
// the rest as fsc_advect_block_group's and fsc_advect_block_group_exact's.
extern "C" int fsc_advect_block_group_bf16(
    const void* parts, const void* part_ints, int nparts, const void* blks,
    const void* blk_ints, int nblocks, int m, int k, int n, int py, int nf,
    int b1, int b2, float dt0, int cmax, int width, void* stream) {
  return gather_group<false, fsc::bf16>(parts, part_ints, nparts, blks,
                                        blk_ints, nblocks, m, k, n, py, nf,
                                        b1, b2, dt0, cmax, width, stream);
}

extern "C" int fsc_advect_block_group_exact_bf16(
    const void* parts, const void* part_ints, int nparts, const void* blks,
    const void* blk_ints, int nblocks, int m, int k, int n, int py, int nf,
    int b1, int b2, float dt0, int cmax, int width, void* stream) {
  return gather_group<true, fsc::bf16>(parts, part_ints, nparts, blks,
                                       blk_ints, nblocks, m, k, n, py, nf,
                                       b1, b2, dt0, cmax, width, stream);
}
