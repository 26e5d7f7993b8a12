// The 3-D semi-Lagrangian gather's device body, shared by K14 grouped
// (advect3_slab.cu: one launch over every z-slab of a device) and K6's
// bf16 form (advect3.cu: the whole volume as one slab).
//
// A thread takes kVec consecutive cells of a row (x) on kBrick planes (z)
// of one slab.  It first finds every departure of its cells, so that all
// their velocity loads are in flight together (one vector of kVec cells a
// velocity and plane where kVec > 1), then gathers each field at those
// departures and stores kVec cells a plane as one vector.  The
// coordinates, the trilinear blend and the ghost layer are those of
// fsc_common.cuh (window_coord or exact_coord, departure3, trilinear,
// slab_border_value3), expression for expression: the body computes what
// the per-slab K14 (advect3_slab_kernel) and K6 (advect3_kernel) compute,
// bit for bit.  Every field and velocity load takes the read-only path
// (__ldg), which the table's pointers, unlike a kernel's __restrict__
// parameters, do not let nvcc prove by itself.  The field loop is unrolled
// over its three slots: indexed at run time, the output and border-mode
// arrays went to a 40-64-byte stack frame, which cost the first measured
// form 10-30%.
//
// Measured on the H100 (PERF.md §6, dev/bench_advect3_body.py, which
// builds the variants of dev/advect3_variants/): bricks of 1, 2 and 4
// planes times 1, 2 and 4 cells a thread, each corner row's x-pair as one
// wide load where aligned or as two, the read-only path or not, at 256³ on
// random, smooth and shear velocities and on the step's own state after 4
// and 301 steps.  The wide x-pair lost on every flow but random
// velocities (its alignment branch splits the warp; 4-14% slower), the
// read-only path changed nothing measurable, and each form keeps the
// brick and width that lost least to each flow's best on the four
// realistic flows (random velocities of up to 6 cells favour bricks of 4
// planes of one cell, up to 1.6x faster there, and lose 10-30% on the
// others).
//
// Where the body reads a gathered field: a Sources class maps a global
// plane g to the array that holds it and its element offset there.
// VolumeSources (K6) holds the whole volume, plane g at g*side*side.
// GroupSources (K14 grouped) holds a table of the volume's slabs as this
// device sees them: slab s owns global planes [s*mz, (s+1)*mz), and its
// entry points at the slab's own array or, for a slab on another device,
// at a copy of the planes the launch reads (start: the global plane of the
// copy's first), so no extended slab and no assembled volume is built.
#pragma once

#include "fsc_common.cuh"

namespace fsc {

// The most slabs one grouped launch writes, and the most slabs of the
// volume its table can hold.  The table is passed by value in the
// kernel's parameters (32 bytes a source, 64 a slab: 16.4 KB, under the
// 32,764 bytes CUDA 12.1 takes on sm_70 and later), so a CUDA graph
// captures it with the launch.
constexpr int kGatherSlabs = 128;
constexpr int kGatherSources = 256;

// A global plane's array (src) and the element offset of its plane 0.
struct PlaneRef {
  int src;
  int off;
};

struct GatherSource {
  const void* f[3];  // each gathered field's planes, global plane start first
  int start;
};

struct GatherSlab {
  const void* u;
  const void* v;
  const void* w;
  void* o[3];
  int plane0, gtop, gbot;  // first global plane; wall planes (-1: none)
};

struct GatherGroup {
  GatherSource src[kGatherSources];
  GatherSlab slab[kGatherSlabs];
  int mz;  // planes of every slab
};

struct VolumeSources {
  const void* f[3];
  __device__ __forceinline__ PlaneRef plane(int g, int plane) const {
    return PlaneRef{0, g * plane};
  }
  __device__ __forceinline__ const void* field(int fi, int) const {
    return f[fi];
  }
};

struct GroupSources {
  const GatherGroup& g;
  __device__ __forceinline__ PlaneRef plane(int k, int plane) const {
    const int s = k / g.mz;
    return PlaneRef{s, (k - g.src[s].start) * plane};
  }
  __device__ __forceinline__ const void* field(int fi, int s) const {
    return g.src[s].f[fi];
  }
};

// A cell's departure: the arrays and offsets of its two gather planes'
// lower corners, and the trilinear weights of the upper corners.
struct GatherDeparture {
  int s0, off0, s1, off1;
  float fx, fy, fz;
};

// The blend of fsc::trilinear, in its order, from the two planes' lower
// corners g0 and g1.
template <typename T>
__device__ __forceinline__ float blend3(const GatherDeparture& d,
                                        const T* g0, const T* g1, int side) {
  const float a0 = ldg(g0, 0), a1 = ldg(g0, 1);
  const float b0 = ldg(g0, side), b1 = ldg(g0, side + 1);
  const float c0 = ldg(g1, 0), c1 = ldg(g1, 1);
  const float e0 = ldg(g1, side), e1 = ldg(g1, side + 1);
  const float gx = 1.0f - d.fx;
  const float gy = 1.0f - d.fy;
  const float gz = 1.0f - d.fz;
  return gz * (gy * (gx * a0 + d.fx * a1) + d.fy * (gx * b0 + d.fx * b1)) +
         d.fz * (gy * (gx * c0 + d.fx * c1) + d.fy * (gx * e0 + d.fx * e1));
}

// The gather of `nf` fields (border modes b[]) over planes
// [brick*kBrick, brick*kBrick + kBrick) of an mz-plane slab whose first
// global plane is plane0, by the slab's velocities u, v, w, into o[]: the
// windowed clamp of cmax cells, or the global clamp alone (kExact).  j0
// must be a multiple of kVec, and side too where kVec > 1.
template <bool kExact, int kBrick, int kVec, typename T, class Src>
__device__ __forceinline__ void gather3_body(
    const Src& src, const T* u, const T* v, const T* w, T* const* o,
    const int* b, int nf, int side, int mz, int plane0, int gtop, int gbot,
    float dt0, int cmax, int brick) {
  const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= side || j0 >= side) return;
  const int n = side - 2;
  const int plane = side * side;
  const int ci = clampi(i, 1, n);
  const int k0 = brick * kBrick;
  GatherDeparture d[kBrick][kVec];
#pragma unroll
  for (int z = 0; z < kBrick; ++z) {
    const int ki = slab_row_of(k0 + z < mz ? k0 + z : mz - 1, gtop, gbot);
    const int gk = plane0 + ki;
    const int row = (ki * side + ci) * side;
    float uv[kVec], vv[kVec], wv[kVec];
    if constexpr (kVec == 1) {
      const int c = row + clampi(j0, 1, n);
      uv[0] = ldg(u, c);
      vv[0] = ldg(v, c);
      wv[0] = ldg(w, c);
    } else {
      load_vec<kVec>(u, row + j0, uv);
      load_vec<kVec>(v, row + j0, vv);
      load_vec<kVec>(w, row + j0, wv);
    }
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const int s = kVec == 1 ? 0 : ghost_shift<kVec>(q, j0, side);
      const int cj = clampi(j0 + q, 1, n);
      const float uc = kVec == 1 ? uv[0] : shifted(uv, q, s);
      const float vc = kVec == 1 ? vv[0] : shifted(vv, q, s);
      const float wc = kVec == 1 ? wv[0] : shifted(wv, q, s);
      const float x = kExact ? exact_coord(cj, uc, n, dt0)
                             : window_coord(cj, uc, n, dt0, cmax);
      const float y = kExact ? exact_coord(ci, vc, n, dt0)
                             : window_coord(ci, vc, n, dt0, cmax);
      const float zc = kExact ? exact_coord(gk, wc, n, dt0)
                              : window_coord(gk, wc, n, dt0, cmax);
      // departure3's truncation, its base split at the plane.
      const int ix = static_cast<int>(x);
      const int iy = static_cast<int>(y);
      const int iz = static_cast<int>(zc);
      const PlaneRef p0 = src.plane(iz, plane);
      const PlaneRef p1 = src.plane(iz + 1, plane);
      GatherDeparture& e = d[z][q];
      e.s0 = p0.src;
      e.off0 = p0.off + iy * side + ix;
      e.s1 = p1.src;
      e.off1 = p1.off + iy * side + ix;
      e.fx = x - static_cast<float>(ix);
      e.fy = y - static_cast<float>(iy);
      e.fz = zc - static_cast<float>(iz);
    }
  }
  // Unrolled over the three field slots, so that o, b and the sources'
  // field pointers are indexed by constants (registers and the parameter
  // bank, never a local array).
#pragma unroll
  for (int fi = 0; fi < 3; ++fi) {
    if (fi >= nf) break;
#pragma unroll
    for (int z = 0; z < kBrick; ++z) {
      const int k = k0 + z;
      if (k >= mz) break;
      float out[kVec];
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        const GatherDeparture& e = d[z][q];
        const T* f0 = static_cast<const T*>(src.field(fi, e.s0));
        const T* f1 = static_cast<const T*>(src.field(fi, e.s1));
        out[q] = slab_border_value3(
            blend3(e, f0 + e.off0, f1 + e.off1, side), k, i,
            j0 + q, side, gtop, gbot, b[fi]);
      }
      const int at = (k * side + i) * side + j0;
      if constexpr (kVec == 1) {
        store(o[fi], at, out[0]);
      } else {
        store_vec<kVec>(o[fi], at, out);
      }
    }
  }
}

// K14 grouped: slab blockIdx.z / bricks of the group, brick blockIdx.z %
// bricks of its ceil(mz / kBrick).
template <bool kExact, int kBrick, int kVec, typename T>
__global__ void advect3_group_kernel(const __grid_constant__ GatherGroup g,
                                     int side, int nf, int b1, int b2, int b3,
                                     float dt0, int cmax, int bricks) {
  const GatherSlab& s = g.slab[blockIdx.z / bricks];
  T* const o[3] = {static_cast<T*>(s.o[0]), static_cast<T*>(s.o[1]),
                   static_cast<T*>(s.o[2])};
  const int b[3] = {b1, b2, b3};
  gather3_body<kExact, kBrick, kVec>(
      GroupSources{g}, static_cast<const T*>(s.u),
      static_cast<const T*>(s.v), static_cast<const T*>(s.w), o, b, nf, side,
      g.mz, s.plane0, s.gtop, s.gbot, dt0, cmax, blockIdx.z % bricks);
}

// K6 on the body: the whole (side, side, side) volume as one slab of side
// planes at plane 0, its wall planes 0 and side-1.
template <bool kExact, int kBrick, int kVec, typename T>
__global__ void advect3_volume_kernel(VolumeSources src,
                                      const T* __restrict__ u,
                                      const T* __restrict__ v,
                                      const T* __restrict__ w, T* o1, T* o2,
                                      T* o3, int side, int nf, int b1, int b2,
                                      int b3, float dt0, int cmax) {
  T* const o[3] = {o1, o2, o3};
  const int b[3] = {b1, b2, b3};
  gather3_body<kExact, kBrick, kVec>(
      src, u, v, w, o, b, nf, side, side, 0, 0, side - 1, dt0, cmax,
      blockIdx.z);
}

// The launch grid of a body over `slabs` slabs of mz planes.
template <int kBrick, int kVec>
inline dim3 gather3_grid(int side, int mz, int slabs) {
  return dim3((side + kBlockX * kVec - 1) / (kBlockX * kVec),
              (side + kBlockY - 1) / kBlockY,
              slabs * ((mz + kBrick - 1) / kBrick));
}

// Whether a velocity or output array of T at p takes kVec-cell vectors on
// rows of `side` cells.
template <int kVec, typename T>
inline bool takes_vec(int side, const void* p) {
  return side % kVec == 0 &&
         (p == nullptr ||
          reinterpret_cast<size_t>(p) % (kVec * sizeof(T)) == 0);
}

// One grouped launch: the group's table built from the host's arrays
// (fsc_advect3_group's), checked, launched with a brick of kBrick planes
// and kVec cells a thread where every slab's velocities and outputs take
// kVec-cell vectors, one cell a thread otherwise.
template <bool kExact, int kBrick, int kVec, typename T>
int launch_group(const void* const* srcs, const int* starts, int nsrc,
                 const void* const* slabs, const int* walls, int nslab,
                 int mz, int side, int nf, int b1, int b2, int b3, float dt0,
                 int cmax, cudaStream_t stream) {
  if (nsrc < 1 || nsrc > kGatherSources || nslab < 1 ||
      nslab > kGatherSlabs || nf < 1 || nf > 3 || mz < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  GatherGroup g;
  g.mz = mz;
  for (int s = 0; s < nsrc; ++s) {
    for (int f = 0; f < 3; ++f) g.src[s].f[f] = srcs[3 * s + f];
    g.src[s].start = starts[s];
  }
  bool vec = kVec > 1;
  for (int s = 0; s < nslab; ++s) {
    const void* const* q = slabs + 6 * s;
    GatherSlab& e = g.slab[s];
    e.u = q[0];
    e.v = q[1];
    e.w = q[2];
    for (int f = 0; f < 3; ++f) e.o[f] = const_cast<void*>(q[3 + f]);
    e.plane0 = walls[3 * s];
    e.gtop = walls[3 * s + 1];
    e.gbot = walls[3 * s + 2];
    for (int p = 0; p < 6; ++p) vec = vec && takes_vec<kVec, T>(side, q[p]);
  }
  const int bricks = (mz + kBrick - 1) / kBrick;
  const auto kernel =
      vec ? advect3_group_kernel<kExact, kBrick, kVec, T>
          : advect3_group_kernel<kExact, kBrick, 1, T>;
  const dim3 grid = vec ? gather3_grid<kBrick, kVec>(side, mz, nslab)
                        : gather3_grid<kBrick, 1>(side, mz, nslab);
  kernel<<<grid, block_dim(), 0, stream>>>(g, side, nf, b1, b2, b3, dt0,
                                           cmax, bricks);
  return static_cast<int>(cudaGetLastError());
}

// One K6 launch on the body, kVec cells a thread where the volume's
// velocities and outputs take kVec-cell vectors, one cell otherwise.
template <bool kExact, int kBrick, int kVec, typename T>
int launch_volume(const void* d1, const void* d2, const void* d3,
                  const void* u, const void* v, const void* w, void* o1,
                  void* o2, void* o3, int side, int b1, int b2, int b3,
                  float dt0, int cmax, cudaStream_t stream) {
  const int nf = d2 == nullptr ? 1 : (d3 == nullptr ? 2 : 3);
  const VolumeSources src{{d1, d2, d3}};
  const auto* uu = static_cast<const T*>(u);
  const auto* vv = static_cast<const T*>(v);
  const auto* ww = static_cast<const T*>(w);
  auto* p1 = static_cast<T*>(o1);
  auto* p2 = static_cast<T*>(o2);
  auto* p3 = static_cast<T*>(o3);
  const void* arrays[6] = {u, v, w, o1, o2, o3};
  bool vec = kVec > 1;
  for (const void* p : arrays) vec = vec && takes_vec<kVec, T>(side, p);
  const auto kernel =
      vec ? advect3_volume_kernel<kExact, kBrick, kVec, T>
          : advect3_volume_kernel<kExact, kBrick, 1, T>;
  const dim3 grid = vec ? gather3_grid<kBrick, kVec>(side, side, 1)
                        : gather3_grid<kBrick, 1>(side, side, 1);
  kernel<<<grid, block_dim(), 0, stream>>>(src, uu, vv, ww, p1, p2, p3, side,
                                           nf, b1, b2, b3, dt0, cmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fsc
