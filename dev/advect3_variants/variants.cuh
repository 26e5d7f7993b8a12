// The per-thread designs of the 3-D gather body (csrc/advect3_body.cuh,
// measured as advect3_body_variants.cuh) that dev/bench_advect3_body.py
// times: every brick of 1, 2 and 4 planes,
// 1, 2 and 4 cells a thread along x, the x-pair of a corner row as one
// load or two, and the read-only path or the plain one.  Not built into the
// port's library: the bench builds these sources beside csrc/ and keeps
// what measured fastest there (PERF.md §6).  Each .cu of this directory
// instantiates one form (FORM: the grouped windowed K14 or K6's exact
// volume gather) in one storage type (T) and exports one entry point that
// takes the form's arguments and the design's (brick, vec, pair, ldg).
#pragma once

#include "advect3_body_variants.cuh"

namespace {

constexpr int slot(int k) { return k == 1 ? 0 : (k == 2 ? 1 : (k == 4 ? 2 : -1)); }

template <int B, int V, bool P, bool L, typename T>
int group_variant(const void* const* srcs, const int* starts, int nsrc,
                  const void* const* slabs, const int* walls, int nslab,
                  int mz, int side, int nf, int b1, int b2, int b3,
                  float dt0, int cmax, void* stream) {
  return fsc::variants::launch_group<false, B, V, P, L, T>(
      srcs, starts, nsrc, slabs, walls, nslab, mz, side, nf, b1, b2, b3, dt0,
      cmax, static_cast<cudaStream_t>(stream));
}

template <int B, int V, bool P, bool L, typename T>
int volume_variant(const void* d1, const void* d2, const void* d3,
                   const void* u, const void* v, const void* w, void* o1,
                   void* o2, void* o3, int side, int b1, int b2, int b3,
                   float dt0, int cmax, void* stream) {
  return fsc::variants::launch_volume<true, B, V, P, L, T>(
      d1, d2, d3, u, v, w, o1, o2, o3, side, b1, b2, b3, dt0, cmax,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

#define FSC_PL(F, B, V, T) \
  {{F<B, V, false, false, T>, F<B, V, false, true, T>}, \
   {F<B, V, true, false, T>, F<B, V, true, true, T>}}
#define FSC_BRICK(F, B, T) {FSC_PL(F, B, 1, T), FSC_PL(F, B, 2, T), FSC_PL(F, B, 4, T)}
#define FSC_TABLE(F, T) {FSC_BRICK(F, 1, T), FSC_BRICK(F, 2, T), FSC_BRICK(F, 4, T)}
