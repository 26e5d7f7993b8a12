// Every per-thread design of the grouped K11-block and K12-block
// (variants.cuh), for dev/bench_block_stencils.py: built beside a copy of
// the kernel sources, never into the port's library.
#include "variants.cuh"

namespace {

// The gradient of the design (width, shuffle, skip, min blocks), on the
// path's table.
template <typename T>
int grad_variant(const void* ptrs, const void* ints, int blocks, int m,
                 int k, int n, float h, int width, int shuffle, int skip,
                 int min_blocks, void* stream) {
  fsc::GradGroup g;
  if (!(h > 0.0f) || k % width != 0 ||
      !fsc::grad_table<T>(static_cast<const void* const*>(ptrs),
                          static_cast<const int*>(ints), blocks, m, k, n,
                          width, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define FSC_GRAD(V, SH, SK, MB)                                              \
  if (width == V && (shuffle != 0) == SH && (skip != 0) == SK &&             \
      min_blocks == MB)                                                      \
    return variants::launch_gradient_variant<V, SH, SK, MB, T>(              \
        g, blocks, m, k, n, h, s);
#define FSC_GRADS(V)               \
  FSC_GRAD(V, false, false, 1)     \
  FSC_GRAD(V, false, true, 1)      \
  FSC_GRAD(V, true, false, 1)      \
  FSC_GRAD(V, true, true, 1)       \
  FSC_GRAD(V, false, true, 8)
  FSC_GRAD(1, false, false, 1)
  FSC_GRAD(1, false, true, 1)
  FSC_GRADS(2)
  FSC_GRADS(4)
  if constexpr (sizeof(T) == 2) {
    FSC_GRADS(8)
  }
#undef FSC_GRADS
#undef FSC_GRAD
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gather of the design (width, pair, call, min blocks), windowed or
// exact.
template <typename T>
int gather_variant(const void* parts, const void* part_ints, int nparts,
                   const void* blks, const void* blk_ints, int nblocks,
                   int m, int k, int n, int py, int nf, int b1, int b2,
                   float dt0, int cmax, int width, int exact, int pair,
                   int call, int min_blocks, void* stream) {
  fsc::BlockGatherGroup g;
  if (k % width != 0 ||
      !fsc::gather_table<T>(static_cast<const void* const*>(parts),
                            static_cast<const int*>(part_ints), nparts,
                            static_cast<const void* const*>(blks),
                            static_cast<const int*>(blk_ints), nblocks, m, k,
                            n, py, nf, width, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
#define FSC_GATHER(E, V, P, C, MB)                                           \
  if ((exact != 0) == E && width == V && pair == P && (call != 0) == C &&    \
      min_blocks == MB)                                                      \
    return variants::launch_gather_variant<E, V, P, C, MB, T>(               \
        g, nblocks, n, nf, b1, b2, dt0, cmax, s);
#define FSC_WIDTH(E, V)          \
  FSC_GATHER(E, V, 0, false, 1)  \
  FSC_GATHER(E, V, 1, false, 1)  \
  FSC_GATHER(E, V, 2, false, 1)  \
  FSC_GATHER(E, V, 0, true, 1)   \
  FSC_GATHER(E, V, 2, true, 1)   \
  FSC_GATHER(E, V, 0, false, 6)  \
  FSC_GATHER(E, V, 0, false, 8)
#define FSC_GATHERS(E) \
  FSC_WIDTH(E, 1)      \
  FSC_WIDTH(E, 2)      \
  FSC_WIDTH(E, 4)
  FSC_GATHERS(false)
  FSC_GATHERS(true)
#undef FSC_GATHERS
#undef FSC_WIDTH
#undef FSC_GATHER
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int fsc_gradient_block_group_variant(
    const void* ptrs, const void* ints, int blocks, int m, int k, int n,
    float h, int width, int shuffle, int skip, int min_blocks,
    void* stream) {
  return grad_variant<float>(ptrs, ints, blocks, m, k, n, h, width, shuffle,
                             skip, min_blocks, stream);
}

extern "C" int fsc_gradient_block_group_variant_bf16(
    const void* ptrs, const void* ints, int blocks, int m, int k, int n,
    float h, int width, int shuffle, int skip, int min_blocks,
    void* stream) {
  return grad_variant<fsc::bf16>(ptrs, ints, blocks, m, k, n, h, width,
                                 shuffle, skip, min_blocks, stream);
}

extern "C" int fsc_advect_block_group_variant(
    const void* parts, const void* part_ints, int nparts, const void* blks,
    const void* blk_ints, int nblocks, int m, int k, int n, int py, int nf,
    int b1, int b2, float dt0, int cmax, int width, int exact, int pair,
    int call, int min_blocks, void* stream) {
  return gather_variant<float>(parts, part_ints, nparts, blks, blk_ints,
                               nblocks, m, k, n, py, nf, b1, b2, dt0, cmax,
                               width, exact, pair, call, min_blocks, stream);
}

extern "C" int fsc_advect_block_group_variant_bf16(
    const void* parts, const void* part_ints, int nparts, const void* blks,
    const void* blk_ints, int nblocks, int m, int k, int n, int py, int nf,
    int b1, int b2, float dt0, int cmax, int width, int exact, int pair,
    int call, int min_blocks, void* stream) {
  return gather_variant<fsc::bf16>(parts, part_ints, nparts, blks, blk_ints,
                                   nblocks, m, k, n, py, nf, b1, b2, dt0,
                                   cmax, width, exact, pair, call, min_blocks, stream);
}
