// The grouped windowed K14 in float32, every design (variants.cuh).
#include "variants.cuh"

using GroupFn = decltype(&group_variant<1, 1, false, false, float>);
static const GroupFn kTable[3][3][2][2] = FSC_TABLE(group_variant, float);

extern "C" int fsc_advect3_group_variant(
    const void* const* srcs, const int* starts, int nsrc,
    const void* const* slabs, const int* walls, int nslab, int mz, int side,
    int nf, int b1, int b2, int b3, float dt0, int cmax, void* stream,
    int brick, int vec, int pair, int ldg) {
  if (slot(brick) < 0 || slot(vec) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return kTable[slot(brick)][slot(vec)][pair != 0][ldg != 0](
      srcs, starts, nsrc, slabs, walls, nslab, mz, side, nf, b1, b2, b3, dt0,
      cmax, stream);
}
