// K6's exact volume gather on the body in float32, every design
// (variants.cuh).
#include "variants.cuh"

using VolumeFn = decltype(&volume_variant<1, 1, false, false, float>);
static const VolumeFn kTable[3][3][2][2] = FSC_TABLE(volume_variant, float);

extern "C" int fsc_advect3_volume_variant(
    const void* d1, const void* d2, const void* d3, const void* u,
    const void* v, const void* w, void* o1, void* o2, void* o3, int side,
    int b1, int b2, int b3, float dt0, int cmax, void* stream, int brick,
    int vec, int pair, int ldg) {
  if (slot(brick) < 0 || slot(vec) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return kTable[slot(brick)][slot(vec)][pair != 0][ldg != 0](
      d1, d2, d3, u, v, w, o1, o2, o3, side, b1, b2, b3, dt0, cmax, stream);
}
