#!/usr/bin/env python3
"""K4, K6, K14 and K17 of this tree against those of another tree (a parent
commit), on the card, on the same inputs in the same process.

    python3 dev/bench_gathers.py --parent build/parent [--only k14,k17]
                                 [--bricks 1,3,4]

Builds the kernel library of this tree and of ``--parent`` (a checkout
whose ``fluidsimulationcuda_torch/csrc`` has the same C entry points, e.g.
``git archive HEAD~`` unpacked into a gitignored directory; a parent whose
K17 predates its resident form is called through ``ParentTail``) and times
each timing check of ``kernels/checks.py`` for the chosen kernels with one
library and then the other, in turns parent, this tree, this tree, parent
(device ms of a call, CUDA graphs of 20 calls, ``checks.device_ms``):

- ``k4``: K4 alone on random, smooth and shear velocities and at 20 sweeps
  beside K1 20it + K3, at 2048² and on the datagen batch of 1024 grids of
  256² (window 1; the shear exact);
- ``k6``: K6's triple and one field at 256³ on random, smooth and shear
  velocities, exact and in the window;
- ``k14``: K14's triple and one field on an interior slab of 32 planes of
  256³ on random, smooth and shear velocities (4-cell window);
- ``k17``: K17 at 2048² (20 sweeps in windows of 4 and 1 cells, 14
  Chebyshev sweeps; the form the launch chooses, then the streaming form)
  and on the datagen batch of 1024 × 256², each beside the composition it
  replaces (K3's windowed pair and ``fused_project``, this tree's).

Prints both times, their ratio, the bound and, for K4, the share of blocks
that stage their footprint box; for K17 the form this tree's launch took.
``--bricks`` also times K14 built as K6 is, with a brick of each listed
number of z planes a thread (``K14_BRICK``, measured and not kept), between
this tree's turns (parent, this, variants, variants reversed, this,
parent).  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
GROUPS = ("k4", "k6", "k14", "k17")
# The C signature of K17 before it had a resident form.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LEGACY_TAIL = [_P] * 10 + [_I] * 4 + [_F] * 3 + [_P, _I, _P]


class ParentTail:
    """A parent tree's kernel library whose K17 predates the resident form,
    with K17's entry points as this tree's wrapper calls them: it reports
    the streaming form (the parent's only one) and drops the arguments the
    parent does not take.  Every other entry point is the library's."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        self._tail = lib.fsc_advect_project
        self._tail.argtypes = LEGACY_TAIL
        self._tail.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self._lib, name)

    @staticmethod
    def fsc_advect_project_form(side, nb, want, form, edge_floats):
        form._obj.value, edge_floats._obj.value = 1, 0
        return 0

    def fsc_advect_project(self, u, v, uo, vo, au, av, rhs, p0, p1, p2,
                           edges, side, nb, iters, cmax, dt0, coef, h,
                           omegas, cheby, form, stream):
        return self._tail(u, v, uo, vo, au, av, rhs, p0, p1, p2, side, nb,
                          iters, cmax, dt0, coef, h, omegas, cheby, stream)


def parent_library(csrc: Path):
    """The kernel library built from the tree at ``csrc``, through
    ``ParentTail`` where its K17 has no form to choose."""
    from fluidsimulationcuda_torch.kernels import build

    lib = build.open_library(build.build(csrc=csrc))
    return lib if hasattr(lib, "fsc_advect_project_form") else ParentTail(lib)


# K14 built as K6 is, with a brick of `planes` z planes a thread: every
# plane's departure first, then each field's gathers over the brick.  It
# replaces the kernel and launch of a copy of csrc/advect3_slab.cu (from
# its anonymous namespace on) for --bricks; measured on the H100 and not
# kept (PERF.md §6).
K14_BRICK = r"""namespace {

constexpr int kBrickZ = %(planes)d;

__global__ void advect3_slab_kernel(
    const float* __restrict__ d1, const float* __restrict__ d2,
    const float* __restrict__ d3, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ w,
    float* __restrict__ o1, float* __restrict__ o2, float* __restrict__ o3,
    int side, int mz, int halo, int b1, int b2, int b3, float dt0,
    int plane0, int cmax, int gtop, int gbot) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int k0 = blockIdx.z * kBrickZ;
  if (i >= side || j >= side) return;
  const int n = side - 2;
  const int ci = fsc::clampi(i, 1, n);
  const int cj = fsc::clampi(j, 1, n);
  fsc::Departure3 d[kBrickZ] = {};
#pragma unroll
  for (int z = 0; z < kBrickZ; ++z) {
    const int ki = fsc::slab_row_of(k0 + z < mz ? k0 + z : mz - 1, gtop,
                                    gbot);
    const int c = (ki * side + ci) * side + cj;
    d[z] = fsc::departure3(
        fsc::window_coord(cj, u[c], n, dt0, cmax),
        fsc::window_coord(ci, v[c], n, dt0, cmax),
        fsc::window_coord(plane0 + ki, w[c], n, dt0, cmax), side,
        plane0 - halo);
  }
  auto gather = [&](const float* __restrict__ f, float* __restrict__ o,
                    int bb) {
#pragma unroll
    for (int z = 0; z < kBrickZ; ++z) {
      const int k = k0 + z;
      if (k < mz)
        o[(k * side + i) * side + j] = fsc::slab_border_value3(
            fsc::trilinear(d[z], f, side), k, i, j, side, gtop, gbot, bb);
    }
  };
  gather(d1, o1, b1);
  if (d2 != nullptr) gather(d2, o2, b2);
  if (d3 != nullptr) gather(d3, o3, b3);
}

}  // namespace

extern "C" int fsc_advect3_slab(const float* d1, const float* d2,
                                const float* d3, const float* u,
                                const float* v, const float* w, float* o1,
                                float* o2, float* o3, int mz, int side,
                                int halo, int b1, int b2, int b3, float dt0,
                                int plane0, int cmax, int gtop, int gbot,
                                void* stream) {
  advect3_slab_kernel<<<fsc::slab_grid_dim3(side, (mz + kBrickZ - 1) /
                                                     kBrickZ),
                        fsc::block_dim(), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      d1, d2, d3, u, v, w, o1, o2, o3, side, mz, halo, b1, b2, b3, dt0,
      plane0, cmax, gtop, gbot);
  return static_cast<int>(cudaGetLastError());
}
"""


def brick_library(planes: int):
    """This tree's kernel library with K14 replaced by ``K14_BRICK`` of
    ``planes`` planes a thread (a copy of ``csrc`` under
    ``build/bricks/``)."""
    from fluidsimulationcuda_torch.kernels import build

    out = ROOT / "build" / "bricks" / str(planes) / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    src = out / "advect3_slab.cu"
    text = src.read_text()
    src.write_text(text[:text.index("namespace {")]
                   + K14_BRICK % {"planes": planes})
    return build.open_library(build.build(csrc=out))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--only", default=",".join(GROUPS),
                    help=f"comma-separated kernels of {GROUPS}")
    ap.add_argument("--bricks", default="",
                    help="comma-separated K14 plane counts to time too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_gathers: no CUDA device")
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    from fluidsimulationcuda_torch.kernels import build, checks
    from fluidsimulationcuda_torch.kernels import cuda_step as cst

    only = set(args.only.split(","))
    if not only <= set(GROUPS):
        raise SystemExit(f"bench_gathers: --only takes {GROUPS}")
    libs = {"parent": parent_library(
                args.parent / "fluidsimulationcuda_torch" / "csrc"),
            "this": build.load()}
    bricks = {f"kBrickZ={k}": brick_library(int(k))
              for k in args.bricks.split(",") if k}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(f"device ms per call, parent / this / this / parent ({card})")

    def of(kernels, check_list):
        return [c for c in check_list if set(c.kernels) & set(kernels)]

    k4, k6 = ("dens_advect",), ("advect3", "advect3_windowed")
    groups = []
    if "k4" in only:
        groups += [("K4 at 2048²", of(k4, checks.timing_checks(2048, "cuda"))),
                   ("K4 at 1024 × 256²", of(k4, checks.timing_checks_batched(
                       1024, 256, "cuda", 0, 1)))]
    if "k6" in only:
        groups.append(("K6 at 256³", of(k6, checks.timing_checks3(256, "cuda"))
                       + of(k6, checks.timing_checks3_windowed(256, "cuda"))))
    if "k14" in only:
        groups.append(("K14 at 256³, interior slab of 32 planes",
                       of(("advect3_slab",),
                          checks.timing_checks_slab3(256, 32, "cuda"))))
    if "k17" in only:
        groups += [("K17 at 2048²", checks.timing_checks_tail(2048, "cuda")),
                   ("K17 at 1024 × 256²", checks.timing_checks_tail_batched(
                       1024, 256, "cuda"))]
    for title, group in groups:
        print(f"  {title}:")
        for c in group:
            ms = {}
            # K14's brick variants between this tree's turns, in turn too.
            variants = list(bricks) if "advect3_slab" in c.kernels else []
            for tree in ("parent", "this", *variants, *variants[::-1],
                         "this", "parent"):
                build._lib = libs.get(tree) or bricks[tree]
                ms.setdefault(tree, []).append(checks.device_ms(c.run))
            build._lib = libs["this"]
            parent, this = (sum(ms[k]) / 2 for k in ("parent", "this"))
            bound, _ = c.bound()
            line = (f"    {c.label:55s} parent {parent:.5f}  this "
                    f"{this:.5f} ms ({100 * this / parent:.1f}%)  bound "
                    f"{bound:.5f} ms ({100 * bound / this:.1f}% of this)")
            for name in variants:
                line += f"  {name} {sum(ms[name]) / 2:.5f} ms"
            if c.composed is not None:
                line += (f"  {'K1 20it + K3' if 'dens_advect' in c.kernels
                              else 'composition'} "
                         f"{checks.device_ms(c.composed):.5f} ms")
            if c.boxes is not None:
                line += (f"  blocks staged "
                         f"{100 * checks.staged_share(c):.1f}%")
            if "advect_project" in c.kernels:
                cst.reset_form_counts()
                c.run()
                forms = [k for k, n in cst.form_counts().items() if n]
                line += f"  form {'/'.join(forms)}"
            print(line, flush=True)


if __name__ == "__main__":
    main()
