#!/usr/bin/env python3
"""The tile of K9-damp (``csrc/jacobi_tiles.cu``,
``fsc_jacobi_slab_sweeps_damp_group``), the slab multigrid's smoother, by
measurement on the card.

    python3 dev/bench_slab_smooth.py [--tiles 64,32,16]
                                     [--only 2048,2048one,thin,8192]
                                     [--odd]

Times the 2-sweep smooth of the slab multigrid (``smooth_slabs``, every
slab of the mesh in one launch, its halo rows read from the neighbouring
slabs' arrays), from a guess and from zero, on each mesh of ``--only``:
2048² on 8 slabs of 256 rows (the path's), on one slab (``2048one``), on
128 slabs of 16 rows (``thin``), and 8192² on 4 slabs of 2048 rows.  Each
smooth runs on tiles of every height of ``--tiles``
(``cuda_ops.launch_sweeps(2, tile_rows)`` around the call) in one launch,
beside the plain twin ``smooth_slabs_plain``, in one process on one card
(device ms of a call, CUDA graphs of 20 calls, ``checks.device_ms``; the
forms in turns forward, then backward, and the mean).  Every result is
first held bit for bit against the plain twin.  Prints each time, its
share of the bound of the smooth over the whole grid
(``checks._group_cost``) and the card's name and power limit.  ``--odd``
times K1-damp's 40-sweep coarse solve of the slab multigrid at 1025²
(2048² on slabs) and a 2-sweep smooth there in each route of
``ODD_ROUTES`` (``cuda_ops.smooth_launches``: T sweeps a launch on tiles
of 16 or 64 rows, T = 0 the per-sweep damped K1), each held bit for bit
to ``ops.multigrid._smooth`` first, and prints ``cuda_ops.damped_plan``'s
route.  Exits non-zero without a card or on a difference.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# (T, tile rows) of K1-damp's 40-sweep solve at 1025² (--odd): T = 6 on 16
# rows (the route before: 1025 % 4 = 1 takes the deeper halo), 5 and 4
# there, 10 and 8 on 64 rows, and the per-sweep chain (0).
ODD_ROUTES = ((6, 16), (5, 16), (4, 16), (10, 64), (8, 64), (0, 16))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", default="64,32,16")
    ap.add_argument("--only", default="2048,2048one,thin,8192")
    ap.add_argument("--odd", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_slab_smooth: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from fluidsimulationcuda_torch.kernels import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}; library "
          f"{build.build()}")
    tiles = [int(h) for h in args.tiles.split(",")]
    if args.odd:
        return odd_routes(card)
    return group_tiles(card, tiles, args.only.split(","))


GRIDS = {"2048": (2048, 256, "2048² 8 slabs"),
         "2048one": (2048, 2048, "2048² 1 slab"),
         "thin": (2048, 16, "2048² 128 slabs"),
         "8192": (8192, 2048, "8192² 4 slabs")}


def _turns(forms: dict, fns: dict) -> dict:
    """Device ms of each form, in turns forward then backward, the mean."""
    from fluidsimulationcuda_torch.kernels import checks

    ms = dict.fromkeys(forms, 0.0)
    for form in list(forms) + list(forms)[::-1]:
        ms[form] += checks.device_ms(fns[form]) / 2
    return ms


def group_tiles(card: str, tiles: list[int], keys: list[str]) -> int:
    from fluidsimulationcuda_torch.kernels import checks
    from fluidsimulationcuda_torch.kernels import cuda_ops as co
    from fluidsimulationcuda_torch.kernels import cuda_sharded as cs

    failures = 0
    for key in keys:
        side, m, label = GRIDS[key]
        t = checks._SlabInputs(side, m, "cuda", 0)
        p, d, fl = t.slab_list(t.p), t.slab_list(t.x0), t.flag_list()
        for zero_init in (False, True):
            kw = dict(sweeps=2, zero_init=zero_init)
            name = f"{label}, 2-sweep smooth{' from zero' if zero_init else ''}"
            want = cs.smooth_slabs_plain(p, d, fl, **kw)

            def grouped(tile, kw=kw):
                with co.launch_sweeps(2, tile_rows=tile):
                    return cs.smooth_slabs(p, d, fl, **kw)

            fns = {tile: (lambda tile=tile: grouped(tile)) for tile in tiles}
            fns["plain"] = lambda kw=kw: cs.smooth_slabs_plain(p, d, fl, **kw)
            for form, fn in fns.items():
                if checks.max_abs_diff(fn(), want) != 0.0:
                    failures += 1
                    print(f"  FAIL {name} {form}: differs from the plain twin")
            ms = _turns(fns, fns)
            bound, bound_by = checks.Check(name, (), None, None,
                                           checks._group_cost(2, side * side,
                                                              zero_init),
                                           1).bound()
            path = co.group_smooth_tiling(len(p) * m * side, m, 2)[1]
            print(f"{name}: bound {bound:.5f} ms ({bound_by}); plain twin "
                  f"{ms['plain']:.5f} ms; the path's tile {path} rows "
                  f"({card})")
            for tile in tiles:
                print(f"  tile 128 x {tile}: {ms[tile]:.5f} ms "
                      f"({100 * bound / ms[tile]:.1f}% of the bound)",
                      flush=True)
    print(f"{failures} failure(s)")
    return 1 if failures else 0


def odd_routes(card: str) -> int:
    from fluidsimulationcuda_torch.kernels import checks
    from fluidsimulationcuda_torch.kernels import cuda_ops as co
    from fluidsimulationcuda_torch.ops.multigrid import _smooth

    side, failures = 1025, 0
    t = checks._Inputs(side, "cuda", 0)
    for sweeps, zero_init in ((40, True), (2, False)):
        want = _smooth(t.x, t.x0, sweeps, zero_init)

        def route(form, sweeps=sweeps, zero_init=zero_init):
            per, tile = form
            with co.smooth_launches(per, tile):
                return co.mg_smooth(t.x, t.x0, sweeps, zero_init)

        fns = {form: (lambda form=form: route(form)) for form in ODD_ROUTES}
        fns["path"] = lambda: co.mg_smooth(t.x, t.x0, sweeps, zero_init)
        for form, fn in fns.items():
            if not torch.equal(fn(), want):
                failures += 1
                print(f"  FAIL {side}² {sweeps} sweeps {form}")
        ms = _turns(fns, fns)
        bound, bound_by = checks.Check("", (), None, None,
                                       checks._damp_cost(sweeps, zero_init),
                                       side * side).bound()
        print(f"{side}² damped, {sweeps} sweeps{' from zero' if zero_init else ''}: "
              f"bound {bound:.5f} ms ({bound_by}); the path "
              f"{co.damped_plan(side, sweeps)} {ms['path']:.5f} ms ({card})")
        for form in ODD_ROUTES:
            per, tile = form
            what = ("per-sweep damped K1" if per == 0
                    else f"T = {per} on 128 x {tile} tiles")
            print(f"  {what}: {ms[form]:.5f} ms "
                  f"({100 * bound / ms[form]:.1f}% of the bound)", flush=True)
    print(f"{failures} failure(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
