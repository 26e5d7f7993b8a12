#!/usr/bin/env python3
"""The tile of K9-damp (``csrc/jacobi_tiles.cu``,
``fsc_jacobi_slab_sweeps_damp``), the slab multigrid's smoother, by
measurement on the card.

    python3 dev/bench_slab_smooth.py [--tiles 64,32,16]
                                     [--only 2048,2048one,thin,8192]

Times the 2-sweep smooth of the slab multigrid (``smooth_slab``, from a
guess and from zero) on an interior slab with the step's 8-row halo: at
2048² on 8 slabs of 256 rows (a 272-row buffer, the path's), on one slab
(``2048one``, 2064 rows), on 128 slabs of 16 rows (``thin``, 32 rows), and
at 8192² on 4 slabs of 2048 rows (2064 x 8192).  Each smooth runs on tiles
of every height of ``--tiles`` (64 and 32 rows: K9's, 16: K1-damp's
below 2 M cells; ``cuda_ops.launch_sweeps(T, tile_rows)`` around the
call) in one launch (T = 2) and in one launch a sweep (T = 1, the
exchange a sweep of JAX's ``_mg_smooth_local``), beside the plain twin
``smooth_slab_plain``, in one process on one card (device ms of a call,
CUDA graphs of 20 calls, ``checks.device_ms``; the forms in turns forward,
then backward, and the mean).  Every result is first held bit for bit
against the plain twin.  Prints each time, its share of the smooth's bound
(``checks._slab_sweeps_cost``) and the card's name and power limit.  Exits
non-zero without a card or on a difference.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", default="64,32,16")
    ap.add_argument("--only", default="2048,2048one,thin,8192")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_slab_smooth: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from fluidsimulationcuda_torch.kernels import build, checks
    from fluidsimulationcuda_torch.kernels import cuda_ops as co
    from fluidsimulationcuda_torch.kernels import cuda_sharded as cs
    from fluidsimulationcuda_torch.parallel.solvers import SMOOTH_HALO as K

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}; library "
          f"{build.build()}")
    tiles = [int(h) for h in args.tiles.split(",")]
    grids = {"2048": (2048, 256, "2048² 8 slabs"),
             "2048one": (2048, 2048, "2048² 1 slab"),
             "thin": (2048, 16, "2048² 128 slabs"),
             "8192": (8192, 2048, "8192² 4 slabs")}
    smooths = {}
    for key in args.only.split(","):
        side, m, label = grids[key]
        t = checks._SlabInputs(side, m, "cuda", 0)
        i = t.slabs // 2
        pe, de = t.ext(t.p, i, K), t.ext(t.x0, i, K)
        rows = m + 2 * K
        for zero_init in (False, True):
            kw = dict(m=m, K=K, sweeps=2, zero_init=zero_init)
            name = (f"{label}, 2-sweep smooth"
                    f"{' from zero' if zero_init else ''} ({rows} x {side} "
                    f"buffer)")
            smooths[name] = (
                lambda pe=pe, de=de, fl=t.flags(i), kw=kw:
                cs.smooth_slab(pe, de, fl, **kw),
                lambda pe=pe, de=de, fl=t.flags(i), kw=kw:
                cs.smooth_slab_plain(pe, de, fl, **kw),
                checks._slab_sweeps_cost(2, rows, side, zero_init=zero_init,
                                         damp=True),
                co.slab_smooth_tiling(rows, side, 2)[1])
    forms = [(p, h) for h in tiles for p in (2, 1)]
    failures = 0
    for name, (fn, plain, cost, path_tile) in smooths.items():
        bound, bound_by = checks.Check(name, (), None, None, cost,
                                       1).bound()

        def run(form):
            per, tile = form
            with co.launch_sweeps(per, tile_rows=tile):
                return fn()

        want = plain()
        for form in forms:
            if not torch.equal(run(form), want):
                failures += 1
                print(f"  FAIL {name} T={form[0]} tile {form[1]}: differs "
                      f"from the plain twin")
        ms = dict.fromkeys(forms, 0.0)
        for form in forms + forms[::-1]:
            ms[form] += checks.device_ms(lambda form=form: run(form)) / 2
        plain_ms = (checks.device_ms(plain) + checks.device_ms(plain)) / 2
        print(f"{name}: bound {bound:.5f} ms ({bound_by}); plain twin "
              f"{plain_ms:.5f} ms; the path's tile: {path_tile} rows ({card})")
        for tile in tiles:
            one, two = ms[(1, tile)], ms[(2, tile)]
            print(f"  tile 128 x {tile}: one launch {two:.5f} ms "
                  f"({100 * bound / two:.1f}% of the bound), a launch a "
                  f"sweep {one:.5f} ms ({one / two:.2f}x)", flush=True)
        best = min(tiles, key=lambda h: ms[(2, h)])
        print(f"  fastest tile: {best} rows")
    print(f"{failures} failure(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
