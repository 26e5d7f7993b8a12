#!/usr/bin/env python3
"""T and the tile of the tiled K9 (``csrc/jacobi_tiles.cu``,
``fsc_jacobi_slab_sweeps``), by measurement on the card.

    python3 dev/bench_slab_sweeps.py [--per-launch 4,5,8,10] [--tiles 64,32]
                                     [--only 2048,2048one,8192,thin]

Times the row-slab solves of the multi-device step, each on an interior
slab with the halo the step gives it: at 2048² on 8 slabs of 256 rows the
20-sweep velocity solve (a 304-row buffer), the 10-sweep Chebyshev+fast
solve of the perf mode (288 rows), the 20-sweep zero-guess pressure solve
and the perf mode's 14-sweep Chebyshev one (304 rows) and the density's
folded 20-sweep solve (320 rows); (``2048one``) the 20-sweep velocity
solve on one slab (a 2096-row buffer); at 8192² on 4 slabs of
2048 rows the 20-sweep velocity chunk (2096 rows); and (``thin``) the
128-slab step's chunks with ``fuse_sweeps=8``, 8 sweeps on a 48-row buffer
and 4 on a 32-row one.  Each runs through ``fused_jacobi_slab`` at every T
of ``--per-launch`` on tiles of every height of ``--tiles`` (64 or 32
rows; ``cuda_ops.launch_sweeps(T, tile_rows)`` around the call) and on the
per-sweep K9 (T = 0), in one process on one card (device ms of a call,
CUDA graphs of 20 calls, ``checks.device_ms``; the forms in turns forward,
then backward, and the mean).  Every tiled result is first held bit for
bit against the per-sweep chain.  Prints each time, its share of the
solve's bound (``checks._slab_sweeps_cost``) and the card's name and power
limit.  Exits non-zero without a card or on a difference.
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
    ap.add_argument("--per-launch", default="4,5,8,10")
    ap.add_argument("--tiles", default="64,32")
    ap.add_argument("--only", default="2048,2048one,8192,thin")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_slab_sweeps: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from fluidsimulationcuda_torch.core.config import PERF_POINTS_2D
    from fluidsimulationcuda_torch.kernels import build, checks
    from fluidsimulationcuda_torch.kernels import cuda_ops as co
    from fluidsimulationcuda_torch.kernels import cuda_sharded as cs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}; library "
          f"{build.build()}")
    per_launch = [int(t) for t in args.per_launch.split(",")]
    tiles = [int(h) for h in args.tiles.split(",")]
    rho, k_d, _ = PERF_POINTS_2D[2048]
    solves = {}

    def solve(t, label, b, x, rhs, sweeps, K, alpha, beta, **kw):
        i = t.slabs // 2
        xe, re_ = t.ext(x, i, K), t.ext(rhs, i, K)
        rows, side = t.m + 2 * K, t.side
        cost = checks._slab_sweeps_cost(
            sweeps, rows, side, zero_init=kw.get("zero_init", False),
            fast=kw.get("fast", False), cheby="cheby_rho" in kw)
        solves[f"{label} ({rows} x {side} buffer)"] = (
            lambda: cs.fused_jacobi_slab(b, xe, re_, t.flags(i), m=t.m, K=K,
                                         alpha=alpha, beta=beta,
                                         sweeps=sweeps, **kw), cost)

    def folded(t, label, sweeps, K):
        """The density's solve: rhs base + dt*src built by the first sweep
        (``fused_dens_slab``'s diffusion without its gather)."""
        i = t.slabs // 2
        se, be = t.ext(t.src, i, K), t.ext(t.x0, i, K)
        rows, side = t.m + 2 * K, t.side
        gtop, gbot = cs._wall_rows(t.flags(i), K, t.m)
        ad = t.a_diff

        def run():
            r = co._Sweeps(0, se, be, ad, 1 + 4 * ad, sweeps,
                           zero_init=False, src_dt=checks.DT, fast=False,
                           cheby_rho=None, kernel="jacobi_slab")
            r.run_slab(build.load(), rows, gtop, gbot)
            return r.x[sweeps:rows - sweeps]

        solves[f"{label} ({rows} x {side} buffer)"] = (
            run, checks._slab_sweeps_cost(sweeps, rows, side, src=True))

    ceil8 = checks._ceil8
    if "2048" in args.only:
        t = checks._SlabInputs(2048, 256, "cuda", 0)
        av = t.a_visc
        solve(t, "2048² 8 slabs, 20it u", 1, t.src, t.x0, 20, ceil8(21), av,
              1 + 4 * av)
        solve(t, f"2048² 8 slabs, {k_d}it chebyshev+fast u", 1, t.src, t.x0,
              k_d, ceil8(k_d + 1), av, 1 + 4 * av, fast=True, cheby_rho=rho)
        solve(t, "2048² 8 slabs, 20it pressure", 0, t.p, t.p, 20, ceil8(23),
              1.0, 4.0, zero_init=True)
        solve(t, "2048² 8 slabs, 14it chebyshev pressure", 0, t.p, t.p, 14,
              ceil8(14 + 3), 1.0, 4.0, zero_init=True, cheby_rho=rho)
        folded(t, "2048² 8 slabs, 20it density (src fold)", 20,
               ceil8(20 + 1 + checks.SLAB_CMAX))
    if "2048one" in args.only:
        t = checks._SlabInputs(2048, 2048, "cuda", 0)
        av = t.a_visc
        solve(t, "2048² 1 slab, 20it u", 1, t.src, t.x0, 20, ceil8(21), av,
              1 + 4 * av)
    if "8192" in args.only:
        t = checks._SlabInputs(8192, 2048, "cuda", 0)
        av = t.a_visc
        solve(t, "8192² 4 slabs, 20it u chunk", 1, t.src, t.x0, 20,
              ceil8(21), av, 1 + 4 * av)
    if "thin" in args.only:
        t = checks._SlabInputs(2048, 16, "cuda", 0)
        av = t.a_visc
        solve(t, "2048² 128 slabs, 8it u chunk", 1, t.src, t.x0, 8, ceil8(9),
              av, 1 + 4 * av)
        solve(t, "2048² 128 slabs, 4it pressure chunk", 0, t.p, t.p, 4,
              ceil8(5), 1.0, 4.0)
    forms = [(0, 64)] + [(p, h) for h in tiles for p in per_launch]
    failures = 0
    for name, (fn, cost) in solves.items():
        bound, bound_by = checks.Check(name, (), None, None, cost,
                                       1).bound()

        def run(form):
            per, tile = form
            with co.launch_sweeps(per, tile_rows=tile):
                return fn()

        want = run(forms[0])
        for form in forms[1:]:
            if not torch.equal(run(form), want):
                failures += 1
                print(f"  FAIL {name} T={form[0]} tile {form[1]}: differs "
                      f"from the per-sweep chain")
        ms = dict.fromkeys(forms, 0.0)
        for form in forms + forms[::-1]:
            ms[form] += checks.device_ms(lambda form=form: run(form)) / 2
        chain = ms[forms[0]]
        print(f"{name}: bound {bound:.5f} ms ({bound_by}); per-sweep K9 "
              f"{chain:.5f} ms ({100 * bound / chain:.1f}%) ({card})")
        for tile in tiles:
            line = "  ".join(f"T={p}: {ms[(p, tile)]:.5f} "
                             f"({100 * bound / ms[(p, tile)]:.1f}%)"
                             for p in per_launch)
            best = min(per_launch, key=lambda p: ms[(p, tile)])
            print(f"  tile 128 x {tile}: {line}; best T={best} "
                  f"({chain / ms[(best, tile)]:.2f}x the per-sweep K9)",
                  flush=True)
    print(f"{failures} failure(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
