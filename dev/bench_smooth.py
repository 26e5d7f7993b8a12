#!/usr/bin/env python3
"""K1-damp, the multigrid smoother, at every level of the multigrid
hierarchies, against the per-sweep damped K1, by measurement on the card.

    python3 dev/bench_smooth.py [--only grid,batch]

The levels of ``ops.multigrid.mg_pressure_solve_fast``: (``grid``) one grid
at padded sides 2048, 1024, ..., 32 and the coarsest 16 (the 2048² step's),
(``batch``) a batch of 64 grids at 256, 128, 64, 32 and 16 (phase 18's
batched step).  At each side the cycle's smoothing calls of
``checks.MG_SMOOTHS`` that a level makes (2 sweeps from a guess and from
zero; 40 from zero on the coarsest) run through ``cuda_ops.mg_smooth`` in
each form, chosen with ``cuda_ops.smooth_launches``: the per-sweep damped
K1 (one launch a sweep, the route before K1-damp), K1-damp on tiles of 16
and 64 rows (T = ``SWEEPS_PER_LAUNCH``, or the most the tile's halo
allows), and K1-damp's whole-grid launch in a tile of 32 rows where the
grid fits.  Every form is first held bit for bit against the per-sweep
one and against ``ops.multigrid._smooth``; then each is timed (device ms
of a call, CUDA graphs of 20 calls, ``checks.device_ms``; and eager, as
the step calls it, host included: CUDA events around 100 calls; the forms
in turns forward, then backward, and the mean), beside the call's bound
(``checks._sweeps_cost``) and the form ``cuda_ops.damped_plan`` gives it.  Last, each hierarchy's smoother time a
V-cycle (two smooths a level, from zero and from a guess, and the coarsest
solve) on the per-sweep K1, on the path's forms, and on the fastest form of
each call.  Prints the card's name and power limit.  Exits non-zero
without a card or on a difference.
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
    ap.add_argument("--only", default="grid,batch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_smooth: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from fluidsimulationcuda_torch.kernels import build, checks
    from fluidsimulationcuda_torch.kernels import cuda_ops as co
    from fluidsimulationcuda_torch.ops.multigrid import _coarse_side, _smooth

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}; library "
          f"{build.build()}")

    def sides(top):
        out = [top]
        while out[-1] - 2 >= 16:
            out.append(_coarse_side(out[-1]))
        return out

    hierarchies = {"grid": (sides(2048), 0), "batch": (sides(256), 64)}
    # name: (sweeps a launch, tile rows, whole grid)
    forms = {"per-sweep": (0, 64, False),
             **{f"tiled{rows}": (min(co.SWEEPS_PER_LAUNCH, (rows - 3) // 2),
                                 rows, False) for rows in (16, 64)},
             "whole32": (0, 32, True)}
    failures = 0
    for key in args.only.split(","):
        levels, batch = hierarchies[key]
        totals = {"per-sweep": 0.0, "path": 0.0, "best": 0.0}
        for side in levels:
            t = checks._Inputs(side, "cuda", side, batch=batch)
            size = f"{batch} × {side}²" if batch else f"{side}²"
            calls = ([(40, True)] if side == levels[-1]
                     else [(2, False), (2, True)])
            for sweeps, zero in calls:
                names = [name for name, (_, rows, whole) in forms.items()
                         if not whole or side <= rows - 2]

                def run(name, sweeps=sweeps, zero=zero):
                    with co.smooth_launches(*forms[name]):
                        return co.mg_smooth(t.x, t.x0, sweeps, zero)

                want = _smooth(t.x, t.x0, sweeps, zero)
                for name in names:
                    got = run(name)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        failures += 1
                        print(f"{size} {sweeps} sweeps: {name} differs from "
                              f"_smooth by {checks.max_abs_diff(got, want)}")
                ms = dict.fromkeys(names, 0.0)
                eager = dict.fromkeys(names, 0.0)
                for name in [*names, *reversed(names)]:
                    ms[name] += checks.device_ms(lambda name=name: run(name)
                                                 ) / 2
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(100):
                        run(name)
                    stop.record()
                    stop.synchronize()
                    eager[name] += start.elapsed_time(stop) / 100 / 2
                cost = checks._sweeps_cost(sweeps, 2, zero_init=zero,
                                           damp=True)
                bound, by = checks.Check("", (), None, None, cost,
                                         t.cells).bound()
                route = co.damped_plan(side, sweeps, batch or 1)
                path = ("per-sweep" if route.per_launch == 0 else
                        f"{'whole' if route.whole else 'tiled'}"
                        f"{route.tile_rows}")
                fastest = min(ms, key=ms.get)
                line = ", ".join(f"{name} {ms[name]:.5f}" for name in names)
                calls = ", ".join(f"{name} {eager[name]:.5f}"
                                  for name in names)
                print(f"{size} damped {sweeps} sweeps"
                      f"{' zero_init' if zero else ''}: device {line} ms; "
                      f"eager {calls} ms a call; bound {bound:.5f} ({by}); "
                      f"path {path} ({ms['per-sweep'] / ms[path]:.2f}x the "
                      f"per-sweep K1's device time, "
                      f"{eager['per-sweep'] / eager[path]:.2f}x its eager "
                      f"call), fastest on the device {fastest} ({card})",
                      flush=True)
                # A level smooths from zero and from a guess once a cycle;
                # the coarsest solves once.
                totals["per-sweep"] += ms["per-sweep"]
                totals["path"] += ms[path]
                totals["best"] += ms[fastest]
        print(f"{key} hierarchy {levels}: smoother ms a V-cycle: per-sweep "
              f"K1 {totals['per-sweep']:.5f}, the path's forms "
              f"{totals['path']:.5f}, the fastest of each call "
              f"{totals['best']:.5f} ({card})", flush=True)
    print(f"{failures} failure(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
