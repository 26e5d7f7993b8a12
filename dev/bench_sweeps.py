#!/usr/bin/env python3
"""T, the sweeps of one tiled K1 launch (``csrc/jacobi_tiles.cu``), by
measurement on the card.

    python3 dev/bench_sweeps.py [--per-launch 1,2,3,4,5,6,8,10,20]
                                [--sizes 2048,8192,batch] [--verbose]

For each size (2048², 8192² and the datagen batch of 1024 grids of 256²)
and storage dtype (float32, bf16) it times the solves of the 2-D step at
each T of ``--per-launch`` and on the per-sweep K1 (T = 0), in one process
on one card (device ms of a call, CUDA graphs of 20 calls,
``checks.device_ms``; the T values in turns forward, then backward, and
the mean): the 20-sweep velocity solve with its source fold, the 20-sweep
zero-guess pressure solve and the compensated mode's 10-sweep
Chebyshev+fast solve.  Each tiled result is first held bit for bit against
the per-sweep chain.  Prints each time, its share of the solve's bound
(``checks._sweeps_cost``: inputs read once, the result written once, every
sweep's operations) and the card's name and power limit.  ``--verbose``
builds with ``-Xptxas -v`` (each kernel's registers and spills).  Exits
non-zero without a card.
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
    ap.add_argument("--per-launch", default="1,2,3,4,5,6,8,10,20")
    ap.add_argument("--sizes", default="2048,8192,batch")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_sweeps: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from fluidsimulationcuda_torch.core.config import PERF_POINTS_2D
    from fluidsimulationcuda_torch.kernels import build, checks
    from fluidsimulationcuda_torch.kernels import cuda_ops as co

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}")
    print(f"library: {build.build(verbose=args.verbose)}")
    per_launch = [int(t) for t in args.per_launch.split(",")]
    rho, k_d, _ = PERF_POINTS_2D[2048]
    shapes = {"2048": (2048, 0), "8192": (8192, 0), "batch": (256, 1024)}
    failures = 0
    for size in args.sizes.split(","):
        side, batch = shapes[size]
        base = checks._Inputs(side, "cuda", 0, batch=batch)
        tag = f"{batch} x {side}²" if batch else f"{side}²"
        for dtype in (torch.float32, torch.bfloat16):
            x, x0, src, p = (f.to(dtype) for f in (base.x, base.x0, base.src,
                                                    base.p))
            av = base.a_visc
            bf16 = dtype == torch.bfloat16
            solves = {
                "20it src_dt": ((1, src, x0, av, 1 + 4 * av, 20),
                                dict(src_dt=checks.DT),
                                dict(src=True)),
                "20it zero_init": ((0, p, p, 1.0, 4.0, 20),
                                   dict(zero_init=True),
                                   dict(zero_init=True)),
                f"{k_d}it chebyshev+fast": (
                    (1, src, x0, av, 1 + 4 * av, k_d),
                    dict(src_dt=checks.DT, fast=True, cheby_rho=rho),
                    dict(src=True, fast=True, cheby=True)),
            }
            for name, (call, kw, cost) in solves.items():
                iters = call[-1]
                check = checks.Check(name, (), None, None,
                                     checks._sweeps_cost(iters, 2, bf16=bf16,
                                                         **cost),
                                     base.cells)
                bound, bound_by = check.bound()

                def run(t, call=call, kw=kw):
                    with co.launch_sweeps(t):
                        return co.fused_jacobi(*call, **kw)

                want = run(0)
                for t in per_launch:
                    if not torch.equal(run(t), want):
                        failures += 1
                        print(f"  FAIL {tag} {dtype} {name} T={t}: "
                              f"differs from the per-sweep K1")
                order = [0, *per_launch]
                ms = dict.fromkeys(order, 0.0)
                for t in order + order[::-1]:
                    ms[t] += checks.device_ms(lambda t=t: run(t)) / 2
                line = "  ".join(f"T={t}: {ms[t]:.5f} "
                                 f"({100 * bound / ms[t]:.1f}%)"
                                 for t in per_launch)
                best = min(per_launch, key=ms.get)
                chain = ms[0]
                print(f"{tag} {str(dtype)[6:]} {name}: bound {bound:.5f} ms "
                      f"({bound_by}); per-sweep K1 {chain:.5f} "
                      f"({100 * bound / chain:.1f}%); {line}; best "
                      f"T={best} ({chain / ms[best]:.2f}x the "
                      f"per-sweep K1) ({card})", flush=True)
            del x, x0, src, p
        del base
        torch.cuda.empty_cache()
    print(f"{failures} failure(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
