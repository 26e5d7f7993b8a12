#!/usr/bin/env python3
"""K4 and K6 of this tree against those of another tree (a parent commit),
on the card, on the same inputs in the same process.

    python3 dev/bench_gathers.py --parent build/parent

Builds the kernel library of this tree and of ``--parent`` (a checkout
whose ``fluidsimulationcuda_torch/csrc`` has the same C entry points, e.g.
``git archive HEAD~`` unpacked into a gitignored directory) and times each
K4 and K6 timing check of ``kernels/checks.py`` with one library and then
the other, in turns parent, this tree, this tree, parent (device ms of a
call, CUDA graphs of 20 calls, ``checks.device_ms``): K4 alone on random,
smooth and shear velocities and at 20 sweeps beside K1 20it + K3, at 2048²
and on the datagen batch of 1024 grids of 256² (window 1; the shear
exact); K6's triple and one field at 256³ on random, smooth and shear
velocities, exact and in the window.  Prints both times, their ratio, the
bound and, for K4, the share of blocks that stage their footprint box.
Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_gathers: no CUDA device")
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    from fluidsimulationcuda_torch.kernels import build, checks

    libs = {"parent": build.open_library(build.build(
                csrc=args.parent / "fluidsimulationcuda_torch" / "csrc")),
            "this": build.load()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(f"device ms per call, parent / this / this / parent ({card})")

    def gathers(check_list):
        return [c for c in check_list
                if set(c.kernels) & {"dens_advect", "advect3",
                                     "advect3_windowed"}]

    for size, group in (
            ("2048²", gathers(checks.timing_checks(2048, "cuda"))),
            ("1024 × 256²", gathers(checks.timing_checks_batched(
                1024, 256, "cuda", 0, 1))),
            ("256³", gathers(checks.timing_checks3(256, "cuda"))
             + gathers(checks.timing_checks3_windowed(256, "cuda")))):
        print(f"  at {size}:")
        for c in group:
            ms = {}
            for tree in ("parent", "this", "this", "parent"):
                build._lib = libs[tree]
                ms.setdefault(tree, []).append(checks.device_ms(c.run))
            build._lib = libs["this"]
            parent, this = (sum(ms[k]) / 2 for k in ("parent", "this"))
            bound, _ = c.bound()
            line = (f"    {c.label:55s} parent {parent:.5f}  this "
                    f"{this:.5f} ms ({100 * this / parent:.1f}%)  bound "
                    f"{bound:.5f} ms ({100 * bound / this:.1f}% of this)")
            if c.composed is not None:
                line += f"  K1 20it + K3 {checks.device_ms(c.composed):.5f} ms"
            if c.boxes is not None:
                line += (f"  blocks staged "
                         f"{100 * checks.staged_share(c):.1f}%")
            print(line, flush=True)


if __name__ == "__main__":
    main()
