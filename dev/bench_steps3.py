#!/usr/bin/env python3
"""The 3-D steps with their solves as the path runs them, on the tiled
3-D Jacobi wherever its mode allows and on the per-sweep K5 and K13 it
replaced, in one process on one card.

    python3 dev/bench_steps3.py [--steps 10]
        [--only parity,compensated,slabs8,slabs8comp,slabs32]

Steps at 256³ (n = 254, the impulse of ``reference_init``, seed 0, then
two more steps): ``StableFluids3D`` in parity mode (20 iterations) and
the 3-D compensated mode with fast math (``perf_operating_point(256,
ndim=3)``), ``make_sharded_step_fn_3d`` on 8 z-slabs of 32 planes in
parity mode and in the compensated mode with fast math, and in that mode
on 32 z-slabs of 8 planes (every solve chained across halo exchanges),
all on one card.  Each is timed eager (CUDA events around ``--steps``
steps: what a caller sees) and as a CUDA graph of one step
(``checks.device_ms``: device time alone) in three forms: as the path
chooses (``cuda_ops.tiled3``), inside ``cuda_ops.launch_sweeps(T3)``
(every fast Chebyshev solve and segment on the tiled kernel) and inside
``launch_sweeps(0)`` (every one on the per-sweep kernels), in turns
forward and backward, the mean of each pair; the launches of one step of
each, and the three states after one step held bit for bit.  Prints the
card's name and power limit.  Exits non-zero without a card or on a
difference.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--only",
                    default="parity,compensated,slabs8,slabs8comp,slabs32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_steps3: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from fluidsimulationcuda_torch import (SimConfig, StableFluids3D,
                                           reference_init, zero_sources)
    from fluidsimulationcuda_torch.core.config import perf_operating_point
    from fluidsimulationcuda_torch.kernels import build, checks
    from fluidsimulationcuda_torch.kernels import cuda_ops as co
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn_3d,
                                                    shard_state_3d, unshard)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}; library "
          f"{build.build()}")
    parity = SimConfig(n=254, ndim=3, jacobi_iters=20, backend="cuda",
                       device="cuda")
    rho, k_d, k_p = perf_operating_point(256, ndim=3)
    comp = parity.replace(pressure_solver="chebyshev",
                          diffusion_solver="chebyshev", cheby_rho=rho,
                          cheby_iters=k_d, cheby_press_iters=k_p,
                          fast_math=True)
    runs = {"parity": ("256³ parity", parity, 0),
            "compensated": (f"256³ compensated ({rho}, {k_d}, {k_p}) fast",
                            comp, 0),
            "slabs8": ("256³ parity, 8 z-slabs", parity, 8),
            "slabs8comp": (f"256³ compensated ({rho}, {k_d}, {k_p}) fast, 8 "
                           f"z-slabs", comp, 8),
            "slabs32": (f"256³ compensated ({rho}, {k_d}, {k_p}) fast, 32 "
                        f"z-slabs", comp, 32)}
    failures = 0
    for key in args.only.split(","):
        label, cfg, slabs = runs[key]
        gen = torch.Generator(device="cuda").manual_seed(0)
        state, sources = reference_init(gen, cfg)
        if slabs:
            mesh = make_mesh([torch.device("cuda", 0)] * slabs)
            fn = make_sharded_step_fn_3d(cfg, mesh)
            zeros = shard_state_3d(zero_sources(cfg), mesh)
            state = shard_state_3d(state, mesh)
            sources = shard_state_3d(sources, mesh)

            def step(s, src=None, fn=fn, zeros=zeros):
                return fn(s, zeros if src is None else src)

            def whole(s):
                return unshard(s)
        else:
            sim = StableFluids3D(cfg)

            def step(s, src=None, sim=sim):
                return sim.step(s, src)

            def whole(s):
                return s
        state = step(state, sources)
        for _ in range(2):
            state = step(state)
        torch.cuda.synchronize()

        forms = {"path": None, "tiled": co.SWEEPS_PER_LAUNCH_3D,
                 "per-sweep": 0}

        def form(name):
            per = forms[name]
            return (contextlib.nullcontext() if per is None
                    else co.launch_sweeps(per))

        outs, counts = {}, {}
        for name in forms:
            with form(name):
                co.reset_launch_counts()
                outs[name] = whole(step(state))
                torch.cuda.synchronize()
                counts[name] = {k: n for k, n in co.launch_counts().items()
                                if n}
        same = all(torch.equal(a, b) for name in forms
                   for a, b in zip(outs[name], outs["per-sweep"]))
        failures += not same
        eager, graph = dict.fromkeys(forms, 0.0), dict.fromkeys(forms, 0.0)
        for name in [*forms, *reversed(forms)]:
            with form(name):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                s = state
                start.record()
                for _ in range(args.steps):
                    s = step(s)
                stop.record()
                stop.synchronize()
                eager[name] += start.elapsed_time(stop) / args.steps / 2
                graph[name] += checks.device_ms(lambda: step(state),
                                                reps=3) / 2
        line = "; ".join(
            f"{name} {eager[name]:.4f} ms/step eager, {graph[name]:.4f} as a "
            f"CUDA graph, {sum(counts[name].values())} launches "
            f"{counts[name]}" for name in forms)
        print(f"{label}: {line}; path against per-sweep: graph "
              f"{graph['per-sweep'] / graph['path']:.2f}x, eager "
              f"{eager['per-sweep'] / eager['path']:.2f}x; states after one "
              f"step {'equal bit for bit' if same else 'DIFFER'} ({card})",
              flush=True)
    print(f"{failures} failure(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
