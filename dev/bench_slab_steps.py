#!/usr/bin/env python3
"""The row-slab steps with their solves as the path runs them and on the
per-sweep K9, in one process on one card; or a parent tree's steps.

    python3 dev/bench_slab_steps.py [--steps 10] [--tree DIR]
        [--only slabs8,slabs8perf,slabs4big,slabs128,slabs1]

Steps of ``make_sharded_step_fn`` on one card (a mesh that lists it once
per slab), from the impulse of ``reference_init`` (seed 0) and two more
steps: 2048² parity (20 iterations) on 8 slabs, the 2048² perf mode
(``perf_operating_point(2048)``, fast math) on 8 slabs, 8192² parity (40
iterations) on 4 slabs, 2048² parity with ``fuse_sweeps=8`` on 128 slabs
of 16 rows and 2048² parity on one slab.  Each is timed eager (CUDA events
around ``--steps`` steps: what a caller sees) and as a CUDA graph of one
step (``checks.device_ms``: device time alone) in two forms: as the path
chooses (``cuda_ops.tiled_slab``) and inside ``cuda_ops.launch_sweeps(0)``
(every solve on the per-sweep K9), in turns forward and backward, the mean
of each pair; with each form's launches of one step and the states after
one step held bit for bit.  ``--tree DIR`` imports the package from
another checkout (a parent commit unpacked with ``git archive``) and times
its path alone; every run prints a digest of the state after one step, so
two trees' runs can be held bit for bit.  Prints the card's name and power
limit.  Exits non-zero without a card or on a difference.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--tree", default=None)
    ap.add_argument("--only",
                    default="slabs8,slabs8perf,slabs4big,slabs128,slabs1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_slab_steps: no CUDA device", file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve() if args.tree else ROOT
    sys.path.insert(0, str(tree))
    from fluidsimulationcuda_torch import (SimConfig, reference_init,
                                           zero_sources)
    from fluidsimulationcuda_torch.core.config import perf_operating_point
    from fluidsimulationcuda_torch.kernels import build, checks
    from fluidsimulationcuda_torch.kernels import cuda_ops as co
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn,
                                                    shard_state, unshard)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}; tree {tree}; library "
          f"{build.build()}")
    parity = SimConfig(n=2046, jacobi_iters=20, backend="cuda",
                       device="cuda")
    rho, k_d, k_p = perf_operating_point(2048)
    perf = parity.replace(pressure_solver="chebyshev",
                          diffusion_solver="chebyshev", cheby_rho=rho,
                          cheby_iters=k_d, cheby_press_iters=k_p,
                          fast_math=True)
    big = SimConfig(n=8190, jacobi_iters=40, backend="cuda", device="cuda")
    runs = {"slabs8": ("2048² parity, 8 slabs", parity, 8, 3),
            "slabs8perf": (f"2048² perf ({rho}, {k_d}, {k_p}) fast, 8 slabs",
                           perf, 8, 3),
            "slabs4big": ("8192² parity 40 it, 4 slabs", big, 4, 3),
            "slabs128": ("2048² parity fuse_sweeps=8, 128 slabs",
                         parity.replace(fuse_sweeps=8), 128, 1),
            "slabs1": ("2048² parity, 1 slab", parity, 1, 3)}
    forms = {"path": None} if args.tree else {"path": None, "per-sweep": 0}

    def form(name):
        per = forms[name]
        return (contextlib.nullcontext() if per is None
                else co.launch_sweeps(per))

    failures = 0
    for key in args.only.split(","):
        label, cfg, slabs, reps = runs[key]
        gen = torch.Generator(device="cuda").manual_seed(0)
        state, sources = reference_init(gen, cfg)
        mesh = make_mesh([torch.device("cuda", 0)] * slabs)
        fn = make_sharded_step_fn(cfg, mesh)
        zeros = shard_state(zero_sources(cfg), mesh)
        state = fn(shard_state(state, mesh), shard_state(sources, mesh))
        for _ in range(2):
            state = fn(state, zeros)
        torch.cuda.synchronize()

        def step(s, fn=fn, zeros=zeros):
            return fn(s, zeros)

        outs, counts = {}, {}
        for name in forms:
            with form(name):
                co.reset_launch_counts()
                outs[name] = unshard(step(state))
                torch.cuda.synchronize()
                counts[name] = {k: n for k, n in co.launch_counts().items()
                                if n}
        same = all(torch.equal(a, b) for name in forms
                   for a, b in zip(outs[name], outs["path"])
                   if a is not None)
        failures += not same
        digest = hashlib.sha256(b"".join(
            f.cpu().numpy().tobytes() for f in outs["path"]
            if f is not None)).hexdigest()[:16]
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
                                                reps=reps) / 2
        line = "; ".join(
            f"{name} {eager[name]:.4f} ms/step eager, {graph[name]:.4f} as a "
            f"CUDA graph, {sum(counts[name].values())} launches "
            f"{counts[name]}" for name in forms)
        ratio = ("" if args.tree else
                 f"; path against per-sweep: graph "
                 f"{graph['per-sweep'] / graph['path']:.2f}x, eager "
                 f"{eager['per-sweep'] / eager['path']:.2f}x")
        print(f"{label}: {line}{ratio}; state after one step "
              f"{'equal bit for bit' if same else 'DIFFERS'} across forms, "
              f"digest {digest} ({card})", flush=True)
    print(f"{failures} failure(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
