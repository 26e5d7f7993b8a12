#!/usr/bin/env python3
"""The multigrid 2-D steps with their smoother as the path runs it and on
the per-sweep damped K1, in one process on one card; or a parent tree's
steps.

    python3 dev/bench_mg_steps.py [--steps 5] [--tree DIR]
        [--only mg2,mg1,mg1fast,batch]

Steps of ``pressure_solver="multigrid"`` (Jacobi-20 diffusion) from the
impulse of ``reference_init`` (seed 0) and one more step: 2048² with two
cycles (``mg2``), one (``mg1``) and one with fast math (``mg1fast``, the
JAX bench's line), through ``StableFluids2D.step``; and (``batch``) 64
grids of 256² with two cycles through ``make_batched_step_fn``.  Each is
timed eager (CUDA events around ``--steps`` steps: what a caller sees) and
as a CUDA graph of one step (``checks.device_ms``: device time alone), in
two forms: as the path runs it, and inside ``cuda_ops.smooth_launches(0)``
(the smoother on the per-sweep damped K1, the route before K1-damp), in
turns forward and backward, the mean of each pair; with each form's
launches of one step, the states after one step held bit for bit, and one
step traced with ``torch.profiler`` (device ms of the smoother's kernels,
of the transfers' GEMMs and in all).  ``--tree DIR`` imports the package
from another checkout (a parent commit unpacked with ``git archive``) and
times its path alone; every run prints a digest of the state after one
step, so two trees' runs can be held bit for bit.  Prints the card's name
and power limit.  Exits non-zero without a card or on a difference.
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
# Kernel names of the smoother in a trace: K1-damp and the per-sweep K1's
# damped instantiation.
SMOOTHER = ("jacobi_damped_sweeps_kernel", "jacobi_sweep_kernel<true")


def traced(fn) -> tuple[float, float, float, int]:
    """One ``fn()`` under ``torch.profiler``: device ms of the smoother's
    kernels, of the GEMMs and of every kernel, and the smoother's
    launches."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    smooth = gemm = busy = 0.0
    launches = 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = evt.time_range.elapsed_us() / 1e3
        busy += ms
        if any(k in evt.name for k in SMOOTHER):
            smooth += ms
            launches += 1
        elif "gemm" in evt.name.lower():
            gemm += ms
    return smooth, gemm, busy, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--tree", default=None)
    ap.add_argument("--only", default="mg2,mg1,mg1fast,batch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_mg_steps: no CUDA device", file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve() if args.tree else ROOT
    sys.path.insert(0, str(tree))
    from fluidsimulationcuda_torch import (SimConfig, StableFluids2D,
                                           batched_init, make_batched_step_fn,
                                           reference_init)
    from fluidsimulationcuda_torch.kernels import build, checks
    from fluidsimulationcuda_torch.kernels import cuda_ops as co

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}; tree {tree}; library "
          f"{build.build()}")
    mg2 = SimConfig(n=2046, jacobi_iters=20, backend="cuda", device="cuda",
                    pressure_solver="multigrid", mg_cycles=2)
    runs = {"mg2": ("2048² multigrid, 2 cycles", mg2, 0),
            "mg1": ("2048² multigrid, 1 cycle", mg2.replace(mg_cycles=1), 0),
            "mg1fast": ("2048² multigrid, 1 cycle, fast_math",
                        mg2.replace(mg_cycles=1, fast_math=True), 0),
            "batch": ("64 × 256² multigrid, 2 cycles", mg2.replace(n=254),
                      64)}
    forms = {"path": None}
    if not args.tree:
        forms["per-sweep smoother"] = 0

    def form(name):
        per = forms[name]
        return (contextlib.nullcontext() if per is None
                else co.smooth_launches(per))

    failures = 0
    for key in args.only.split(","):
        label, cfg, batch = runs[key]
        gen = torch.Generator(device="cuda").manual_seed(0)
        if batch:
            state, sources = batched_init(gen, cfg, batch)
            fn = make_batched_step_fn(cfg)

            def step(s, fn=fn, sources=sources):
                return fn(s, sources)
            state = fn(state, sources)
        else:
            state, sources = reference_init(gen, cfg)
            sim = StableFluids2D(cfg)
            state = sim.step(state, sources)
            step = sim.step
        state = step(state)
        torch.cuda.synchronize()
        outs, counts, trace = {}, {}, {}
        for name in forms:
            with form(name):
                co.reset_launch_counts()
                outs[name] = step(state)
                torch.cuda.synchronize()
                counts[name] = {k: n for k, n in co.launch_counts().items()
                                if n}
                trace[name] = traced(lambda: step(state))
        same = all(torch.equal(a, b) for name in forms
                   for a, b in zip(outs[name][:3], outs["path"][:3]))
        failures += not same
        digest = hashlib.sha256(b"".join(
            f.cpu().numpy().tobytes() for f in outs["path"][:3]
        )).hexdigest()[:16]
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
        for name in forms:
            smooth, gemm, busy, n = trace[name]
            print(f"{label}, {name}: {eager[name]:.4f} ms/step eager, "
                  f"{graph[name]:.4f} as a CUDA graph, "
                  f"{sum(counts[name].values())} launches {counts[name]}; "
                  f"traced: smoother {smooth:.4f} ms in {n} launches "
                  f"({100 * smooth / busy:.1f}%), GEMMs {gemm:.4f} "
                  f"({100 * gemm / busy:.1f}%), all {busy:.4f} ({card})",
                  flush=True)
        print(f"{label}: state after one step "
              f"{'equal bit for bit' if same else 'DIFFERS'} across forms, "
              f"digest {digest}", flush=True)
    print(f"{failures} failure(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
