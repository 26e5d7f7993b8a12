#!/usr/bin/env python3
"""Subnormal and tiny values in the 2-D step's state, the step's device
time from that state with and without the subnormal ones, and the K1
solve's time on fields of each magnitude.

    python3 dev/step_subnormals.py [--n 2046] [--after 3,21,41] [--reps 5]

Runs the impulse step (``reference_init``, seed 0) and then steps without
sources through ``StableFluids2D`` on the ``cuda`` backend (20 Jacobi
iterations, parity), as ``chip_smoke.py`` phase 5 does: it times its graph
step from the state after 41 steps.  At each step count of ``--after`` it
prints, for the state, for one step's result from it and for the
divergence of its velocity (the rhs of its pressure solve), each field's
zeros and its nonzero values below 2^-126 (subnormal), 2^-110, 2^-102,
2^-96 and 2^-64, in cells.  Then the device ms of one step from that
state, as a CUDA graph (``checks.device_ms``) and as the summed kernel
time of a ``torch.profiler`` trace of ``--reps`` steps from it, with each
kernel's ms a step (the tiled K1's launches apart, #1, #2, ... by their
order in the step); and the same two times from the state with its
subnormal values set to zero.  Last, the 20-sweep solves of the step (the
source fold from a guess, the pressure's from a zero guess) as CUDA
graphs on random 2048² fields scaled by 2^e for each e of ``--scales``,
and on zero fields.  The card's name and power limit come with the
numbers.  Exits non-zero without a card or when a trace holds no device
time.
"""
from __future__ import annotations

import argparse
import collections
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


# Powers of two the value counts are taken below (-126: subnormal).
BELOW = (-126, -110, -102, -96, -64)


def magnitudes(named) -> str:
    """Per field of ``named`` ((name, tensor) pairs): its zeros and its
    nonzero values below each 2^e of ``BELOW``, in cells."""
    out = []
    for name, x in named:
        a = x.float().abs()
        counts = "/".join(str(int(((a != 0) & (a < 2.0 ** e)).sum()))
                          for e in BELOW)
        out.append(f"{name}: zero {int((a == 0).sum())}, below 2^"
                   f"{'/'.join(map(str, BELOW))} {counts}")
    return "; ".join(out)


def fields(state):
    return [(n, x) for n, x in zip(state._fields, state) if x is not None]


def flushed(state):
    tiny = torch.finfo(torch.float32).tiny
    return type(state)(*(None if x is None else
                         torch.where(x.float().abs() < tiny,
                                     torch.zeros_like(x), x)
                         for x in state))


def traced_ms(step, state, reps: int) -> tuple[float, dict[str, float]]:
    """Summed kernel ms a step over ``reps`` steps, each from ``state``,
    and each kernel's ms a step."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            step(state)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    names = [e.name.replace("(anonymous namespace)::", "")
             .removeprefix("void ").split("<")[0].split("(")[0]
             for e in events]
    per_step = collections.Counter(names)
    seen = collections.Counter()
    per_kernel = collections.defaultdict(float)
    for name, event in zip(names, events):
        if name == "jacobi_sweeps_kernel":
            seen[name] += 1
            name += f" #{(seen[name] - 1) % (per_step[name] // reps) + 1}"
        per_kernel[name] += event.time_range.elapsed_us() / 1e3 / reps
    total = sum(per_kernel.values())
    if total <= 0:
        raise SystemExit("step_subnormals: the trace holds no device time")
    return total, dict(per_kernel)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2046)
    ap.add_argument("--after", default="3,21,41")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--scales", default="0,-64,-96,-100,-102,-104,-110,-120")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_subnormals: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from fluidsimulationcuda_torch import (SimConfig, StableFluids2D,
                                           reference_init)
    from fluidsimulationcuda_torch.kernels import checks
    from fluidsimulationcuda_torch.kernels import cuda_ops as co

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    cfg = SimConfig(n=args.n, jacobi_iters=20, backend="cuda", device="cuda")
    sim = StableFluids2D(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state0, sources = reference_init(gen, cfg)
    state, done = sim.step(state0, sources), 1
    print(f"{args.n + 2}² parity, 20 iterations ({card})")
    for after in sorted(int(a) for a in args.after.split(",")):
        while done < after:
            state, done = sim.step(state), done + 1
        torch.cuda.synchronize()
        div = co.divergence_p(state.u, state.v, cfg.n)
        print(f"\nafter {after} steps: the state: "
              f"{magnitudes(fields(state))}\n  one step's result: "
              f"{magnitudes(fields(sim.step(state)))}\n  the divergence: "
              f"{magnitudes([('div', div)])}")
        for label, start in (("as it is", state),
                             ("subnormals set to 0", flushed(state))):
            graph = checks.device_ms(lambda start=start: sim.step(start),
                                     reps=3)
            total, per_kernel = traced_ms(sim.step, start, args.reps)
            print(f"  state {label}: graph {graph:.4f} ms/step, traced "
                  f"kernels {total:.4f} ms/step ({card})")
            for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
                print(f"    {name[:48]:48s} {ms:.5f} ms/step "
                      f"({100 * ms / total:.1f}%)")
    del state, sim
    t = checks._Inputs(2048, "cuda", 0)
    av = t.a_visc
    print(f"\n20-sweep solves on 2048² fields of each magnitude ({card}):")
    for e in [None, *(int(e) for e in args.scales.split(","))]:
        scale = 0.0 if e is None else 2.0 ** e
        src, x0 = t.src * scale, t.x0 * scale
        fold = checks.device_ms(lambda: co.fused_jacobi(
            1, src, x0, av, 1 + 4 * av, 20, src_dt=checks.DT))
        zero = checks.device_ms(lambda: co.fused_jacobi(
            0, x0, x0, 1.0, 4.0, 20, zero_init=True))
        print(f"  {'zeros' if e is None else f'random x 2^{e}':16s} "
              f"source fold {fold:.5f} ms, zero guess {zero:.5f} ms")


if __name__ == "__main__":
    main()
