#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch port's step on one GPU, from a
``torch.profiler`` trace.

    python3 dev/profile_torch_step.py --ndim 3 --n 254 --mode parity
    python3 dev/profile_torch_step.py --ndim 2 --n 2046 --mode compensated
    python3 dev/profile_torch_step.py --ndim 2 --n 2046 --slabs 8
    python3 dev/profile_torch_step.py --ndim 3 --n 254 --slabs 8

Runs the impulse step (sources from ``reference_init``, seed 0) and two more
steps on the ``cuda`` backend, then traces ``--steps`` steps of
``StableFluids2D`` or ``StableFluids3D`` (20 Jacobi iterations, or the
compensated mode's Chebyshev point with fast math) and prints, per CUDA
kernel, its launches and device ms per step, its share of the step, and
its time per launch; then the step's wall time (host clock around the
traced steps, ending in a synchronise) and the device's busy share (summed
kernel time over wall time).  ``--slabs P`` traces the multi-device
step on P slabs of the one card instead: row slabs in 2-D
(``parallel.make_sharded_step_fn``; ``--fuse-sweeps 8`` for slabs of 16
rows), z-slabs in 3-D (``parallel.make_sharded_step_fn_3d``); its halo
copies show as PyTorch's own copy kernels.  ``--batch B`` traces the
batched datagen step on B grids (2-D), windowed at the window
``select_cmax_batched`` probes.
``--forcing 0.05`` fires the sources, scaled, on every step, as the smoke
script's forced trajectory does.  ``--split NAME`` lists the launches of
each kernel whose name holds NAME apart by their order in the step (#1,
#2, ...): K6's self-advected triple and its density field, for instance,
are the 3-D step's first and second ``advect3_kernel`` launches.
``--parent DIR`` builds the kernels of another tree as well (a checkout
with the same C entry points, e.g. the parent commit unpacked with ``git
archive``) and traces the step four times, with its kernels, this tree's,
this tree's and its kernels again, on the same card in one process, each
trace from the same state.  ``--per-sweep`` does the same with this
tree's solves on the tiled kernels (K1, K9 on row slabs) and on the
per-sweep ones (``cuda_ops.launch_sweeps(0)``), the chains the tiled
kernels replaced: tiled, per-sweep, per-sweep, tiled.  ``--per-slab-gathers``
(3-D, with ``--slabs``) does the same with the z-slab step's gathers on the
grouped K14 and on the per-slab K14 after ``mesh._ext`` or ``mesh._gather``
(``Slab3OpSet.advect_group`` off), the route the grouped launch replaced:
grouped, per-slab, per-slab, grouped.  The card's name and power limit come
with the numbers.  Exits non-zero without a card or when the trace holds no
device time.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ndim", type=int, choices=(2, 3), default=3)
    ap.add_argument("--n", type=int, default=254)
    ap.add_argument("--mode", choices=("parity", "compensated"),
                    default="parity")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--forcing", type=float, default=0.0)
    ap.add_argument("--slabs", type=int, default=0)
    ap.add_argument("--fuse-sweeps", type=int, default=0)
    ap.add_argument("--split", action="append", default=[])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--per-sweep", action="store_true")
    ap.add_argument("--per-slab-gathers", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: no CUDA device")
    if args.per_slab_gathers and not (args.slabs and args.ndim == 3):
        raise SystemExit("profile_torch_step: --per-slab-gathers needs "
                         "--ndim 3 and --slabs")
    sys.path.insert(0, ROOT)
    from fluidsimulationcuda_torch import (SimConfig, Sources, StableFluids2D,
                                           StableFluids3D, reference_init,
                                           zero_sources)
    from fluidsimulationcuda_torch.core.config import perf_operating_point
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn,
                                                    make_sharded_step_fn_3d,
                                                    shard_state,
                                                    shard_state_3d)

    cfg = SimConfig(n=args.n, ndim=args.ndim, jacobi_iters=20,
                    fuse_sweeps=args.fuse_sweeps, backend="cuda",
                    device="cuda")
    if args.mode == "compensated":
        rho, k_d, k_p = perf_operating_point(args.n + 2, ndim=args.ndim)
        cfg = cfg.replace(pressure_solver="chebyshev",
                          diffusion_solver="chebyshev", cheby_rho=rho,
                          cheby_iters=k_d, cheby_press_iters=k_p,
                          fast_math=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, sources = reference_init(gen, cfg)
    drive = (Sources(*(None if s is None else args.forcing * s
                       for s in sources)) if args.forcing
             else zero_sources(cfg))
    if args.batch:
        from fluidsimulationcuda_torch import (batched_init,
                                               make_batched_step_fn,
                                               select_cmax_batched)
        from fluidsimulationcuda_torch.core.state import zero_sources_like
        cmax, _ = select_cmax_batched(
            torch.Generator(device="cuda").manual_seed(0), cfg, args.batch)
        cfg = cfg.replace(advect_mode="windowed", max_courant=cmax)
        state, sources = batched_init(gen, cfg, args.batch)
        drive = (Sources(*(None if s is None else args.forcing * s
                           for s in sources)) if args.forcing
                 else zero_sources_like(sources))
        step = make_batched_step_fn(cfg)
    elif args.slabs:
        mesh = make_mesh([torch.device("cuda", 0)] * args.slabs)
        make, shard = ((make_sharded_step_fn_3d, shard_state_3d)
                       if args.ndim == 3 else
                       (make_sharded_step_fn, shard_state))
        step = make(cfg, mesh)
        state, sources, drive = (shard(x, mesh)
                                 for x in (state, sources, drive))
    else:
        step = (StableFluids3D if args.ndim == 3 else StableFluids2D)(cfg).step
    state = step(state, sources)
    for _ in range(2):
        state = step(state, drive)
    torch.cuda.synchronize()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"{args.n + 2}^{args.ndim} {args.mode}, forcing {args.forcing}, "
          f"{args.slabs or 'no'} slabs, batch {args.batch or 'none'}"
          f"{f' (window {cfg.max_courant})' if args.batch else ''}, "
          f"{args.steps} traced steps ({card})")
    if args.per_sweep:
        from fluidsimulationcuda_torch.kernels import cuda_ops

        for per_launch in (None, 0, 0, None):
            print(f"\n[{'per-sweep' if per_launch == 0 else 'tiled'}]")
            with (cuda_ops.launch_sweeps(per_launch) if per_launch == 0
                  else contextlib.nullcontext()):
                step(state, drive)  # warm-up
                trace(step, state, drive, args)
        return
    if args.per_slab_gathers:
        from fluidsimulationcuda_torch.parallel.sharded3d import _ZSlabStep

        mesh = mesh.reshape(args.slabs, 1)
        exact = (cfg.n + 2) // args.slabs < cfg.max_courant + 1
        steps = {name: _ZSlabStep(cfg, mesh, False, exact)
                 for name in ("grouped", "per-slab")}
        steps["per-slab"].ops = steps["per-slab"].ops._replace(
            advect_group=None)
        for name in ("grouped", "per-slab", "per-slab", "grouped"):
            print(f"\n[{name} gathers{', exact' if exact else ''}]")
            steps[name](state, drive)  # warm-up
            trace(steps[name], state, drive, args)
        return
    if not args.parent:
        trace(step, state, drive, args)
        return
    from fluidsimulationcuda_torch.kernels import build
    libs = {"parent": build.open_library(build.build(
                csrc=args.parent / "fluidsimulationcuda_torch" / "csrc")),
            "this tree": build.load()}
    for tree in ("parent", "this tree", "this tree", "parent"):
        print(f"\n[{tree}'s kernels]")
        build._lib = libs[tree]
        step(state, drive)  # warm-up with these kernels
        trace(step, state, drive, args)  # each trace from the same state


def trace(step, state, drive, args):
    """Trace ``args.steps`` steps from ``state`` and print the table;
    returns the last state."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state = step(state, drive)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps

    per_kernel = collections.defaultdict(lambda: [0, 0.0])  # launches, us
    events = sorted((evt for evt in prof.events()
                     if evt.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda evt: evt.time_range.start)
    names = [evt.name.replace("(anonymous namespace)::", "").split("(")[0]
             for evt in events]
    totals, seen = collections.Counter(names), collections.Counter()
    for name, evt in zip(names, events):
        if any(part in name for part in args.split):
            per_step = totals[name] // args.steps
            seen[name] += 1
            name = f"{name} #{(seen[name] - 1) % per_step + 1}"
        entry = per_kernel[name]
        entry[0] += 1
        entry[1] += evt.time_range.elapsed_us()
    busy_ms = sum(us for _, us in per_kernel.values()) / 1e3 / args.steps
    if busy_ms <= 0:
        raise SystemExit("profile_torch_step: the trace holds no device "
                         "time")
    print(f"{'kernel':60s} {'launches/step':>13s} {'ms/step':>9s} "
          f"{'share':>6s} {'us/launch':>10s}")
    for name, (count, us) in sorted(per_kernel.items(),
                                    key=lambda kv: -kv[1][1]):
        ms = us / 1e3 / args.steps
        print(f"{name[:60]:60s} {count / args.steps:13.1f} {ms:9.4f} "
              f"{100 * ms / busy_ms:5.1f}% {us / count:10.2f}")
    print(f"device busy {busy_ms:.4f} ms/step of {wall_ms:.4f} ms/step wall "
          f"({100 * busy_ms / wall_ms:.1f}%; profiler on)")
    return state

if __name__ == "__main__":
    main()
