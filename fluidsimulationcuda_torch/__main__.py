"""Command-line interface (PyTorch twin of ``fluidsimulationcuda_tpu.__main__``).

The reference ships 19 standalone ``main()`` binaries, each a hard-wired
variant run (``./binary <block_dim_x> <block_dim_y>``,
``naivePar/...BlockPerElement-Naive.cu:345-348``).  Here one CLI covers the
same surface, on the card unless ``--device cpu`` asks for the CPU:

  python -m fluidsimulationcuda_torch run      --n 510 --steps 100 --save out.npz
  python -m fluidsimulationcuda_torch run      --resume out.npz --steps 50
  python -m fluidsimulationcuda_torch profile  --n 2046
  python -m fluidsimulationcuda_torch datagen  --n 254 --batch 64 --steps 20 --out traj.npz
  python -m fluidsimulationcuda_torch info

Checkpoints are the JAX package's format: either CLI resumes the other's.
Nothing here probes for a GPU or falls back to the CPU: a missing card, a
failed kernel build or a failed launch raises.
"""
from __future__ import annotations

import argparse
import functools
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .core.config import SimConfig
from .core.state import reference_init, zero_sources
from .utils.checkpoint import load_checkpoint, save_checkpoint


def _add_common(p):
    p.add_argument("--n", type=int, default=510)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--backend", default="auto",
                   choices=["auto", "reference", "cuda"],
                   help="auto: the CUDA kernels on a CUDA --device, the "
                        "plain torch ops otherwise")
    p.add_argument("--device", default="cuda",
                   help="where the state lives and the ops run (default "
                        "cuda; cpu runs the plain torch ops)")
    p.add_argument("--cmax", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dt", type=float, default=0.016)
    p.add_argument("--visc", type=float, default=0.0025)
    p.add_argument("--diff", type=float, default=0.1,
                   help="the reference's alpha = dt*diff*n^2 scaling makes "
                        "large grids hyper-diffusive; lower for demos")
    p.add_argument("--ndim", type=int, default=2, choices=(2, 3),
                   help="3 runs the smoke-volume solver (reference scenario "
                        "only; scenarios/PNG are 2-D)")
    # The solver knobs --perf overrides default to None (a sentinel) so
    # "explicitly passed" is detectable even when the passed value equals
    # the resolved default — _cfg() resolves None to the real defaults.
    p.add_argument("--pressure-solver", default=None,
                   choices=["jacobi", "multigrid", "cg", "chebyshev"],
                   help="pressure solve (default jacobi)")
    p.add_argument("--diffusion-solver", default=None,
                   choices=["jacobi", "chebyshev", "chebyshev-dens"],
                   help="default jacobi; chebyshev-dens accelerates only "
                        "the density solve (velocity stays bit-parity; "
                        "see core/config.py)")
    p.add_argument("--fast-math", action="store_true", default=None,
                   help="reciprocal-multiply Jacobi sweeps (~1 ulp/sweep "
                        "from parity; pairs with --pressure-solver "
                        "chebyshev for the perf mode)")
    p.add_argument("--cheby-iters", type=int, default=None,
                   help="sweeps per solve in chebyshev modes (default 8)")
    p.add_argument("--cheby-press-iters", type=int, default=None,
                   help="decoupled pressure sweep count (default 0 = "
                        "follow --cheby-iters); the compensated perf mode "
                        "is --diffusion-solver chebyshev --pressure-solver "
                        "chebyshev --cheby-iters 10 --cheby-press-iters 14 "
                        "--cheby-rho 0.9 --fast-math")
    p.add_argument("--cheby-rho", type=float, default=None,
                   help="Chebyshev interval parameter (default 0.99; free "
                        "knob, not a stability bound; ops/chebyshev.py)")
    p.add_argument("--perf", action="store_true",
                   help="apply the validated compensated perf-mode preset "
                        "for --ndim/--n (size-coupled, from "
                        "core/config.PERF_POINTS_2D — e.g. 2-D 2048²: "
                        "cheby-10 @ rho=0.9 + 14 pressure sweeps; 3-D: "
                        "cheby-10 @ rho=0.85 + 12 sweeps; + fast-math).  "
                        "Operating points are measured per "
                        "dimensionality/size; explicit solver flags are "
                        "overridden (with a warning).  Pair with "
                        "--validate to run the solver-quality bars at YOUR "
                        "size before trusting the preset there")


# Solver knobs --perf overrides; (flag dest, resolved default when the
# None sentinel survives to _build_cfg).
_PERF_OVERRIDDEN = (
    ("pressure_solver", "jacobi"), ("diffusion_solver", "jacobi"),
    ("fast_math", False), ("cheby_iters", 8), ("cheby_press_iters", 0),
    ("cheby_rho", 0.99),
)


def _cfg(args):
    if getattr(args, "perf", False):
        # None is the "not passed" sentinel, so ANY explicit flag —
        # including one passing the default value — triggers the warning.
        clobbered = [f for f, _ in _PERF_OVERRIDDEN
                     if getattr(args, f, None) is not None]
        if clobbered:
            print("WARNING: --perf overrides explicitly passed "
                  + ", ".join("--" + f.replace("_", "-")
                              for f in clobbered)
                  + " (the preset is a validated operating POINT; drop "
                    "--perf to tune knobs individually)", file=sys.stderr)
        from .core.config import perf_operating_point

        ndim = getattr(args, "ndim", 2)
        rho, k_d, k_p = perf_operating_point(args.n + 2, ndim)
        args.pressure_solver = "chebyshev"
        args.diffusion_solver = "chebyshev"
        args.fast_math = True
        args.cheby_iters = k_d
        args.cheby_press_iters = k_p
        args.cheby_rho = rho
    cfg = _build_cfg(args)
    _check_gates(cfg)
    return cfg


def _check_gates(cfg: SimConfig) -> None:
    """Raise ``ValueError`` unless the kernels take the grid of ``cfg``,
    asked before any tensor is allocated: on the ``cuda`` backend, the grid
    gate of ``cuda_ops.check_grid``.  ``SimConfig`` checked the rest when
    it was built.  No solver falls back: each gate depends on the grid
    alone, which every solver of one size shares."""
    if cfg.resolved_backend == "cuda":
        from .kernels.cuda_ops import check_grid

        check_grid(cfg.grid_shape, cfg.ndim)


def _build_cfg(args):
    def knob(f, default):
        v = getattr(args, f, None)
        return default if v is None else v

    return SimConfig(n=args.n, jacobi_iters=args.iters, backend=args.backend,
                     max_courant=args.cmax, dt=args.dt, visc=args.visc,
                     diff=args.diff,
                     pressure_solver=knob("pressure_solver", "jacobi"),
                     diffusion_solver=knob("diffusion_solver", "jacobi"),
                     fast_math=knob("fast_math", False),
                     cheby_iters=knob("cheby_iters", 8),
                     cheby_press_iters=knob("cheby_press_iters", 0),
                     cheby_rho=knob("cheby_rho", 0.99),
                     ndim=getattr(args, "ndim", 2),
                     device=getattr(args, "device", "cuda"))


def _generator(cfg: SimConfig, seed: int) -> torch.Generator:
    return torch.Generator(device=cfg.device).manual_seed(seed)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _gather_verdict(cfg: SimConfig, dmax: float) -> str:
    """What the audited displacement says of the run's gathers: under
    ``advect_mode="windowed"`` exact or clamped in the window, otherwise
    exact at any displacement."""
    if cfg.advect_mode != "windowed":
        return (f"exact: advect_mode {cfg.advect_mode!r} gathers exactly at "
                f"any displacement")
    verdict = ("exact" if dmax < cfg.max_courant
               else "CLAMPED — rerun with a higher --cmax")
    return f"{verdict} for window {cfg.max_courant}"


def _validate(cfg: SimConfig) -> None:
    """``run --validate``: the solver-quality bars of ``cfg`` against its
    parity twin at this size."""
    if cfg.ndim == 3:
        print("--validate: bars are 2-D; skipping", file=sys.stderr)
        return
    if (cfg.pressure_solver == "jacobi" and cfg.diffusion_solver == "jacobi"
            and not cfg.fast_math):
        # The parity twin is jacobi+jacobi WITHOUT fast_math; a
        # fast-math-only config is numerics-affecting and still gets the
        # divergence bar below.
        print("--validate: parity jacobi config IS the bar; skipping",
              file=sys.stderr)
        return
    from .utils.validate import validate_perf_point

    parity = cfg.replace(pressure_solver="jacobi", diffusion_solver="jacobi",
                         fast_math=False)
    print(f"validating solver point at n={cfg.n} against "
          f"jacobi-{cfg.jacobi_iters} (the bench.py bars)...",
          file=sys.stderr)
    bars = validate_perf_point(parity, cfg)
    for k, v in bars.items():
        print(f"  {k}: {v:.3e}" if isinstance(v, float) else f"  {k}: {v}",
              file=sys.stderr)
    if bars["ok"]:
        print("validation PASSED: the solver point is no worse than the "
              "parity solve at this size", file=sys.stderr)
    else:
        print("validation FAILED at this size — operating points are "
              "size-coupled; tune --cheby-iters/--cheby-press-iters/"
              "--cheby-rho or drop --perf.  Continuing the run with the "
              "requested config.", file=sys.stderr)


def cmd_run(args) -> None:
    continuous = False
    if args.resume:
        state, cfg, start_step = load_checkpoint(args.resume,
                                                 device=args.device)
        sources = None
        print(f"resumed step {start_step}, n={cfg.n}", file=sys.stderr)
    else:
        from .models.scenarios import SCENARIOS

        cfg = _cfg(args)
        if cfg.ndim == 3:
            # As in the JAX CLI, 3-D runs the reference impulse whatever
            # --scenario says.
            state, sources = reference_init(_generator(cfg, args.seed), cfg)
        else:
            state, sources, continuous = SCENARIOS[args.scenario](
                _generator(cfg, args.seed), cfg)
        start_step = 0
    if getattr(args, "validate", False):
        _validate(cfg)
    # The audited step returns the largest backtrace displacement beside
    # the state, a 0-dim device tensor: the loop never waits for the card.
    if cfg.ndim == 3:
        from .models.stable_fluids_3d import step_audited3

        step = functools.partial(step_audited3, cfg)
    else:
        from .models.stable_fluids_2d import step_audited

        step = functools.partial(step_audited, cfg)
    zeros = zero_sources(cfg)
    disps = []
    _synchronize(cfg.device)
    t0 = time.perf_counter()
    for k in range(args.steps):
        if sources is not None and (continuous or (k == 0 and start_step == 0)):
            src = sources
        else:
            src = zeros
        state, d = step(state, src)
        disps.append(d)
    _synchronize(cfg.device)
    dt_total = time.perf_counter() - t0
    dmax = float(torch.stack(disps).max()) if disps else 0.0
    verdict = _gather_verdict(cfg, dmax)
    # Perf hint: the gather cost is (2C+1)^ndim terms, so an oversized
    # window is pure waste — tell the user the smallest exact one.
    smallest = max(1, int(math.ceil(dmax + 0.25)))
    if dmax < cfg.max_courant and smallest < cfg.max_courant:
        verdict += f"; smallest exact window: --cmax {smallest}"
    # The stability check the reference stubbed out and never wrote
    # (FluidSequential.c:309): finite fields and the final state's window
    # fit (the per-step audit above covers the trajectory).
    from .utils.stability import check_stability

    rep = check_stability(cfg, state)
    stable = "stable" if bool(rep.finite) else "UNSTABLE (non-finite!)"
    print(
        f"{args.steps} steps in {dt_total:.3f}s "
        f"({dt_total / args.steps * 1e3:.2f} ms/step incl. dispatch); "
        f"dens sum={float(state.dens.sum()):.4f} "
        f"max={float(state.dens.max()):.5f}; "
        f"audited displacement {dmax:.3f} cells ({verdict}); {stable}, "
        f"max speed {float(rep.max_speed):.4f}",
        file=sys.stderr,
    )
    if args.save:
        save_checkpoint(args.save, state, cfg, step=start_step + args.steps)
        print(f"saved {args.save}", file=sys.stderr)
    if args.png:
        from .utils.viz import save_density_png

        dens_img = state.dens
        title = (f"{args.scenario if not args.resume else 'resumed'}"
                 f" @ step {start_step + args.steps}")
        if dens_img.ndim == 3:  # 3-D run: render the mid-z plane
            mid = dens_img.shape[0] // 2
            dens_img = dens_img[mid]
            title += f" (z={mid} slice)"
        save_density_png(args.png, dens_img, title=title)
        print(f"wrote {args.png}", file=sys.stderr)


def cmd_profile(args) -> None:
    from .utils.timing import profile_phases

    cfg = _cfg(args)
    if args.trace:
        # A torch.profiler trace around a few steps (Chrome JSON, for
        # chrome://tracing or Perfetto): the deep-dive companion to the
        # phase table, standing in for the reference's external Nsight
        # Compute workflow (document/main.tex:219).
        from .models.stable_fluids_2d import make_step_fn

        state, sources = reference_init(_generator(cfg, args.seed), cfg)
        step = make_step_fn(cfg)
        zeros = zero_sources(cfg)
        state = step(state, sources)
        _synchronize(cfg.device)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cfg.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            for _k in range(5):
                state = step(state, zeros)
            _synchronize(cfg.device)
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, "trace.json")
        prof.export_chrome_trace(path)
        print(f"trace written to {path}", file=sys.stderr)
    report = profile_phases(cfg, _generator(cfg, args.seed))
    print(report.pretty())


def cmd_datagen(args) -> None:
    from .models.batched import generate_trajectories

    cfg = _cfg(args)
    # A torch.Generator is stateful: the probe and the run each take a
    # fresh one seeded alike, so the probe audits the very sims written.
    if not args.no_auto_cmax:
        from .models.batched import select_cmax_batched

        cmax, probed = select_cmax_batched(_generator(cfg, args.seed), cfg,
                                           args.batch)
        if cmax > cfg.max_courant:
            print(f"WARNING: probed displacement {probed:.3f} cells exceeds "
                  f"--cmax {cfg.max_courant}; growing the window to "
                  f"cmax={cmax} to keep the run exact", file=sys.stderr)
        cfg = cfg.replace(max_courant=cmax)
        print(f"auto-selected advect window cmax={cfg.max_courant} "
              f"(probed displacement {probed:.3f} cells)", file=sys.stderr)
    t0 = time.perf_counter()
    final, snaps, max_disp = generate_trajectories(
        _generator(cfg, args.seed), cfg, args.batch, args.steps,
        snapshot_every=args.snapshot_every,
    )
    payload = {"dens_final": final.dens.cpu().numpy()}
    if snaps is not None:
        payload["dens_snapshots"] = snaps.cpu().numpy()
    t1 = time.perf_counter()
    np.savez_compressed(args.out, **payload)
    t2 = time.perf_counter()
    d = float(max_disp)
    print(f"audited max backtrace displacement {d:.3f} cells "
          f"({_gather_verdict(cfg, d)})", file=sys.stderr)
    print(f"wrote {args.out}: "
          + ", ".join(f"{k}{v.shape}" for k, v in payload.items()),
          file=sys.stderr)
    print(f"generated in {t1 - t0:.3f}s (copy to the host included), "
          f"compressed and written in {t2 - t1:.3f}s", file=sys.stderr)


def cmd_info(_args) -> None:
    from .kernels import build

    print(f"torch {torch.__version__} (built for CUDA {torch.version.cuda})")
    if torch.cuda.is_available():
        print(f"devices: {torch.cuda.device_count()} x "
              f"{torch.cuda.get_device_name(0)}")
        try:
            card = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], check=True, capture_output=True,
                text=True).stdout.strip()
        except (OSError, subprocess.CalledProcessError) as e:
            card = f"nvidia-smi unavailable ({e})"
        print(f"card: {card}")
    else:
        print("devices: no CUDA device")
    print(f"kernel build directory: {build.BUILD_DIR}")
    built = sorted(p.name for p in build.BUILD_DIR.glob("libfsc_*.so"))
    print(f"built libraries: {', '.join(built) if built else 'none'}")
    try:
        nvcc = build.nvcc_path()
        version = subprocess.run([nvcc, "--version"], check=True,
                                 capture_output=True, text=True).stdout
    except (RuntimeError, OSError, subprocess.CalledProcessError) as e:
        print(f"nvcc: unavailable ({e}); the kernels cannot be built here")
        return
    print(f"nvcc: {nvcc} ({version.strip().splitlines()[-1]})")
    lib = build.library_path()
    print(f"library for these sources: {lib.name} "
          f"({'built' if lib.exists() else 'not built yet'})")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="fluidsimulationcuda_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run a simulation")
    _add_common(p)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--save", default=None, help="checkpoint path to write")
    p.add_argument("--resume", default=None, help="checkpoint path to load")
    p.add_argument("--scenario", default="reference",
                   choices=["reference", "plume", "vortex-pair", "jets"])
    p.add_argument("--png", default=None, help="render final density to PNG")
    p.add_argument("--validate", action="store_true",
                   help="run the solver-quality bars (divergence + "
                        "residual ratios vs the parity jacobi solve) once "
                        "at THIS size/solver before the timed run — "
                        "operating points are size-coupled, so a preset "
                        "validated at 2048² must be re-checked elsewhere")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("profile", help="per-phase timing report")
    _add_common(p)
    p.add_argument("--trace", default=None,
                   help="also write a torch.profiler trace (Chrome JSON) "
                        "into this directory")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("datagen", help="batched trajectory generation")
    _add_common(p)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--snapshot-every", type=int, default=0)
    p.add_argument("--out", default="trajectories.npz")
    p.add_argument("--no-auto-cmax", action="store_true",
                   help="keep --cmax instead of probing the "
                        "trajectory for the smallest exact gather window")
    p.set_defaults(fn=cmd_datagen)

    p = sub.add_parser("info", help="environment info")
    p.set_defaults(fn=cmd_info)
    return ap


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
