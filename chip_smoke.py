#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fluidsimulationcuda_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (non-zero exit, no result line):

1. environment: torch, CUDA and nvcc versions, the card's name and power limit;
2. build of the CUDA kernels from ``fluidsimulationcuda_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. every 2-D kernel against its plain PyTorch version on the card at the
   2048² shapes of the main path (max|Δ| <= 1e-5), plus device times of
   both beside the bound;
3b. every 3-D kernel the same way at 256³;
4. the six golden fixtures ``tests/golden/*.npz`` through the ``cuda``
   backend (atol 1e-5);
5. the 2-D main path, ``StableFluids2D.step`` at 2048² (n=2046), 20 Jacobi
   iterations, parity mode: one impulse step plus 20, launch counts checked
   against the design, state held against the ``reference`` backend on the
   same CUDA tensors, ms/step and Mcell-updates/s;
6. the same in the compensated perf mode (Chebyshev, fast math);
7. 8192² (n=8190), 40 iterations, parity mode: three steps, finite state;
8. the 3-D main path, ``StableFluids3D.step`` at 256³ (n=254), 20 Jacobi
   iterations, parity mode: as phase 5, plus a forced trajectory (sources
   scaled by 0.05 every step) held against the ``reference`` backend after
   20 steps;
9. the same in the 3-D compensated mode (``PERF_POINT_3D``), without and
   with fast math.

The line before the last is ``{"kernels": [...]}``: per kernel its launches
in its main path's run (phase 5 for the 2-D kernels, phase 8 for the 3-D
ones), its max|Δ| from phase 3 or 3b, its device time beside its plain
version's, and its bound.  The last line is ``{"ok": true, "device":
{...}}``.  Without a CUDA device the script exits non-zero before any phase.
"""
from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
ROOT = os.path.dirname(os.path.abspath(__file__))
TPU_KERNELS = "fluidsimulationcuda_tpu/kernels/pallas_ops.py"
TPU_KERNELS_3D = "fluidsimulationcuda_tpu/kernels/pallas_ops_3d.py"
CSRC = "fluidsimulationcuda_torch/csrc"
# CUDA kernel -> (its source, the pallas_call it replaces on the main path).
KERNEL_SOURCES = {
    "jacobi_sweep": (f"{CSRC}/jacobi.cu", f"{TPU_KERNELS}:645"),
    "divergence": (f"{CSRC}/project.cu", f"{TPU_KERNELS}:899"),
    "gradient": (f"{CSRC}/project.cu", f"{TPU_KERNELS}:899"),
    "advect": (f"{CSRC}/advect.cu", f"{TPU_KERNELS}:1182"),
    "dens_advect": (f"{CSRC}/dens_advect.cu", f"{TPU_KERNELS}:1480"),
    "jacobi3_sweep": (f"{CSRC}/jacobi3.cu", f"{TPU_KERNELS_3D}:458"),
    "divergence3": (f"{CSRC}/project3.cu", f"{TPU_KERNELS_3D}:1085"),
    "gradient3": (f"{CSRC}/project3.cu", f"{TPU_KERNELS_3D}:1101"),
    "advect3": (f"{CSRC}/advect3.cu", f"{TPU_KERNELS_3D}:728"),
}


def phase(title: str) -> None:
    print(f"\n=== {title}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def expected_launches(cfg) -> dict[str, int]:
    """Kernel launches of one step of ``cfg`` with one sweep per launch."""
    k_vel = k_dens = cfg.jacobi_iters
    if cfg.diffusion_solver == "chebyshev":
        k_vel = k_dens = cfg.cheby_iters
    elif cfg.diffusion_solver == "chebyshev-dens":
        k_dens = cfg.cheby_dens_iters
    k_p = (cfg.press_cheby_iters if cfg.pressure_solver == "chebyshev"
           else cfg.jacobi_iters)
    return {"jacobi_sweep": 2 * k_vel + 2 * k_p + (k_dens - 1),
            "divergence": 2, "gradient": 2, "advect": 1, "dens_advect": 1}


def expected_launches3(cfg) -> dict[str, int]:
    """Kernel launches of one 3-D step of ``cfg`` with one sweep per launch:
    three velocity diffusions, two pressure solves and the density
    diffusion on K5, one K7 and one K8 per projection, one K6 for the
    (u, v, w) self-advection triple and one for the density."""
    k_vel = (cfg.cheby_iters if cfg.diffusion_solver == "chebyshev"
             else cfg.jacobi_iters)
    k_dens = {"chebyshev": cfg.cheby_iters,
              "chebyshev-dens": cfg.cheby_dens_iters}.get(
                  cfg.diffusion_solver, cfg.jacobi_iters)
    k_p = (cfg.press_cheby_iters if cfg.pressure_solver == "chebyshev"
           else cfg.jacobi_iters)
    return {"jacobi3_sweep": 3 * k_vel + 2 * k_p + k_dens,
            "divergence3": 2, "gradient3": 2, "advect3": 2}


def fields(state) -> list[tuple[str, torch.Tensor]]:
    return [(name, x) for name, x in zip(state._fields, state)
            if x is not None]


def max_diff(a, b) -> float:
    return max(float((x - y).abs().max())
               for (_, x), (_, y) in zip(fields(a), fields(b)))


def require_close(a, b, rtol: float, atol: float, what: str) -> None:
    for (name, x), (_, y) in zip(fields(a), fields(b)):
        bad = (x - y).abs() > atol + rtol * y.abs()
        if bool(bad.any()):
            raise AssertionError(f"{what}: {name} differs in {int(bad.sum())} "
                                 f"cells, max|d|={float((x - y).abs().max()):.3e}")


def require_finite(state, what: str) -> None:
    for name, x in fields(state):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{what}: {name} is not finite")


def timed_steps(step_fn, state, steps: int) -> tuple[object, float]:
    """Run ``steps`` calls of ``step_fn(state)``; return the state and
    ms/step from CUDA events around them."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        state = step_fn(state)
    stop.record()
    stop.synchronize()
    return state, start.elapsed_time(stop) / steps


def main_path(cfg, label: str, card: str, steps: int,
              tol: tuple[float, float, float] | None,
              forced_tol: float | None = None) -> dict[str, int]:
    """Impulse step plus ``steps-1`` steps through ``StableFluids2D`` or
    ``StableFluids3D`` (by ``cfg.ndim``); check and return the launch counts
    of that run.  ``tol = (rtol, atol, last)`` holds step 1 to
    ``|d| <= atol + rtol*|ref|`` and step ``steps`` to ``max|d| <= last``
    against the ``reference`` backend on the same tensors; None skips the
    comparison.  ``forced_tol`` also runs ``steps-1`` steps of both backends
    with the sources scaled by 0.05 firing every step (the forced twin of
    the JAX bench, ``bench.py:405-406``) and holds the last to
    ``max|d| <= forced_tol``.  Then times the step: eager with CUDA events
    (what a caller sees) and as a CUDA graph (device time alone; the
    difference is host and launch overhead)."""
    from fluidsimulationcuda_torch import (Sources, StableFluids2D,
                                           StableFluids3D, reference_init,
                                           step, step3, zero_sources)
    from fluidsimulationcuda_torch.kernels import checks, cuda_ops

    if cfg.ndim == 3:
        model, step_fn, design = StableFluids3D, step3, expected_launches3
    else:
        model, step_fn, design = StableFluids2D, step, expected_launches
    gen = torch.Generator(device=cfg.device).manual_seed(SEED)
    state0, sources = reference_init(gen, cfg)
    sim = model(cfg)
    torch.cuda.synchronize()
    cuda_ops.reset_launch_counts()
    first = sim.step(state0, sources)
    state = first
    for _ in range(steps - 1):
        state = sim.step(state)
    torch.cuda.synchronize()
    counts = cuda_ops.launch_counts()
    per_step = design(cfg)
    want = {k: steps * per_step.get(k, 0) for k in cuda_ops.KERNELS}
    print(f"{label}: launches {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts} != {want}")
    require_finite(state, label)
    ref = cfg.replace(backend="reference")
    if tol is not None:
        rtol, atol, last = tol
        zeros = zero_sources(ref)
        r_first = step_fn(ref, state0, sources)
        d1 = max_diff(first, r_first)
        require_close(first, r_first, rtol, atol, f"{label} step 1")
        r_state, ref_ms = timed_steps(lambda s: step_fn(ref, s, zeros),
                                      r_first, steps - 1)
        dn = max_diff(state, r_state)
        print(f"{label}: max|d| vs reference backend: step 1 {d1:.3e}, "
              f"step {steps} {dn:.3e}; reference backend {ref_ms:.4f} ms/step")
        if not dn <= last:
            raise AssertionError(f"{label}: step {steps} max|d| {dn:.3e} > {last}")
    if forced_tol is not None:
        drive = Sources(*(None if s is None else 0.05 * s for s in sources))
        forced, r_forced = state0, state0
        for _ in range(steps - 1):
            forced = sim.step(forced, drive)
            r_forced = step_fn(ref, r_forced, drive)
        require_finite(forced, f"{label} forced")
        df = max_diff(forced, r_forced)
        scale = max(float(x.abs().max()) for _, x in fields(r_forced))
        print(f"{label}: forced trajectory, step {steps - 1}: max|d| vs "
              f"reference backend {df:.3e} (max|field| {scale:.3e})")
        if not df <= forced_tol:
            raise AssertionError(f"{label}: forced max|d| {df:.3e} > "
                                 f"{forced_tol}")
    state, ms = timed_steps(sim.step, state, max(steps - 1, 2))
    require_finite(state, label)
    graph_ms = checks.device_ms(lambda: sim.step(state), reps=3)
    print(f"{label}: {ms:.4f} ms/step eager, "
          f"{cfg.num_cells / (ms * 1e-3) / 1e6:.1f} Mcell-updates/s; "
          f"{graph_ms:.4f} ms/step as a CUDA graph (device busy "
          f"{100 * graph_ms / ms:.1f}% of the eager step) ({card})")
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA device")
    sys.path.insert(0, ROOT)
    from fluidsimulationcuda_torch import SimConfig, Sources, simulate, zero_state
    from fluidsimulationcuda_torch.core.config import perf_operating_point
    from fluidsimulationcuda_torch.kernels import build, checks, cuda_ops

    phase("1 environment")
    nvcc = subprocess.run([build.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout.strip()
    card = card_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch CUDA {torch.version.cuda}")
    print(f"nvcc: {nvcc.splitlines()[-1]}")
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s))")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("2 build")
    t0 = time.perf_counter()
    print(f"library: {build.build(verbose=True)}")
    build.load()
    print(f"build + load: {time.perf_counter() - t0:.2f} s")

    phase("3 kernels against their plain versions (side 2048)")
    errs = dict.fromkeys(cuda_ops.KERNELS, 0.0)
    compare(checks.kernel_checks(2048, "cuda", SEED), checks.TOL, errs)
    times = kernel_times(checks.timing_checks(2048, "cuda", SEED), "2048²",
                         card)

    phase("3b 3-D kernels against their plain versions (side 256)")
    compare(checks.kernel_checks3(256, "cuda", SEED), checks.TOL, errs)
    times.update(kernel_times(checks.timing_checks3(256, "cuda", SEED),
                              "256³", card))

    phase("4 golden fixtures through the cuda backend")
    paths = sorted(glob.glob(os.path.join(ROOT, "tests", "golden", "*.npz")))
    if len(paths) != 6:
        raise AssertionError(f"expected 6 golden fixtures, found {len(paths)}")
    for path in paths:
        with np.load(path) as z:
            n, steps, iters = int(z["n"]), int(z["steps"]), int(z["iters"])
            cfg = SimConfig(n=n, jacobi_iters=iters, backend="cuda",
                            device="cuda")
            src = Sources(*(torch.from_numpy(np.array(z[k])).cuda()
                            for k in ("dens_src", "u_src", "v_src")))
            out = simulate(cfg, zero_state(cfg), src, steps)
            err = max(float(np.abs(t.cpu().numpy() - z[k]).max())
                      for t, k in zip(out[:3], ("dens", "u", "v")))
        print(f"  {os.path.basename(path)}: max|d| {err:.3e}")
        if not err <= 1e-5:
            raise AssertionError(f"{path}: max|d| {err:.3e} > 1e-5")

    phase("5 main path: 2048² parity, 20 iterations")
    parity = SimConfig(n=2046, jacobi_iters=20, backend="cuda", device="cuda")
    launches = main_path(parity, "2048² parity", card, 21,
                         tol=(1e-5, 2e-5, 1e-4))

    phase("6 main path: 2048² compensated perf mode")
    rho, k_d, k_p = perf_operating_point(2048)
    cheby = parity.replace(pressure_solver="chebyshev",
                           diffusion_solver="chebyshev", cheby_rho=rho,
                           cheby_iters=k_d, cheby_press_iters=k_p)
    label = f"2048² perf (rho={rho}, k_d={k_d}, k_p={k_p})"
    # The reference backend, like the JAX package's, ignores fast_math: it
    # is held to the parity tolerances without it, and the fast run (the
    # perf mode proper; its kernels match their plain fast forms in phase 3)
    # differs from it by the reciprocal form's roundings, which the
    # velocity self-advection amplifies by dt*n per cell of backtrace.
    main_path(cheby, label + " without fast_math", card, 21,
              tol=(1e-5, 2e-5, 1e-4))
    main_path(cheby.replace(fast_math=True), label + " fast_math", card, 21,
              tol=(0.0, 1e-4, 1e-4))

    phase("7 8192² parity, 40 iterations")
    big = SimConfig(n=8190, jacobi_iters=40, backend="cuda", device="cuda")
    main_path(big, "8192² parity", card, 3, tol=None)

    phase("8 3-D main path: 256³ parity, 20 iterations")
    parity3 = SimConfig(n=254, ndim=3, jacobi_iters=20, backend="cuda",
                        device="cuda")
    launches3 = main_path(parity3, "256³ parity", card, 21,
                          tol=(1e-5, 2e-5, 1e-4), forced_tol=1e-4)

    phase("9 3-D main path: 256³ compensated mode")
    rho, k_d, k_p = perf_operating_point(256, ndim=3)
    comp3 = parity3.replace(pressure_solver="chebyshev",
                            diffusion_solver="chebyshev", cheby_rho=rho,
                            cheby_iters=k_d, cheby_press_iters=k_p)
    label = f"256³ compensated (rho={rho}, k_d={k_d}, k_p={k_p})"
    # As in phase 6: parity tolerances without fast math, 1e-4 with it.
    main_path(comp3, label + " without fast_math", card, 21,
              tol=(1e-5, 2e-5, 1e-4), forced_tol=1e-4)
    main_path(comp3.replace(fast_math=True), label + " fast_math", card, 21,
              tol=(0.0, 1e-4, 1e-4), forced_tol=1e-4)

    main_launches = {k: launches[k] + launches3[k] for k in cuda_ops.KERNELS}
    kernels = [{
        "name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
        "replaces": KERNEL_SOURCES[name][1],
        "launches": main_launches[name], "max_abs_err": errs[name],
        "ms": times[name][0], "plain_ms": times[name][1],
        "bound_ms": times[name][2], "bound_by": times[name][3],
        # No single PyTorch call computes any of these functions (a sweep
        # with its border rule, a clamped semi-Lagrangian gather, a
        # stencil with its ghost layer).
        "library_ms": None,
    } for name in cuda_ops.KERNELS]
    print()
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def compare(check_list, tol: float, errs: dict[str, float]) -> None:
    """Run each check's kernel and plain version on the same inputs and
    hold them to ``max|d| <= tol``; record the worst per kernel."""
    from fluidsimulationcuda_torch.kernels import checks

    for c in check_list:
        got, want = c.run(), c.plain()
        torch.cuda.synchronize()
        err = checks.max_abs_diff(got, want)
        print(f"  {c.label:45s} max|d| {err:.3e}")
        if not err <= tol:
            raise AssertionError(f"{c.label}: max|d| {err:.3e} > {tol}")
        for k in c.kernels:
            errs[k] = max(errs[k], err)


def kernel_times(check_list, size: str,
                 card: str) -> dict[str, tuple[float, float, float, str]]:
    """Device ms of each timing check, kernel beside plain: CUDA graphs of
    20 calls, timed in turns plain, kernel, kernel, plain; with the bound
    (the least time for the bytes and operations of its launches)."""
    from fluidsimulationcuda_torch.kernels import checks

    times = {}
    print(f"  device ms per call at {size} (CUDA graph of 20 calls; {card}):")
    for c in check_list:
        p1 = checks.device_ms(c.plain)
        k1 = checks.device_ms(c.run)
        k2 = checks.device_ms(c.run)
        p2 = checks.device_ms(c.plain)
        bound, bound_by = c.bound()
        kernel, plain = (k1 + k2) / 2, (p1 + p2) / 2
        times[c.label] = (kernel, plain, bound, bound_by)
        print(f"  {c.label:45s} kernel {kernel:.5f} ms  plain {plain:.5f} ms"
              f"  bound {bound:.5f} ms ({bound_by}; "
              f"{100 * bound / kernel:.1f}% of it)")
    return times


if __name__ == "__main__":
    main()
