#!/usr/bin/env python3
"""K3's bf16 form and K2's bf16 gradient of this tree against those of
another tree (a parent commit), on the card, on the same inputs in the same
process; then the steps that launch them, as CUDA graphs.

    python3 dev/bench_bf16_stencils.py --parent build/parent [--sizes 2048,8192,batch]
                                       [--no-steps]

Builds the kernel library of this tree and of ``--parent`` (a checkout
whose ``fluidsimulationcuda_torch/csrc`` is unpacked from ``git archive``
into a gitignored directory; a parent whose bf16 forms predate the vector
kernels is called through ``ParentBf16``) and times each call with one
library and then the other (device ms of a call, CUDA graphs of 20 calls,
``checks.device_ms``), at 2048², 8192² and on the datagen batch of 1024
grids of 256²:

- ``advect_bf16`` (K3's bf16 form): the u/v pair on the step's velocities
  (random, up to 2 cells: the call PERF.md's table times), on random ones
  up to 6 cells, smooth and shear ones (``checks.gather_velocities``), and
  one field; on the batch also the pair in a 1-cell window;
- ``gradient_bf16`` (K2's bf16 gradient) from a float32 pressure
  (``fused_project``'s stage) and from a bf16 one (``gradient_p``);
- the float32 K3 pair and K2 gradient, which this tree does not change.

The bf16 calls run in turns parent, each of this tree's forms
(``checks.BF16_FORMS``: K3's V = 4 and 2, the gradient's 8, 4 and 2, and
the one-cell kernel; ``cuda_ops.vector_widths``), the forms again in
reverse, parent; the float32 calls parent, this, this, parent.  Each line
prints the times, each form's against the parent's and its share of the
bound, and the width the path's launch takes (``cuda_ops.width_counts``).
Every call is
first held to its plain version in each form: the bf16 ones bit for bit,
the float32 ones within ``checks.TOL``.

Then, unless ``--no-steps``, the steps that launch them: bf16 and float32
at 2048² parity and compensated with fast math, 8192² parity at 40
iterations, and the datagen batch (``make_batched_step_fn`` in the window
``select_cmax_batched`` probes), each as a CUDA graph of 3 steps from the
state after three steps, parent, this, this, parent.  Exits non-zero
without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SIZES = {"2048": (2048, 0), "8192": (8192, 0), "batch": (256, 1024)}
# The C signatures of the bf16 forms before the vector kernels.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LEGACY_ADVECT = [_P] * 6 + [_I] * 4 + [_F, _I, _P]
LEGACY_GRADIENT = [_P] * 5 + [_I, _I, _F, _I, _P]


class ParentBf16:
    """A parent tree's kernel library whose bf16 K3 and K2 gradient take
    no width (one kernel a form), with those entry points as this tree's
    wrappers call them: the width argument is dropped.  Every other entry
    point is the library's."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        self._advect = lib.fsc_advect_bf16
        self._advect.argtypes = LEGACY_ADVECT
        self._gradient = lib.fsc_gradient_bf16
        self._gradient.argtypes = LEGACY_GRADIENT

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def fsc_advect_bf16(self, *args):
        *call, _width, stream = args
        return self._advect(*call, stream)

    def fsc_gradient_bf16(self, *args):
        *call, _width, stream = args
        return self._gradient(*call, stream)


def parent_library(tree: Path):
    """The kernel library built from ``tree``'s sources, through
    ``ParentBf16`` where its bf16 forms have no vector kernels."""
    from fluidsimulationcuda_torch.kernels import build

    csrc = tree / "fluidsimulationcuda_torch" / "csrc"
    lib = build.open_library(build.build(csrc=csrc))
    vector = "advect_vec_kernel" in (csrc / "advect.cu").read_text()
    return lib if vector else ParentBf16(lib)


def kernel_checks(side: int, batch: int):
    """(label, check, bf16) of every call timed at ``side`` (a batch of
    ``batch`` grids if given)."""
    from fluidsimulationcuda_torch.kernels import checks
    from fluidsimulationcuda_torch.kernels import cuda_ops as co

    t = checks._Inputs(side, "cuda", 0, batch=batch)
    n, cells, bf = t.n, t.cells, torch.bfloat16
    x16 = t.x.to(bf)
    out = []

    def timed(label, cost, kernels, fn, plain, *args, bf16=True):
        out.append((label, checks._timed(cost, cells, label, kernels, fn,
                                         plain, *args), bf16))

    flows = {"step's": (t.u, t.v), **checks.gather_velocities(t)}
    for name, (u, v) in flows.items():
        u, v = u.to(bf), v.to(bf)
        timed(f"advect_bf16 u/v pair, {name} velocities",
              checks.ADVECT2_PAIR_BF16, ("advect_bf16",),
              co.advect_shift_fused, co.advect_shift_fused_plain, (1, 2),
              (u, v), u, v, checks.DT, n)
    u, v = t.u.to(bf), t.v.to(bf)
    timed("advect_bf16 one field b=0, step's velocities",
          checks.ADVECT2_ONE_BF16, ("advect_bf16",), co.advect_shift_fused,
          co.advect_shift_fused_plain, (0,), (x16,), u, v, checks.DT, n)
    if batch:
        timed("advect_bf16 u/v pair cmax=1, step's velocities",
              checks.ADVECT2_PAIR_BF16, ("advect_bf16",),
              co.advect_shift_fused, co.advect_shift_fused_plain, (1, 2),
              (u, v), u, v, checks.DT, n, 1)
    timed("gradient_bf16, float32 p", checks.GRAD2_BF16, ("gradient_bf16",),
          co.gradient_p, co.gradient_p_plain, u, v, t.p, n)
    timed("gradient_bf16, bf16 p", checks.GRADP_BF16, ("gradient_bf16",),
          co.gradient_p, co.gradient_p_plain, u, v, t.p.to(bf), n)
    timed("advect float32 u/v pair, step's velocities", checks.ADVECT2_PAIR,
          ("advect",), co.advect_shift_fused, co.advect_shift_fused_plain,
          (1, 2), (t.u, t.v), t.u, t.v, checks.DT, n, bf16=False)
    timed("gradient float32", checks.GRAD2, ("gradient",), co.gradient_p,
          co.gradient_p_plain, t.u, t.v, t.p, n, bf16=False)
    return out


@contextlib.contextmanager
def form(check, name: str):
    """This tree's bf16 vector kernels in form ``name``, ``V=<width>``
    of ``checks.BF16_FORMS`` (the path's widths for a float32 check, which
    launches none, or the parent)."""
    from fluidsimulationcuda_torch.kernels import cuda_ops as co

    if not name.startswith("V="):
        yield
        return
    with co.vector_widths((int(name[2:]),)):
        yield


def time_kernels(libs, sizes) -> None:
    from fluidsimulationcuda_torch.kernels import build, checks
    from fluidsimulationcuda_torch.kernels import cuda_ops as co

    for size in sizes:
        side, batch = SIZES[size]
        title = f"1024 × {side}²" if batch else f"{side}²"
        print(f"  {title}:", flush=True)
        for label, c, bf16 in kernel_checks(side, batch):
            forms = ([f"V={w}" for w in checks.BF16_FORMS[c.kernels[0]]]
                     if bf16 else ["this"])
            build._lib = libs["this"]
            # The bf16 forms equal their plain versions bit for bit, the
            # float32 kernels within checks.TOL (a few ulps).
            tol = 0.0 if bf16 else checks.TOL
            for name in forms:
                with form(c, name):
                    err = checks.max_abs_diff(c.run(), c.plain())
                if err > tol:
                    raise AssertionError(f"{title} {label} {name}: max|d| "
                                         f"{err}")
            ms = {}
            for turn in ("parent", *forms, *reversed(forms), "parent"):
                build._lib = libs["parent" if turn == "parent" else "this"]
                with form(c, turn):
                    ms.setdefault(turn, []).append(checks.device_ms(c.run))
            build._lib = libs["this"]
            co.reset_width_counts()
            c.run()
            widths = [f"V={w}" for counts in co.width_counts().values()
                      for w, k in counts.items() if k]
            bound, _ = c.bound()
            parent = sum(ms["parent"]) / 2
            line = f"    {label:48s} parent {parent:.5f}"
            for name in forms:
                this = sum(ms[name]) / 2
                line += (f"  {name} {this:.5f} ({100 * this / parent:.1f}%,"
                         f" {100 * bound / this:.1f}%)")
            line += f"  bound {bound:.5f} ms, path {' '.join(widths)}"
            print(line, flush=True)
            del c


def time_steps(libs) -> None:
    from fluidsimulationcuda_torch import (SimConfig, StableFluids2D,
                                           batched_init, make_batched_step_fn,
                                           reference_init,
                                           select_cmax_batched)
    from fluidsimulationcuda_torch.core.config import perf_operating_point
    from fluidsimulationcuda_torch.core.state import zero_sources_like
    from fluidsimulationcuda_torch.kernels import build, checks
    from fluidsimulationcuda_torch.kernels import cuda_ops as co

    parity = SimConfig(n=2046, jacobi_iters=20, backend="cuda",
                       device="cuda")
    rho, k_d, k_p = perf_operating_point(2048)
    comp = parity.replace(pressure_solver="chebyshev",
                          diffusion_solver="chebyshev", cheby_rho=rho,
                          cheby_iters=k_d, cheby_press_iters=k_p,
                          fast_math=True)
    big = SimConfig(n=8190, jacobi_iters=40, backend="cuda", device="cuda")
    datagen = SimConfig(n=254, jacobi_iters=20, backend="cuda", device="cuda")
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)  # noqa: E731
    build._lib = libs["this"]
    cmax, _ = select_cmax_batched(gen(), datagen.replace(
        dtype=torch.bfloat16), 1024)
    datagen = datagen.replace(advect_mode="windowed", max_courant=cmax)
    for label, cfg in (("2048² parity", parity),
                       (f"2048² compensated ({rho}, {k_d}, {k_p}) fast",
                        comp),
                       ("8192² parity, 40 it", big),
                       (f"1024 × 256² datagen, window {cmax}", datagen)):
        for dtype in (torch.bfloat16, torch.float32):
            c = cfg.replace(dtype=dtype)
            build._lib = libs["this"]
            if cfg is datagen:
                state, src = batched_init(gen(), c, 1024)
                fn = make_batched_step_fn(c)
                step = lambda s, fn=fn, z=zero_sources_like(src): fn(s, z)  # noqa: E731
                state = fn(state, src)
            else:
                state, src = reference_init(gen(), c)
                step = StableFluids2D(c).step
                state = step(state, src)
            for _ in range(2):
                state = step(state)
            co.reset_width_counts()
            step(state)
            widths = {k: {w: n for w, n in d.items() if n}
                      for k, d in co.width_counts().items()}
            ms = {}
            for tree in ("parent", "this", "this", "parent"):
                build._lib = libs[tree]
                ms.setdefault(tree, []).append(
                    checks.device_ms(lambda: step(state), reps=3))
            build._lib = libs["this"]
            parent, this = (sum(ms[k]) / 2 for k in ("parent", "this"))
            print(f"  {label} {str(dtype).split('.')[-1]}: graph ms/step "
                  f"parent {ms['parent'][0]:.4f} {ms['parent'][1]:.4f}, "
                  f"this {ms['this'][0]:.4f} {ms['this'][1]:.4f} "
                  f"({this - parent:+.4f} ms, {100 * this / parent:.2f}%); "
                  f"widths {widths}", flush=True)
            del state, step


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--sizes", default=",".join(SIZES),
                    help=f"comma-separated sizes of {tuple(SIZES)}")
    ap.add_argument("--no-steps", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_bf16_stencils: no CUDA device")
    sizes = args.sizes.split(",")
    if not set(sizes) <= set(SIZES):
        raise SystemExit(f"bench_bf16_stencils: --sizes takes {tuple(SIZES)}")
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    from fluidsimulationcuda_torch.kernels import build

    libs = {"parent": parent_library(args.parent), "this": build.load()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(f"device ms per call, parent / this tree's forms ({card})")
    time_kernels(libs, sizes)
    if not args.no_steps:
        time_steps(libs)


if __name__ == "__main__":
    main()
