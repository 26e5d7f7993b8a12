#!/usr/bin/env python3
"""The per-sweep float32 K5 and K13 (``csrc/jacobi3.cu``,
``csrc/jacobi3_slab.cu``) in each form, on the card, in one process: the
one-cell kernel, the vector walk (``csrc/jacobi3_walk.cuh``: 4 cells of a
row a thread, walking W planes) and, with ``--pairs``, the two-sweep form
that was measured and not built into the port
(``dev/sweep3_pair/jacobi3_pair.cuh``: two sweeps a launch, tiles of R
interior rows, a block walking P planes of the second sweep).

    python3 dev/bench_sweep3.py [--walks 2,3,4] [--pairs] [--rows 6,8,14]
                                [--pair-walks 8,16,32,64] [--ptxas]
                                [--no-sweeps] [--solves] [--steps]

- ``--pairs``: build the library from ``csrc/`` and ``dev/sweep3_pair/``
  together (into ``build/sweep3_pair/``), so the sweeps below also time
  the pair.
- ``--ptxas``: ``nvcc -Xptxas -v`` of the sources: the registers, shared
  memory and spills of every vector (and pair) instantiation.
- Unless ``--no-sweeps``: a middle sweep (float32 iterate, rhs and out;
  and a bf16 rhs) at 256³ (K5) and on an interior 74-plane z-slab buffer
  of 256³ (K13: a 32-plane slab with its 21-plane halos, sweeps 1 and 2 of
  a segment), raw library calls on the same inputs: the one-cell form,
  the walk at each W, two one-sweep launches of each, and the pair at
  each R and P; every vector result held bit for bit to the one-cell
  form's and every pair to two one-cell sweeps.  Device ms of a call (CUDA
  graphs of 20 calls, ``checks.device_ms``), the forms in turns forward
  then backward, the mean; beside the 12-byte bound of a sweep (10 with a
  bf16 rhs) and of a pair (the same bytes for two sweeps), over 3.35 TB/s.
- ``--solves``: the calls ``chip_smoke.py`` phases 3b and 3d time
  (``checks.timing_checks3``, ``timing_checks_slab3``) whose solves take
  the per-sweep K5 or K13, and the bf16 ones of phases 21 and 22, in the
  path's form (the walk) and the one-cell form
  (``cuda_ops.vector_widths((1,))``), each held bit for bit to its plain
  twin, with the launches by width.
- ``--steps``: the 256³ parity steps, float32 and bf16, on one volume and
  on 8 z-slabs, as CUDA graphs of one step in both forms, in turns; the
  states of each storage equal bit for bit across forms.

Prints the card's name and power limit.  Exits non-zero without a card or
on a difference.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SIDE, SLAB_PLANES = 256, 74
HBM = 3.35e12
DEVICE = "cuda"
A = 0.25


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def pair_library(build):
    """The library of ``csrc/`` and ``dev/sweep3_pair/`` built together,
    with the pair's entry points declared."""
    src = ROOT / "build" / "sweep3_pair"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for path in [*build.CSRC.glob("*.cu*"),
                 *(ROOT / "dev" / "sweep3_pair").glob("*.cu*")]:
        shutil.copy(path, src / path.name)
    lib = build.open_library(build.build(csrc=src))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    signatures = {
        "fsc_jacobi3_sweep_pair": [p, p, p, i, i, f, f, f, i, i, i, i, p],
        "fsc_jacobi3_slab_pair": [p, p, p, i, i, f, f, f, i, i, i, i, i, i,
                                  i, i, i, p]}
    for name, argtypes in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib, src


def ptxas_report(csrc: Path) -> None:
    """Registers, shared memory and spills of the vector and pair kernels."""
    from fluidsimulationcuda_torch.kernels import build

    print("ptxas (-Xptxas -v) of the vector and pair kernels:")
    for src in sorted(csrc.glob("*.cu")):
        if src.name not in ("jacobi3.cu", "jacobi3_slab.cu", "pair.cu"):
            continue
        with tempfile.TemporaryDirectory() as tmp:
            res = subprocess.run(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 "-o", f"{tmp}/x.o", str(src)],
                capture_output=True, text=True, check=True)
        name = None
        for line in (res.stdout + res.stderr).splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)'?", line)
            if m:
                name = m.group(1)
            if name and ("pair" in name or "vec" in name) and (
                    "registers" in line or "spill" in line):
                print(f"  {src.name} {name[:70]}: {line.strip()}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


class Sweeps:
    """Operands and raw launches of the middle sweeps of K5 (a volume) or
    K13 (the slab buffer: sweep 1 over planes [1, 73), sweep 2 over [2,
    72))."""

    def __init__(self, lib, slab: bool, rhs_dtype, gen):
        self.lib, self.slab = lib, slab
        planes = SLAB_PLANES if slab else SIDE
        shape = (planes, SIDE, SIDE)
        self.x = 2 * torch.rand(shape, generator=gen, device=DEVICE) - 1
        self.rhs = (2 * torch.rand(shape, generator=gen, device=DEVICE)
                    - 1).to(rhs_dtype)
        self.mid = torch.zeros(shape, device=DEVICE)
        self.out = torch.zeros(shape, device=DEVICE)
        self.planes = planes
        self.bf16 = rhs_dtype == torch.bfloat16
        self.cells = (planes - 2 if slab else planes) * SIDE * SIDE

    def _range(self, k: int) -> tuple:
        return ((k, self.planes - k, -1, -1) if self.slab else ())

    def one(self, x, out, k: int, width: int, walk: int) -> None:
        scalars = (SIDE, 1, A, 1 + 6 * A, A / (1 + 6 * A), 1 / (1 + 6 * A),
                   0.0, 0.0, 0)
        name = "fsc_jacobi3_slab" if self.slab else "fsc_jacobi3_sweep"
        types = ()
        if self.bf16:
            name += "_bf16"
            types = (0,)
        rc = getattr(self.lib, name)(
            _ptr(x), _ptr(self.rhs), None, None, _ptr(out), None, *scalars,
            *self._range(k), *types, width, walk, _stream())
        if rc != 0:
            raise RuntimeError(f"{name} width {width} walk {walk}: rc {rc}")

    def two(self, width: int, walk: int) -> None:
        self.one(self.x, self.mid, 1, width, walk)
        self.one(self.mid, self.out, 2, width, walk)

    def pair(self, rows: int, walk: int) -> None:
        coefs = (SIDE, 1, A, 1 + 6 * A, A / (1 + 6 * A), 0)
        if self.slab:
            rc = self.lib.fsc_jacobi3_slab_pair(
                _ptr(self.x), _ptr(self.rhs), _ptr(self.out), *coefs, 2,
                self.planes - 2, self.planes, -1, -1, int(self.bf16), rows,
                walk, _stream())
        else:
            rc = self.lib.fsc_jacobi3_sweep_pair(
                _ptr(self.x), _ptr(self.rhs), _ptr(self.out), *coefs,
                int(self.bf16), rows, walk, _stream())
        if rc != 0:
            raise RuntimeError(f"pair rows {rows} walk {walk}: rc {rc}")

    def result(self, fn) -> torch.Tensor:
        self.out.fill_(7.0)
        fn()
        torch.cuda.synchronize()
        return self.out.clone()


def sweep_table(lib, walks, rows, pair_walks, card) -> int:
    """One middle sweep and two in every form, held and timed."""
    from fluidsimulationcuda_torch.kernels import checks

    failures = 0
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for slab in (False, True):
        for rhs_dtype in (torch.float32, torch.bfloat16):
            s = Sweeps(lib, slab, rhs_dtype, gen)
            forms = {"one-cell": lambda: s.two(1, 1)}
            forms.update({f"walk W={w}": (lambda w=w: s.two(4, w))
                          for w in walks})
            if hasattr(lib, "fsc_jacobi3_sweep_pair"):
                forms.update({f"pair R={r} P={p}":
                              (lambda r=r, p=p: s.pair(r, p))
                              for r in rows for p in pair_walks})
            want = s.result(forms["one-cell"])
            for name, fn in forms.items():
                if not torch.equal(s.result(fn), want):
                    print(f"  DIFFERS: {name}")
                    failures += 1
            ms = dict.fromkeys(forms, 0.0)
            for name in [*forms, *reversed(forms)]:
                ms[name] += checks.device_ms(forms[name]) / 2
            single = dict.fromkeys(["one-cell", *(f"W={w}" for w in walks)],
                                   0.0)
            for name in [*single, *reversed(single)]:
                width, walk = (1, 1) if name == "one-cell" else (
                    4, int(name[2:]))
                single[name] += checks.device_ms(
                    lambda: s.one(s.x, s.mid, 1, width, walk)) / 2
            nbytes = 10 if s.bf16 else 12
            bound = 1e3 * nbytes * s.cells / HBM
            where = (f"K13 on a {SLAB_PLANES}-plane buffer" if slab
                     else "K5 256³")
            rhs = "bf16 rhs" if s.bf16 else "float32"
            print(f"{where}, {rhs}: bound a sweep {bound:.5f} ms "
                  f"({nbytes} bytes a cell), a pair {bound:.5f} "
                  f"({bound / 2:.5f} a sweep) ({card})")
            print("    one sweep: " + "  ".join(
                f"{n} {t:.5f} ({100 * bound / t:.1f}%)"
                for n, t in single.items()))
            print("    two sweeps: " + "  ".join(
                f"{n} {ms[n]:.5f}" for n in forms if not n.startswith("pair")))
            pairs = [n for n in forms if n.startswith("pair")]
            for r in rows if pairs else ():
                print(f"    pair R={r}: " + "  ".join(
                    f"P={p} {ms[f'pair R={r} P={p}']:.5f}" for p in pair_walks))
            if pairs:
                best = min(pairs, key=ms.get)
                two = min(ms[n] for n in forms if n.startswith("walk"))
                print(f"    fastest {best} {ms[best]:.5f} ms: "
                      f"{ms[best] / two:.3f}x the walk's two sweeps, "
                      f"{100 * bound / ms[best]:.1f}% of the pair's bound",
                      flush=True)
            del s
    return failures


@contextlib.contextmanager
def form(name: str):
    from fluidsimulationcuda_torch.kernels import cuda_ops as co

    with (contextlib.nullcontext() if name == "walk"
          else co.vector_widths((1,))):
        yield


FORMS = ("walk", "one-cell")


def solve_table(card) -> int:
    """The timed solves on the per-sweep K5 and K13 in each form."""
    from fluidsimulationcuda_torch.kernels import checks
    from fluidsimulationcuda_torch.kernels import cuda_ops as co

    failures = 0
    per_sweep = (checks.JAC3_SWEEP, checks.JAC3_SLAB_SWEEP,
                 checks.JAC3_SWEEP_16, checks.JAC3_SLAB_SWEEP_16)
    calls = [c for c in checks.timing_checks3(SIDE, DEVICE, 0)
             + checks.timing_checks_slab3(SIDE, 32, DEVICE, 0)
             + checks.timing_checks3_bf16(SIDE, DEVICE, 0)
             + checks.timing_checks_slab3_bf16(SIDE, 32, DEVICE, 0)
             if c.kernels in per_sweep]
    for c in calls:
        plain = c.plain()
        counts = {}
        for f in FORMS:
            with form(f):
                co.reset_width_counts()
                got = c.run()
                torch.cuda.synchronize()
                counts[f] = co.width_counts()[c.kernels[0]]
                if checks.max_abs_diff(got, plain) != 0.0:
                    print(f"  DIFFERS from its twin: {c.label} {f}")
                    failures += 1
        ms = dict.fromkeys(FORMS, 0.0)
        for f in FORMS + FORMS[::-1]:
            with form(f):
                ms[f] += checks.device_ms(c.run) / 2
        bound, by = c.bound()
        print(f"{c.label}: walk {ms['walk']:.5f} ms, one-cell "
              f"{ms['one-cell']:.5f}; bound {bound:.5f} ({by}); walk/one-cell "
              f"{ms['walk'] / ms['one-cell']:.3f}; launches by width "
              f"{counts} ({card})", flush=True)
    return failures


def step_table(card) -> int:
    """The 256³ parity steps as CUDA graphs in each form."""
    from fluidsimulationcuda_torch import (SimConfig, StableFluids3D,
                                           reference_init, zero_sources)
    from fluidsimulationcuda_torch.kernels import checks
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn_3d,
                                                    shard_state_3d, unshard)

    failures = 0
    parity = SimConfig(n=254, ndim=3, jacobi_iters=20, backend="cuda",
                       device="cuda")
    for slabs in (0, 8):
        for dtype in (torch.float32, torch.bfloat16):
            cfg = parity.replace(dtype=dtype)
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
            else:
                sim = StableFluids3D(cfg)

                def step(s, src=None, sim=sim):
                    return sim.step(s, src)
            state = step(step(state, sources))
            outs = {}
            for f in FORMS:
                with form(f):
                    out = step(state)
                    torch.cuda.synchronize()
                    outs[f] = unshard(out) if slabs else out
            same = all(torch.equal(a, b) for f in FORMS
                       for a, b in zip(outs[f], outs["walk"]))
            failures += not same
            ms = dict.fromkeys(FORMS, 0.0)
            for f in FORMS + FORMS[::-1]:
                with form(f):
                    ms[f] += checks.device_ms(lambda: step(state), reps=3) / 2
            where = f"256³ parity on {slabs} z-slabs" if slabs else "256³ parity"
            print(f"{where}, {str(dtype)[6:]} step as a CUDA graph: walk "
                  f"{ms['walk']:.4f} ms, one-cell {ms['one-cell']:.4f}; "
                  f"states "
                  f"{'equal bit for bit' if same else 'DIFFER'} ({card})",
                  flush=True)
    return failures


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--walks", default="2,3,4")
    ap.add_argument("--pairs", action="store_true")
    ap.add_argument("--rows", default="6,8,14")
    ap.add_argument("--pair-walks", default="8,16,32,64")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--no-sweeps", action="store_true")
    ap.add_argument("--solves", action="store_true")
    ap.add_argument("--steps", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_sweep3: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from fluidsimulationcuda_torch.kernels import build

    card = card_line()
    if args.pairs:
        lib, csrc = pair_library(build)
    else:
        lib, csrc = build.load(), build.CSRC
    print(f"card: {card}; torch {torch.__version__}; library "
          f"{build.library_path(csrc)}", flush=True)
    if args.ptxas:
        ptxas_report(csrc)
    failures = 0
    if not args.no_sweeps:
        failures += sweep_table(
            lib, [int(w) for w in args.walks.split(",")],
            [int(r) for r in args.rows.split(",")],
            [int(p) for p in args.pair_walks.split(",")], card)
    if args.solves:
        failures += solve_table(card)
    if args.steps:
        failures += step_table(card)
    print(f"{failures} failure(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
