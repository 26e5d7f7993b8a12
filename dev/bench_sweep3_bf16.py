#!/usr/bin/env python3
"""The per-sweep bf16 K5 and K13 (``csrc/jacobi3.cu``,
``csrc/jacobi3_slab.cu``) in their one-cell form and in their vector form
(``csrc/jacobi3_walk.cuh``: V cells of a row a thread, walking W planes)
beside the float32 forms, on the card, in one process.

    python3 dev/bench_sweep3_bf16.py [--walks 1,2,3,4,6]
                                     [--sass] [--no-solves] [--steps]

- ``--sass``: ``cuobjdump -sass`` and ``-res-usage`` of the built library:
  for every instantiation of the per-sweep K5 and K13 (float32, the eight
  bf16 operand types in the one-cell form and in the vector form), the
  registers, the instruction count, the loads and stores by opcode and
  modifier (``LDG.E.CONSTANT``: the read-only path; ``.128``, ``.64``,
  ``.U16``: the width), and the conversions; the whole SASS of the
  float32, the middle bf16 one-cell and the middle vector K5 goes to
  ``build/sass_sweep3.txt``.
- One sweep, raw library calls on the same inputs: the first sweep of a
  20-sweep folded u solve (bf16 guess and source, bf16 rhs built and
  stored), a middle one (float32 iterate, bf16 rhs, float32 out), the last
  (bf16 out), a middle Chebyshev fast sweep (float32 x_{k-1} too) and
  a sweep from the zero guess (the rhs read, no iterate: what a 2-byte
  load a thread costs against a 4-byte one, apart from the stencil), at
  256³ (K5) and over planes [1, 73) of an interior 74-plane z-slab buffer
  of 256³ (K13: a 32-plane slab with its 21-plane halos, the first sweep
  of a 20-sweep segment), each in the one-cell form, in the vector form
  (V = 4) at every walk, and in float32; every vector result (out and the stored rhs)
  first held bit for bit to the one-cell form's.  Device ms of a call
  (CUDA graphs of 20 calls, ``checks.device_ms``), the forms in turns
  forward then backward, the mean; each beside its bound, the bytes the
  sweep must move (first 12 bytes a cell, middle 10, last 8, Chebyshev
  14, zero guess 6; float32 20, 12, 12, 16, 8) and the 6-byte bound of bf16 storage
  throughout, over 3.35 TB/s.
- Unless ``--no-solves``: the calls ``chip_smoke.py`` phases 21 and 22
  time (``checks.timing_checks3_bf16``, ``timing_checks_slab3_bf16``):
  the one-sweep call and the 20-sweep u solve (K5 at 256³) and segment
  (K13 on a 32-plane slab) in each form (``cuda_ops.vector_widths``,
  ``cuda_ops.SWEEP3_WALK``) beside their float32 forms, each held bit for
  bit to its plain twin first.
- ``--steps``: the bf16 3-D steps at 256³ parity (``StableFluids3D``) and
  on 8 z-slabs (``make_sharded_step_fn_3d``) as CUDA graphs of one step,
  in the path's form, each walk, the one-cell form
  (``vector_widths((1,))``) and float32, in turns, the states of every
  bf16 form equal bit for bit.

Prints the card's name and power limit.  Exits non-zero without a card or
on a difference.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build"
SIDE, SLAB_PLANES, SLAB_LO, SLAB_HI = 256, 74, 1, 73
# The z-slab of phase 22's timed calls.
SLAB_MZ = 32
HBM = 3.35e12
DEVICE = "cuda"
# (flags, which of x, xm, out are bf16, bytes a cell bf16, bytes float32)
PREP, FAST, CHEBY = 1, 2, 4
X16, XM16, OUT16 = 1, 2, 4
SWEEPS = {"first": (PREP, X16, 12, 20), "middle": (0, 0, 10, 12),
          "last": (0, OUT16, 8, 12), "cheby middle": (FAST | CHEBY, 0, 14, 16),
          "zero guess": (0, 0, 6, 8)}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def sass_report(lib_path: Path) -> None:
    """The SASS summary of every per-sweep K5 and K13 instantiation."""
    from fluidsimulationcuda_torch.kernels import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    res = subprocess.run([str(tool), "-res-usage", str(lib_path)],
                         check=True, capture_output=True, text=True).stdout
    blocks = re.split(r"\n\s*Function : (\S+)\n", sass)
    funcs = dict(zip(blocks[1::2], blocks[2::2]))
    regs = dict(re.findall(r"Function (\S+):\s*\n?\s*REG:(\d+)", res))
    filt = shutil.which("cu++filt", path=str(tool.parent)) or shutil.which(
        "c++filt")
    names = list(funcs)
    shown = subprocess.run([filt], input="\n".join(names), check=True,
                           capture_output=True,
                           text=True).stdout.splitlines() if filt else names
    demangled = dict(zip(names, shown))
    keep = ("jacobi3_sweep_kernel", "jacobi3_sweep_vec_kernel",
            "jacobi3_slab_kernel", "jacobi3_slab_vec_kernel")
    OUT.mkdir(exist_ok=True)
    full = []
    print("SASS of the per-sweep K5 and K13 (registers, instructions, "
          "memory operations by opcode, conversions):")
    for name, body in funcs.items():
        pretty = demangled[name].replace("__nv_bfloat16", "bf16")
        if not any(k + "<" in pretty for k in keep):
            continue
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                         body)
        mem = collections.Counter(o for o in ops if o.split(".")[0] in (
            "LDG", "STG", "LD", "ST", "LDS", "STS"))
        conv = collections.Counter(o for o in ops if o.split(".")[0] in (
            "F2F", "F2FP", "PRMT", "I2F", "F2I", "MUFU"))
        line = (f"  {pretty[:90]:90s} REG {regs.get(name, '?'):>3s}  "
                f"{len(ops):4d} instr  {dict(sorted(mem.items()))}  "
                f"{dict(sorted(conv.items()))}")
        print(line)
        if ("jacobi3_sweep_kernel<float, float, float, float>" in pretty
                or "jacobi3_sweep_kernel<float, float, bf16, float>" in pretty
                or "jacobi3_sweep_vec_kernel<float, float, float>"
                in pretty):
            full.append(f"==== {pretty}\n{body}")
    (OUT / "sass_sweep3.txt").write_text("\n".join(full))
    print(f"  the whole SASS of three of them: {OUT / 'sass_sweep3.txt'}")


class Sweep:
    """Operands and raw launches of one sweep of the per-sweep K5 (volume)
    or K13 (the slab buffer's planes [SLAB_LO, SLAB_HI))."""

    def __init__(self, lib, slab: bool, what: str, gen):
        self.lib, self.slab, self.what = lib, slab, what
        self.flags, self.types, self.bytes16, self.bytes32 = SWEEPS[what]
        planes = SLAB_PLANES if slab else SIDE
        shape = (planes, SIDE, SIDE)
        bf = torch.bfloat16

        def field(dtype):
            return (2 * torch.rand(shape, generator=gen, device=DEVICE)
                    - 1).to(dtype)

        x16 = bool(self.types & X16)
        self.x = (None if what == "zero guess"
                  else field(bf if x16 else torch.float32))
        self.rhs = field(bf)
        self.src = self.x if self.flags & PREP else None
        self.xm = field(torch.float32) if self.flags & CHEBY else None
        self.out = torch.zeros(shape, dtype=bf if self.types & OUT16
                               else torch.float32, device=DEVICE)
        self.rhs_out = (torch.zeros_like(self.rhs) if self.flags & PREP
                        else None)
        # The float32 form on the same values.
        self.x32 = None if self.x is None else self.x.float()
        self.rhs32 = self.rhs.float()
        self.src32 = self.x32 if self.src is not None else None
        self.xm32 = self.xm
        self.out32 = torch.zeros(shape, device=DEVICE)
        self.rhs_out32 = (torch.zeros_like(self.rhs32)
                          if self.rhs_out is not None else None)
        self.cells = (SLAB_HI - SLAB_LO if slab else SIDE) * SIDE * SIDE
        a = 0.25
        self.scalars = (a, 1 + 6 * a, a / (1 + 6 * a), 1 / (1 + 6 * a), 0.1,
                        1.3, self.flags)

    def _geometry(self):
        return (SLAB_LO, SLAB_HI, -1, -1) if self.slab else ()

    def launch(self, width: int, walk: int) -> None:
        name = "fsc_jacobi3_slab_bf16" if self.slab else "fsc_jacobi3_sweep_bf16"
        rc = getattr(self.lib, name)(
            *(_ptr(t) for t in (self.x, self.rhs, self.src, self.xm,
                                self.out, self.rhs_out)), SIDE, 1,
            *self.scalars, *self._geometry(), self.types, width, walk,
            _stream())
        if rc != 0:
            raise RuntimeError(f"{name} width {width} walk {walk}: rc {rc}")

    def launch32(self) -> None:
        """The float32 form's one-cell kernel (width 1)."""
        name = "fsc_jacobi3_slab" if self.slab else "fsc_jacobi3_sweep"
        rc = getattr(self.lib, name)(
            *(_ptr(t) for t in (self.x32, self.rhs32, self.src32,
                                self.xm32, self.out32, self.rhs_out32)),
            SIDE, 1, *self.scalars, *self._geometry(), 1, 1, _stream())
        if rc != 0:
            raise RuntimeError(f"{name}: rc {rc}")

    def result(self, width: int, walk: int) -> list[torch.Tensor]:
        self.out.zero_()
        if self.rhs_out is not None:
            self.rhs_out.zero_()
        self.launch(width, walk)
        torch.cuda.synchronize()
        return [t.clone() for t in (self.out, self.rhs_out) if t is not None]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def sweep_table(lib, widths, walks, card) -> int:
    """One sweep in every form, held to the one-cell form and timed."""
    from fluidsimulationcuda_torch.kernels import checks

    failures = 0
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for slab in (False, True):
        for what in SWEEPS:
            s = Sweep(lib, slab, what, gen)
            want = s.result(1, 1)
            forms = [(1, 1)] + [(v, w) for v in widths for w in walks]
            for v, w in forms[1:]:
                got = s.result(v, w)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    print(f"  DIFFERS: {what} V={v} W={w}")
                    failures += 1
            ms = dict.fromkeys(forms, 0.0)
            for form in forms + forms[::-1]:
                ms[form] += checks.device_ms(
                    lambda f=form: s.launch(*f)) / 2
            f32 = (checks.device_ms(s.launch32)
                   + checks.device_ms(s.launch32)) / 2
            b16 = 1e3 * s.bytes16 * s.cells / HBM
            b6 = 1e3 * 6 * s.cells / HBM
            b32 = 1e3 * s.bytes32 * s.cells / HBM
            where = (f"K13 planes [{SLAB_LO}, {SLAB_HI}) of a "
                     f"{SLAB_PLANES}-plane buffer" if slab else "K5 256³")
            print(f"{where}, {what} sweep: bound {b16:.5f} ms "
                  f"({s.bytes16} bytes a cell), 6-byte bound {b6:.5f}; "
                  f"float32 form {f32:.5f} ms (bound {b32:.5f}, "
                  f"{100 * b32 / f32:.1f}%); one-cell bf16 "
                  f"{ms[(1, 1)]:.5f} ms ({100 * b16 / ms[(1, 1)]:.1f}%) "
                  f"({card})")
            best = min(forms[1:], key=ms.get)
            for v in widths:
                row = "  ".join(f"W={w} {ms[(v, w)]:.5f}" for w in walks)
                print(f"    V={v}: {row}")
            print(f"    fastest V={best[0]} W={best[1]} {ms[best]:.5f} ms: "
                  f"{ms[best] / f32:.3f}x float32, "
                  f"{ms[best] / ms[(1, 1)]:.3f}x one-cell, "
                  f"{100 * b16 / ms[best]:.1f}% of its bound", flush=True)
            del s
    return failures


@contextlib.contextmanager
def form(width, walk):
    from fluidsimulationcuda_torch.kernels import cuda_ops as co

    saved = co.SWEEP3_WALK
    co.SWEEP3_WALK = walk
    try:
        with co.vector_widths((width,)):
            yield
    finally:
        co.SWEEP3_WALK = saved


def solve_table(widths, walks, card) -> int:
    """The calls phases 21 and 22 time, in every form."""
    from fluidsimulationcuda_torch.kernels import checks

    failures = 0
    want = ("jacobi3_sweep_bf16", "fused_jacobi3 20it src_dt bf16 (u "
            "diffusion)", "jacobi3_slab_bf16",
            "fused_jacobi3_slab 20it bf16 (u diffusion)")
    calls = [c for c in checks.timing_checks3_bf16(SIDE, DEVICE, 0)
             + checks.timing_checks_slab3_bf16(SIDE, SLAB_MZ, DEVICE, 0)
             if c.label in want]
    forms = [(1, 1)] + [(v, w) for v in widths for w in walks]
    for c in calls:
        plain = c.plain()
        for f in forms:
            with form(*f):
                if checks.max_abs_diff(c.run(), plain) != 0.0:
                    print(f"  DIFFERS from its twin: {c.label} {f}")
                    failures += 1
        ms = dict.fromkeys(forms, 0.0)
        for f in forms + forms[::-1]:
            with form(*f):
                ms[f] += checks.device_ms(c.run) / 2
        f32 = (checks.device_ms(c.counterpart)
               + checks.device_ms(c.counterpart)) / 2
        best = min(forms[1:], key=ms.get)
        row = "  ".join(f"V={v} W={w} {ms[(v, w)]:.5f}" for v, w in forms[1:])
        print(f"{c.label}: float32 form {f32:.5f} ms, one-cell bf16 "
              f"{ms[(1, 1)]:.5f} ({ms[(1, 1)] / f32:.3f}x); fastest V="
              f"{best[0]} W={best[1]} {ms[best]:.5f} ({ms[best] / f32:.3f}x "
              f"float32) ({card})\n    {row}", flush=True)
    return failures


def step_table(widths, walks, card) -> int:
    """The bf16 3-D steps as CUDA graphs in the path's form, every width
    and walk and the one-cell form, beside float32."""
    from fluidsimulationcuda_torch import (SimConfig, StableFluids3D,
                                           reference_init, zero_sources)
    from fluidsimulationcuda_torch.kernels import checks
    from fluidsimulationcuda_torch.kernels import cuda_ops as co
    from fluidsimulationcuda_torch.parallel import (make_mesh,
                                                    make_sharded_step_fn_3d,
                                                    shard_state_3d, unshard)

    failures = 0
    parity = SimConfig(n=254, ndim=3, jacobi_iters=20, backend="cuda",
                       device="cuda")
    for slabs in (0, 8):
        runs = {}
        for dtype in (torch.bfloat16, torch.float32):
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
            state = step(state, sources)
            state = step(state)
            runs[dtype] = (step, state)
        step16, state16 = runs[torch.bfloat16]
        forms = {"path": contextlib.nullcontext,
                 "one-cell": lambda: form(1, 1),
                 **{f"V={v} W={w}": (lambda v=v, w=w: form(v, w))
                    for v in widths for w in walks},
                 "float32": contextlib.nullcontext}
        bf16_forms = [name for name in forms if name != "float32"]
        outs = {}
        for name in bf16_forms:
            with forms[name]():
                co.reset_width_counts()
                out = step16(state16)
                torch.cuda.synchronize()
                outs[name] = (unshard(out) if slabs else out,
                              co.width_counts())
        same = all(torch.equal(a, b) for name in bf16_forms
                   for a, b in zip(outs[name][0], outs["one-cell"][0]))
        failures += not same
        ms = dict.fromkeys(forms, 0.0)
        for name in [*forms, *reversed(forms)]:
            step, state = runs[torch.float32 if name == "float32"
                               else torch.bfloat16]
            with forms[name]():
                ms[name] += checks.device_ms(lambda: step(state), reps=3) / 2
        where = f"256³ parity on {slabs} z-slabs" if slabs else "256³ parity"
        kernel = "jacobi3_slab_bf16" if slabs else "jacobi3_sweep_bf16"
        row = "  ".join(f"{name} {ms[name]:.4f}" for name in bf16_forms[1:])
        print(f"{where}, bf16 step as a CUDA graph: path {ms['path']:.4f} ms "
              f"(launches by width {outs['path'][1][kernel]}), float32 "
              f"{ms['float32']:.4f}; path/float32 "
              f"{ms['path'] / ms['float32']:.3f}; states "
              f"{'equal bit for bit' if same else 'DIFFER'} ({card})\n"
              f"    {row}", flush=True)
    return failures


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--walks", default="1,2,3,4,6")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--no-solves", action="store_true")
    ap.add_argument("--steps", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_sweep3_bf16: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from fluidsimulationcuda_torch.kernels import build
    from fluidsimulationcuda_torch.kernels import cuda_ops as co

    card = card_line()
    lib_path = build.build()
    print(f"card: {card}; torch {torch.__version__}; library {lib_path}",
          flush=True)
    if args.sass:
        sass_report(lib_path)
    widths = tuple(co.VECTOR_WIDTHS["jacobi3_sweep_bf16"])
    walks = tuple(int(w) for w in args.walks.split(","))
    failures = sweep_table(build.load(), widths, walks, card)
    if not args.no_solves:
        failures += solve_table(widths, walks, card)
    if args.steps:
        failures += step_table(widths, walks, card)
    print(f"{failures} failure(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
