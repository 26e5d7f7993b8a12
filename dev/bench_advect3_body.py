#!/usr/bin/env python3
"""The 3-D gathers on the shared body (``csrc/advect3_body.cuh``) on the
card: the grouped K14 and K6's bf16 form against the forms of another tree
(a parent commit) and against every per-thread design of the body.

    python3 dev/bench_advect3_body.py --parent build/parent [--flows ...]
                                      [--no-variants] [--sass]

Builds the kernel library of this tree, of ``--parent`` (a checkout whose
``fluidsimulationcuda_torch/csrc`` has the same C entry points, e.g. ``git
archive HEAD~`` unpacked into a gitignored directory) and, unless
``--no-variants``, of this tree's sources with ``dev/advect3_variants/``
beside them (every brick of 1, 2 and 4 planes, 1, 2 and 4 cells a thread,
x-pairs as one load or two, the read-only path or not).  Then, at 256³, on
each flow (random, smooth and shear velocities of ``checks``; the step's
own state after 4 and after 301 steps of ``chip_smoke``'s impulse run, the
256³ parity step, whose share of zero velocity cells it prints), in
float32 and in bf16, it times (device ms of a call, CUDA graphs of
``--reps`` calls, ``checks.device_ms``; the parent's and this tree's in
turns parent, this, this, parent):

- K6's exact triple and density on the whole volume: the parent's and
  this tree's, and each design of the body on both;
- K14's windowed (4-cell window) triple and density over the 8 z-slabs of
  32 planes: the parent's route (``mesh._ext`` of each field, then one
  per-slab launch a slab) and its kernels alone on prebuilt extended
  slabs, against this tree's grouped launch, and each design of the body
  on both;
- K14's exact triple over the 8 slabs (the parent's ``mesh._gather`` and 8
  launches), the windowed triple over 32 slabs of 8 planes and the exact
  triple over 64 slabs of 4 planes, parent route against grouped.

Every grouped and body result is held bit for bit against the parent's on
the same inputs.  ``--sass`` prints, for each gather kernel of both
libraries, its global loads by width and how many take the read-only path
(``cuobjdump -sass``).  Prints the card's name and power limit; exits
non-zero without a card.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import itertools
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = ROOT / "dev" / "advect3_variants"
FLOWS = ("random", "smooth", "shear", "step 4", "step 301")
DESIGNS = list(itertools.product((1, 2, 4), (1, 2, 4), (0, 1), (0, 1)))
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
GROUP_ARGS = [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P,
              _I, _I, _I, _I]
VOLUME_ARGS = [_P] * 9 + [_I] * 4 + [_F, _I, _P, _I, _I, _I, _I]


def variants_library():
    """This tree's sources with the body's designs beside them, built."""
    from fluidsimulationcuda_torch.kernels import build

    out = ROOT / "build" / "advect3_variants" / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    for src in VARIANTS.glob("*.cu*"):
        shutil.copy(src, out / src.name)
    lib = build.open_library(build.build(csrc=out))
    for name in ("fsc_advect3_group_variant", "fsc_advect3_volume_variant"):
        for tag in ("", "_bf16"):
            fn = getattr(lib, name + tag)
            fn.argtypes = GROUP_ARGS if "group" in name else VOLUME_ARGS
            fn.restype = ctypes.c_int
    return lib


def flows(side: int, names) -> dict:
    """name -> (u, v, w, dens), float32 volumes on the card."""
    from fluidsimulationcuda_torch import SimConfig, StableFluids3D, reference_init
    from fluidsimulationcuda_torch.kernels import checks

    out = {}
    t = checks._Inputs(side, "cuda", 0, ndim=3)
    for name, vel in checks.gather_velocities(t).items():
        if name in names:
            out[name] = (*vel, t.x)
    steps = [int(n.split()[1]) for n in names if n.startswith("step")]
    if steps:
        cfg = SimConfig(n=side - 2, ndim=3, jacobi_iters=20, backend="cuda",
                        device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        state, sources = reference_init(gen, cfg)
        sim = StableFluids3D(cfg)
        state = sim.step(state, sources)
        for k in range(2, max(steps) + 1):
            state = sim.step(state)
            if k in steps:
                out[f"step {k}"] = (state.u, state.v, state.w, state.dens)
    return out


def zero_share(u, v, w) -> float:
    return float(((u == 0) & (v == 0) & (w == 0)).float().mean())


def group_call(fn, bs, fields, us, vs, ws, outs, mz, side, dt0, cmax):
    """A closure launching ``fn`` (a grouped entry point of the variants
    library) over every slab of one device, with the table
    ``advect3_group`` builds."""
    pz = len(us)
    srcs = [p for j in range(pz) for p in
            [fields[k][j].data_ptr() for k in range(len(fields))]
            + [None] * (3 - len(fields))]
    starts = [j * mz for j in range(pz)]
    ptrs, walls = [], []
    for i in range(pz):
        ptrs += [us[i].data_ptr(), vs[i].data_ptr(), ws[i].data_ptr(),
                 *(o.data_ptr() for o in outs[i]),
                 *[None] * (3 - len(fields))]
        walls += [i * mz, 0 if i == 0 else -1, mz - 1 if i == pz - 1 else -1]
    tables = ((_P * len(srcs))(*srcs), (_I * pz)(*starts),
              (_P * len(ptrs))(*ptrs), (_I * len(walls))(*walls))
    pad = [0] * (3 - len(bs))

    def run(*design):
        err = fn(ctypes.addressof(tables[0]), ctypes.addressof(tables[1]), pz,
                 ctypes.addressof(tables[2]), ctypes.addressof(tables[3]), pz,
                 mz, side, len(bs), *bs, *pad, dt0, cmax,
                 torch.cuda.current_stream().cuda_stream, *design)
        if err:
            raise RuntimeError(f"variant launch failed: {err}")

    return run


def sass_loads(lib_path: Path, label: str) -> None:
    """Each gather kernel's global loads by width, and how many take the
    read-only path."""
    from fluidsimulationcuda_torch.kernels import build

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if "advect3" not in name:
            continue
        loads = re.findall(r"\bLDG\.E(\.[A-Z0-9.]+)?", block)
        widths = collections.Counter(
            next((w for w in ("U16", "64", "128") if w in (s or "")), "32")
            for s in loads)
        constant = sum("CONSTANT" in (s or "") for s in loads)
        print(f"  {label} {name[:90]}: {len(loads)} LDG, by bits "
              f"{dict(sorted(widths.items()))}, read-only {constant}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--flows", default=",".join(FLOWS))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--no-variants", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_advect3_body: no CUDA device")
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    from fluidsimulationcuda_torch.kernels import build, checks
    from fluidsimulationcuda_torch.kernels import cuda_ops as co
    from fluidsimulationcuda_torch.kernels import cuda_ops_3d as co3
    from fluidsimulationcuda_torch.kernels import cuda_sharded_3d as cs3
    from fluidsimulationcuda_torch.parallel.mesh import _ext, _gather

    names = args.flows.split(",")
    parent_path = build.build(
        csrc=args.parent / "fluidsimulationcuda_torch" / "csrc")
    this_path = build.build()
    libs = {"parent": build.open_library(parent_path),
            "this": build.open_library(this_path)}
    var = None if args.no_variants else variants_library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(f"device ms per call ({card}); parent and this tree in turns "
          f"parent, this, this, parent")
    if args.sass:
        sass_loads(parent_path, "parent")
        sass_loads(this_path, "this")

    def turns(fn_of):
        """{tree: ms} of fn_of(tree)'s closure, in turns."""
        ms = collections.defaultdict(list)
        for tree in ("parent", "this", "this", "parent"):
            build._lib = libs[tree]
            fn = fn_of(tree)
            ms[tree].append(checks.device_ms(fn, reps=args.reps))
        build._lib = libs["this"]
        return {k: sum(v) / len(v) for k, v in ms.items()}

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def with_lib(tree, fn):
        build._lib = libs[tree]
        try:
            return fn()
        finally:
            build._lib = libs["this"]

    side, n, dt = 256, 254, checks.DT
    dt0 = co._dt0(dt, n)
    vols = flows(side, names)
    for flow in names:
        u32, v32, w32, d32 = vols[flow]
        print(f"\n{flow}: zero velocity cells {100 * zero_share(u32, v32, w32):.2f}%"
              f", max |u|,|v|,|w| {float(u32.abs().max()):.4g}, "
              f"{float(v32.abs().max()):.4g}, {float(w32.abs().max()):.4g}")
        for dtype in (torch.float32, torch.bfloat16):
            tag = "bf16" if dtype == torch.bfloat16 else "float32"
            sfx = "_bf16" if dtype == torch.bfloat16 else ""
            u, v, w, d = (x.to(dtype).contiguous() for x in
                          (u32, v32, w32, d32))
            # K6, the whole volume, exact.
            for what, bs, fs in (("triple", (1, 2, 3), (u, v, w)),
                                 ("density", (0,), (d,))):
                def k6(tree, bs=bs, fs=fs):
                    return lambda: co3.advect3_shift_fused(bs, fs, u, v, w,
                                                           dt, n)
                ref = with_lib("parent", k6("parent"))
                got = with_lib("this", k6("this"))
                ms = turns(k6)
                print(f"  K6 {tag} {what}: parent {ms['parent']:.5f} this "
                      f"{ms['this']:.5f} ms, bit for bit {same(ref, got)}")
                if var is not None:
                    outs = [torch.empty_like(u) for _ in bs]
                    fn = getattr(var, f"fsc_advect3_volume_variant{sfx}")
                    ptrs = [f.data_ptr() for f in fs] + [None] * (3 - len(fs))
                    bb = list(bs) + [0] * (3 - len(bs))

                    def vol(*design, outs=outs, fn=fn, ptrs=ptrs, bb=bb):
                        err = fn(*ptrs, u.data_ptr(), v.data_ptr(),
                                 w.data_ptr(),
                                 *(o.data_ptr() for o in outs),
                                 *[None] * (3 - len(outs)), side, *bb, dt0,
                                 0, torch.cuda.current_stream().cuda_stream,
                                 *design)
                        if err:
                            raise RuntimeError(f"variant failed: {err}")
                    line = []
                    for design in DESIGNS:
                        vol(*design)
                        ok = same(outs, ref)
                        t = checks.device_ms(lambda: vol(*design),
                                             reps=args.reps)
                        line.append(f"{design}:{t:.5f}{'' if ok else '!'}")
                    print(f"  K6 {tag} {what} designs (brick, vec, pair, "
                          f"ldg):ms: " + " ".join(line))
            # K14 over z-slabs.
            for pz, exact, parts in ((8, False, ("triple", "density")),
                                     (8, True, ("triple",)),
                                     (32, False, ("triple",)),
                                     (64, True, ("triple",))):
                mz = side // pz
                cmax = None if exact else 4
                cut = [list(x.split(mz)) for x in (u, v, w, d)]
                us, vs, ws, ds = ([s.contiguous() for s in c] for c in cut)
                flags = [(int(i == 0), int(i == pz - 1), i * mz)
                         for i in range(pz)]
                form = "exact" if exact else "windowed"
                for what in parts:
                    bs, fields = (((1, 2, 3), (us, vs, ws))
                                  if what == "triple" else ((0,), (ds,)))

                    def route(tree, bs=bs, fields=fields):
                        if tree == "this":
                            return lambda: cs3.advect3_group(
                                bs, fields, us, vs, ws, flags, dt=dt, n=n,
                                cmax=cmax, mz=mz)
                        if exact:
                            return lambda: [
                                cs3.advect3_flat_slab_exact(
                                    bs, fs, ui, vi, wi, fl, dt=dt, n=n,
                                    mz=mz)
                                for fs, ui, vi, wi, fl in zip(
                                    zip(*[_gather(f) for f in fields]), us,
                                    vs, ws, flags)]
                        return lambda: [
                            cs3.advect3_flat_slab(bs, es, ui, vi, wi, fl,
                                                  dt=dt, n=n, cmax=cmax,
                                                  mz=mz)
                            for es, ui, vi, wi, fl in zip(
                                zip(*[_ext(f, cmax + 1) for f in fields]),
                                us, vs, ws, flags)]
                    ref = with_lib("parent", route("parent"))
                    got = with_lib("this", route("this"))
                    ms = turns(route)
                    # The parent's kernels alone, on prebuilt buffers.
                    bufs = ([_gather(f) for f in fields] if exact else
                            [_ext(f, cmax + 1) for f in fields])
                    build._lib = libs["parent"]
                    if exact:
                        kern = checks.device_ms(lambda: [
                            cs3.advect3_flat_slab_exact(
                                bs, fs, ui, vi, wi, fl, dt=dt, n=n, mz=mz)
                            for fs, ui, vi, wi, fl in zip(
                                zip(*bufs), us, vs, ws, flags)],
                            reps=args.reps)
                    else:
                        kern = checks.device_ms(lambda: [
                            cs3.advect3_flat_slab(bs, es, ui, vi, wi, fl,
                                                  dt=dt, n=n, cmax=cmax,
                                                  mz=mz)
                            for es, ui, vi, wi, fl in zip(
                                zip(*bufs), us, vs, ws, flags)],
                            reps=args.reps)
                    build._lib = libs["this"]
                    del bufs
                    print(f"  K14 {tag} {form} {what}, {pz} slabs of {mz}: "
                          f"parent route {ms['parent']:.5f} (its {pz} "
                          f"launches alone {kern:.5f}), grouped "
                          f"{ms['this']:.5f} ms, bit for bit "
                          f"{all(same(a, b) for a, b in zip(ref, got))}")
                    if var is not None and pz == 8 and not exact:
                        outs = [tuple(torch.empty_like(s) for _ in bs)
                                for s in us]
                        run = group_call(
                            getattr(var, f"fsc_advect3_group_variant{sfx}"),
                            bs, fields, us, vs, ws, outs, mz, side, dt0,
                            cmax)
                        line = []
                        for design in DESIGNS:
                            run(*design)
                            ok = all(same(a, b) for a, b in zip(outs, ref))
                            t = checks.device_ms(lambda: run(*design),
                                                 reps=args.reps)
                            line.append(f"{design}:{t:.5f}"
                                        f"{'' if ok else '!'}")
                        print(f"  K14 {tag} windowed {what} designs (brick, "
                              f"vec, pair, ldg):ms: " + " ".join(line))
                del us, vs, ws, ds, cut
            del u, v, w, d
    print("\n('!' after a time: that design's result differed from the "
          "parent's)")


if __name__ == "__main__":
    main()
