#!/usr/bin/env python3
"""Time the grouped K11-block and K12-block on the card, every per-thread
design of ``dev/block_stencil_variants/`` beside the kept one and beside
the per-block route they replaced.

    python3 dev/bench_block_stencils.py [--kernels] [--steps] [--late N]

``--kernels`` builds this tree's library and a copy of its sources with
the variants beside them, then at 2048² on (2, 4) blocks, in float32 and
bf16, on each flow (random fields of ``checks``; its smooth and shear
velocities; the block step's own state after 4 and after ``--late`` + 1
steps of ``chip_smoke``'s impulse run, the 2048² parity step on (2, 4)
blocks, exact), times (device ms a call, CUDA graphs of 20,
``checks.device_ms``):

- the gradient over every block: the per-block route (``Blocks.halos``
  of p, then 8 K11-block launches), the kept grouped form, and every
  design (1, 2, 4 and, in bf16, 8 cells a thread; p's edge cells loaded
  or taken from the neighbouring lanes by shuffles; a zero numerator its
  own quotient or divided), on the flow's velocity and the pressure the
  block step's own projection solves from it (random p on random fields);
- the windowed (4-cell window) and exact gathers of the u/v pair and of
  the density (p's blocks, by the velocity): the per-block route
  (``Blocks.ext`` or ``Blocks.gather``, then 8 K12-block launches), the
  kept grouped form and every design (1, 2 and 4 cells a thread, each
  corner row's x-pair as one access where aligned, on the read-only path
  or plain, or as two; the corners of a departure that leaves the block
  read by an out-of-line call or inline; and, for the kept shapes, a
  launch bound of 6 or 8 blocks of 256 threads an SM, which holds a
  thread to 40 or 32 registers);
- beside them the single-device K2 gradient and K3 pair on the whole
  grid, the work the grouped forms do without the blocks.

Each result is held bit for bit against the per-block route; the shares
of zero velocity and pressure cells are printed beside each flow.

``--steps`` times the block steps (``dev/bench_block_group.step_runs``:
2048² on (2, 4) parity, compensated with fast math, multigrid two cycles
and CG-20, parity and compensated in bf16; 8192² on (2, 2)) on the
grouped stencils and on the per-block ones (``_BlockStep`` with
``gradient_group`` and ``advect_group`` set to None), in turns, as CUDA
graphs and eager, after 4 and ``--late`` + 1 steps, with their launches
a step and, after 4, the share of device time their copies take.

Every number goes with the card's name and power limit.  Needs a CUDA
device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "dev"))

import bench_block_group as bbg  # noqa: E402
import chip_smoke  # noqa: E402
from fluidsimulationcuda_torch import SimConfig  # noqa: E402
from fluidsimulationcuda_torch.kernels import build, checks  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_ops as co  # noqa: E402
from fluidsimulationcuda_torch.kernels import cuda_sharded as cs  # noqa: E402

DEVICE = "cuda"
VARIANTS = ROOT / "dev" / "block_stencil_variants"
SIDE, SHAPE = 2048, (2, 4)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
GRAD_ARGS = [_P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P]
GATHER_ARGS = [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I,
               _I, _I, _I, _I, _I, _P]
# (width, shuffle, skip, min blocks) of the gradient; (width, pair, call,
# min blocks) of the gathers: pair 0 two loads, 1 one read-only access, 2
# one plain access; call 1 the corners of a departure that leaves the
# block out of line; min blocks the launch bound's blocks an SM (1: none;
# 6: at most 40 registers a thread, 8: 32).
GRAD_DESIGNS = [(1, 0, 0, 1), (1, 0, 1, 1)] + [
    (w, sh, sk, 1) for w in (2, 4) for sh in (0, 1) for sk in (0, 1)] + [
    (2, 0, 1, 8), (4, 0, 1, 8)]
GRAD_DESIGNS_BF16 = GRAD_DESIGNS + [
    (8, sh, sk, 1) for sh in (0, 1) for sk in (0, 1)] + [(8, 0, 1, 8)]
GATHER_DESIGNS = [(w, p, c, 1) for w in (1, 2, 4)
                  for p, c in ((0, 0), (1, 0), (2, 0), (0, 1), (2, 1))] + [
    (w, 0, 0, mb) for w in (1, 2, 4) for mb in (6, 8)]
GATHERS = {"pair": ((1, 2), checks.SLAB_CMAX), "density": ((0,),
                                                           checks.SLAB_CMAX),
           "exact pair": ((1, 2), None), "exact density": ((0,), None)}


def libraries():
    """(this tree's library, the variants' library), built at once."""
    out = ROOT / "build" / "block_stencil_variants" / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    for src in VARIANTS.glob("*.cu*"):
        shutil.copy(src, out / src.name)
    with ThreadPoolExecutor(2) as pool:
        paths = list(pool.map(lambda t: build.build(csrc=t),
                              (build.CSRC, out)))
    path, var = (build.open_library(p) for p in paths)
    for name, args in (("fsc_gradient_block_group_variant", GRAD_ARGS),
                       ("fsc_advect_block_group_variant", GATHER_ARGS)):
        for tag in ("", "_bf16"):
            fn = getattr(var, name + tag)
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return path, var


@contextlib.contextmanager
def design(lib, width: int, *extra: int):
    """Every grouped gradient or gather launch of the block within takes
    the variants library ``lib``'s design: ``width`` cells a thread and
    ``extra`` (shuffle, skip, min blocks for the gradient; pair, call,
    min blocks for the gathers)."""
    saved = co._launch_vector

    def launch(kernel, w, fn, *args):
        tag = "_bf16" if kernel.endswith("_bf16") else ""
        if kernel.startswith("gradient_block_group"):
            fn = getattr(lib, "fsc_gradient_block_group_variant" + tag)
            args = (*args[:-1], *extra, args[-1])
        elif kernel.startswith("advect_block_group"):
            fn = getattr(lib, "fsc_advect_block_group_variant" + tag)
            args = (*args[:-1], int("_exact" in kernel), *extra, args[-1])
        else:
            return saved(kernel, w, fn, *args)
        # A variant's width may be one the path does not count.
        return co._launch(kernel, fn, *args)

    build._lib = lib
    co._launch_vector = launch
    try:
        with co.vector_widths((width,)):
            yield
    finally:
        co._launch_vector = saved


def zero_share(parts) -> float:
    t = torch.cat([p.flatten() for p in parts])
    return 100 * float((t == 0).float().mean())


def step_state(late: int):
    """{flow: (u, v) global fields} of the 2048² parity block step after 4
    and ``late`` + 1 steps, and the block step itself."""
    from fluidsimulationcuda_torch import zero_sources
    from fluidsimulationcuda_torch.parallel import (make_mesh, shard_blocks,
                                                    unshard)
    from fluidsimulationcuda_torch.parallel.sharded import _BlockStep

    cfg = SimConfig(n=SIDE - 2, backend="cuda", device=DEVICE)
    mesh = make_mesh([torch.device(DEVICE, 0)] * 8, shape=SHAPE)
    step = _BlockStep(cfg, mesh, False, True)
    state0, sources = bbg._draw(cfg)
    zeros = shard_blocks(zero_sources(cfg), mesh)
    state = step(shard_blocks(state0, mesh), shard_blocks(sources, mesh))
    flows = {}
    for done in range(2, late + 2):
        state = step(state, zeros)
        if done in (4, late + 1):
            full = unshard(state, mesh)
            flows[f"step {done}"] = (full[1], full[2])
    return flows, step


def pressure(step, us, vs):
    """The pressure blocks the block step's projection solves from the
    velocity blocks (its divergence, then its Jacobi solve)."""
    n, blocks = step.cfg.n, step.blocks
    div = [step.ops.divergence(u, v, uh, vh, o, n) for u, v, uh, vh, o in
           zip(us, vs, blocks.halos(us), blocks.halos(vs), blocks.origins)]
    return step._pressure(div)


def kernel_times(card: str, path, var, late: int) -> None:
    t = checks._Inputs(SIDE, DEVICE, chip_smoke.SEED)
    flows = {"random": (t.u, t.v), "smooth": t.smooth[:2],
             "shear": t.shear[:2]}
    build._lib = path
    states, step = step_state(late)
    flows.update(states)
    blocks, n = step.blocks, SIDE - 2
    print(f"\ngrouped K11-block and K12-block over the {SHAPE} blocks of "
          f"{SIDE}², device ms a call (CUDA graph of 20; {card}):")
    for flow, (u, v) in flows.items():
        for dtype in (torch.float32, torch.bfloat16):
            build._lib = path
            bf16 = dtype == torch.bfloat16
            us, vs = (list(blocks.cut(f.float())) for f in (u, v))
            ps = ([b.float() for b in blocks.cut(t.p)] if flow == "random"
                  else pressure(step, us, vs))
            us, vs, ps = ([b.to(dtype) for b in f] for f in (us, vs, ps))
            tag = f"{flow} {'bf16' if bf16 else 'float32'}"
            print(f"  {tag}: zero u {zero_share(us):.2f}%, v "
                  f"{zero_share(vs):.2f}%, p {zero_share(ps):.2f}% of cells")
            grad_line(tag, blocks, us, vs, ps, n, path, var, bf16)
            for name, (bs, cmax) in GATHERS.items():
                gather_line(tag, name, blocks, bs, cmax, us, vs, ps, n, path,
                            var)
            build._lib = path
            uf, vf, pf = (blocks.stitch(f) for f in (us, vs, ps))
            single = {"K2 gradient": lambda: co.gradient_p(uf, vf, pf, n),
                      "K3 pair (4-cell window)": lambda: co.advect_shift_fused(
                          (1, 2), (uf, vf), uf, vf, checks.DT, n,
                          checks.SLAB_CMAX)}
            print(f"  {tag} single-device on the whole grid: " + ", ".join(
                f"{k} {checks.device_ms(fn):.5f}" for k, fn in
                single.items()))


def grad_line(tag, blocks, us, vs, ps, n, path, var, bf16) -> None:
    want = cs.gradient_blocks_composed(cs.gradient_block, blocks, us, vs, ps,
                                       n)
    route = checks.device_ms(lambda: cs.gradient_blocks_composed(
        cs.gradient_block, blocks, us, vs, ps, n))
    got = cs.gradient_blocks(blocks, us, vs, ps, n)
    same(got, want, f"{tag} gradient kept")
    kept = checks.device_ms(lambda: cs.gradient_blocks(blocks, us, vs, ps,
                                                      n))
    line = (f"  {tag} gradient: per-block route {route:.5f}, kept "
            f"{kept:.5f};")
    for width, shuffle, skip, mb in (GRAD_DESIGNS_BF16 if bf16
                                     else GRAD_DESIGNS):
        with design(var, width, shuffle, skip, mb):
            got = cs.gradient_blocks(blocks, us, vs, ps, n)
            same(got, want, f"{tag} gradient V{width} {shuffle} {skip} {mb}")
            ms = checks.device_ms(lambda: cs.gradient_blocks(blocks, us, vs,
                                                             ps, n))
        line += (f" V{width}{' shfl' if shuffle else ''}"
                 f"{' skip' if skip else ''}"
                 f"{f' min{mb}' if mb > 1 else ''} {ms:.5f}")
    build._lib = path
    print(line)


def gather_line(tag, name, blocks, bs, cmax, us, vs, ps, n, path,
                var) -> None:
    self_adv = len(bs) == 2
    fields = (us, vs) if self_adv else (ps,)
    kw = dict(dt=checks.DT, n=n, cmax=cmax, self_adv=self_adv)
    none = [None] * len(us)
    vel = (none, none) if self_adv else (us, vs)

    def per():
        return cs.advect_blocks_composed(cs.advect_block,
                                         cs.advect_block_exact, blocks, bs,
                                         fields, *vel, **kw)

    def grouped():
        return cs.advect_blocks(blocks, bs, fields, us, vs, **kw)

    want = per()
    route = checks.device_ms(per)
    same(grouped(), want, f"{tag} {name} kept")
    kept = checks.device_ms(grouped)
    line = f"  {tag} {name}: per-block route {route:.5f}, kept {kept:.5f};"
    for width, pair, call, mb in GATHER_DESIGNS:
        with design(var, width, pair, call, mb):
            same(grouped(), want, f"{tag} {name} V{width} {pair} {call} {mb}")
            ms = checks.device_ms(grouped)
        line += (f" V{width}{['', ' pair', ' plainpair'][pair]}"
                 f"{' call' if call else ''}"
                 f"{f' min{mb}' if mb > 1 else ''} {ms:.5f}")
    build._lib = path
    print(line)


def same(got, want, what: str) -> None:
    flat = [x for r in got for x in r]
    ref = [x for r in want for x in r]
    if checks.max_abs_diff(flat, ref) != 0.0:
        raise AssertionError(f"{what} differs from the per-block route")


def step_times(card: str, path, late: int) -> None:
    from fluidsimulationcuda_torch import zero_sources
    from fluidsimulationcuda_torch.parallel import make_mesh, shard_blocks
    from fluidsimulationcuda_torch.parallel.sharded import _BlockStep

    build._lib = path
    print(f"\nblock steps, exact gathers, grouped and per-block stencils, "
          f"ms/step ({card}):")
    for label, cfg, shape in bbg.step_runs():
        px, py = shape
        mesh = make_mesh([torch.device(DEVICE, 0)] * (px * py), shape=shape)
        state0, sources = bbg._draw(cfg)
        zeros = shard_blocks(zero_sources(cfg), mesh)
        grouped = _BlockStep(cfg, mesh, False, True)
        per_block = _BlockStep(cfg, mesh, False, True)
        per_block.ops = per_block.ops._replace(gradient_group=None,
                                               advect_group=None)
        routes = {"per-block stencils": per_block, "grouped": grouped}
        names = list(routes)
        for name, fn in routes.items():
            co.reset_launch_counts()
            fn(shard_blocks(state0, mesh), zeros)
            torch.cuda.synchronize()
            print(f"{label} on {shape}: {name} "
                  f"{sum(co.launch_counts().values())} launches a step")
        state = grouped(shard_blocks(state0, mesh),
                        shard_blocks(sources, mesh))
        done = 1
        for when in (bbg.WARM, late):
            for _ in range(when - (done - 1)):
                state = grouped(state, zeros)
            done = when + 1
            tag = f"{label} on {shape}, state after {done} steps"
            want = grouped(state, zeros)
            if not bbg._same(per_block(state, zeros), want):
                raise AssertionError(f"{tag}: the per-block stencils differ")
            got = {name: [] for name in names}
            for name in names + names[::-1]:
                fn = routes[name]
                _, eager = chip_smoke.timed_steps(lambda s: fn(s, zeros),
                                                  state, 2)
                graph = checks.device_ms(lambda: fn(state, zeros), reps=2)
                got[name].append((graph, eager))
            share = {}
            if when == bbg.WARM:
                for name in names:
                    per_kernel = chip_smoke.profile_step(
                        lambda: routes[name](state, zeros), f"{tag} {name}",
                        card)
                    share[name] = chip_smoke.copy_share(per_kernel)
            for name in names:
                runs = got[name]
                graph = sum(r[0] for r in runs) / len(runs)
                eager = sum(r[1] for r in runs) / len(runs)
                extra = (f", copies {100 * share[name]:.1f}% of device time"
                         if name in share else "")
                print(f"{tag}: {name} graph {graph:.4f} ms, eager "
                      f"{eager:.4f} ms{extra} (runs graph, eager: {runs}) "
                      f"({card})")
        del state, zeros, grouped, per_block, want


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", action="store_true")
    parser.add_argument("--steps", action="store_true")
    parser.add_argument("--late", type=int, default=300,
                        help="steps after the impulse step before the "
                             "later state")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_block_stencils.py needs a CUDA device")
    card = chip_smoke.card_line()
    print(card)
    path, var = libraries()
    build._lib = path
    if args.kernels:
        kernel_times(card, path, var, args.late)
    if args.steps:
        step_times(card, path, args.late)


if __name__ == "__main__":
    main()
