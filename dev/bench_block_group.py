#!/usr/bin/env python3
"""Time the grouped K9-block on the card, on a step's own fields, beside
the per-block route it replaced.

    python3 dev/bench_block_group.py [--steps] [--chunks] [--divide]
                                     [--late N]

``--steps`` times the block steps (2048² on (2, 4): parity, compensated
with fast math, multigrid two cycles and CG-20, exact; parity and
compensated in bf16; 8192² on (2, 2), 40 iterations, exact) on the
grouped kernel and on the per-block route (``Blocks.ext``, then one
launch a block), in turns, as CUDA graphs and eager, from two states of
the run ``chip_smoke.block_path`` drives: after the impulse step (the
reference draw's sources) and ``WARM`` steps without sources, and after
``--late`` steps (300 by default).  Each route's step is first held bit
for bit against the grouped one, and one step of each is traced for the
share of device time its copies take.

``--chunks`` times the grouped chunk (the 8-sweep Jacobi velocity chunk,
the fast chained Chebyshev chunk, the zero-guess pressure chunk and the
damped 2-sweep smooth) on tiles of 32 and 64 rows over the (2, 4) blocks
of 2048², the (64, 1) blocks of 512² (the slab route's deep-halo
Chebyshev) and the (2, 2) blocks of 8192², float32 and bf16, beside its
bound and the per-block route, on the velocity of a single-device run
after ``--late`` steps and its divergence.

``--divide`` also builds a copy of the kernel sources whose grouped
kernel divides every numerator, as the per-block kernel does, instead of
taking a zero numerator as its own quotient (``kSkipZero``: the IEEE
division takes a slow path on zeros), and times the grouped route on it
too, held bit for bit to the path's.

Every number goes with the card's name and power limit.  Needs a CUDA
device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from fluidsimulationcuda_torch import SimConfig  # noqa: E402
from fluidsimulationcuda_torch.core.config import PERF_POINTS_2D  # noqa: E402
from fluidsimulationcuda_torch.kernels import build, checks  # noqa: E402

DEVICE = "cuda"
WARM = 3  # steps without sources after the impulse step
GRIDS = ((2048, 2, 4), (512, 64, 1), (8192, 2, 2))
# The grouped kernel's sweeps in csrc/jacobi_tiles.cu (kSkipZero true), and
# the copy's.
SKIP_ZERO = "sweeps_body<kRows, kCheby, kFast, kDamp, kLoad, true>("
DIVIDE = "sweeps_body<kRows, kCheby, kFast, kDamp, kLoad, false>("


def divide_tree() -> Path:
    """A copy of ``csrc`` under ``build/`` whose grouped kernel divides
    every numerator."""
    dst = ROOT / "build" / "bench_block_group_divide" / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(build.CSRC, dst)
    src = (dst / "jacobi_tiles.cu").read_text()
    if src.count(SKIP_ZERO) != 1:
        raise SystemExit("the grouped kernel's sweeps not found in "
                         "jacobi_tiles.cu")
    (dst / "jacobi_tiles.cu").write_text(src.replace(SKIP_ZERO, DIVIDE))
    return dst


def libraries(divide: bool) -> dict:
    """The path's library and, with ``divide``, the copy's, built at
    once."""
    trees = {"path": build.CSRC}
    if divide:
        trees["divide"] = divide_tree()
    with ThreadPoolExecutor(len(trees)) as pool:
        paths = list(pool.map(lambda t: build.build(csrc=t), trees.values()))
    return {k: build.open_library(p) for k, p in zip(trees, paths)}


def use(lib) -> None:
    """Launch every wrapper's kernel from ``lib`` from now on."""
    build._lib = lib


def step_runs() -> list[tuple[str, SimConfig, tuple[int, int]]]:
    parity = SimConfig(n=2046, jacobi_iters=20, backend="cuda",
                       device=DEVICE)
    rho, k_d, k_p = PERF_POINTS_2D[2048]
    cheby = parity.replace(pressure_solver="chebyshev",
                           diffusion_solver="chebyshev", cheby_rho=rho,
                           cheby_iters=k_d, cheby_press_iters=k_p,
                           fast_math=True)
    return [
        ("2048² parity", parity, (2, 4)),
        ("2048² compensated fast_math", cheby, (2, 4)),
        ("2048² multigrid 2 cycles",
         parity.replace(pressure_solver="multigrid", mg_cycles=2), (2, 4)),
        ("2048² CG-20", parity.replace(pressure_solver="cg", cg_iters=20),
         (2, 4)),
        ("2048² parity bf16", parity.replace(dtype=torch.bfloat16), (2, 4)),
        ("2048² compensated fast_math bf16",
         cheby.replace(dtype=torch.bfloat16), (2, 4)),
        ("8192² parity 40 it",
         SimConfig(n=8190, jacobi_iters=40, backend="cuda", device=DEVICE),
         (2, 2)),
    ]


def _draw(cfg):
    """The reference draw (``chip_smoke.SEED``) in ``cfg``'s storage."""
    from fluidsimulationcuda_torch import reference_init

    gen = torch.Generator(device=DEVICE).manual_seed(chip_smoke.SEED)
    state0, sources = reference_init(gen, cfg.replace(dtype=torch.float32))
    return [type(t)(*(x.to(cfg.dtype) for x in t[:3]))
            for t in (state0, sources)]


def zeros_line(name: str, t) -> str:
    """The shares of ``t``'s cells that are zero and subnormal (the two
    the IEEE division takes its slow path on)."""
    t = t.float()
    tiny = torch.finfo(torch.float32).tiny
    sub = ((t != 0) & (t.abs() < tiny)).float().mean()
    return (f"{name} zero at {100 * float((t == 0).float().mean()):.2f}% "
            f"of cells, subnormal at {100 * float(sub):.2f}%")


def _same(a, b) -> bool:
    return all(x is None or torch.equal(x, y)
               for pa, pb in zip(a, b) if pa is not None
               for x, y in zip(pa, pb))


def step_times(card: str, libs: dict, late: int) -> None:
    from fluidsimulationcuda_torch import zero_sources
    from fluidsimulationcuda_torch.parallel import make_mesh, shard_blocks
    from fluidsimulationcuda_torch.parallel.sharded import _BlockStep

    print(f"\nblock steps, exact gathers, ms/step ({card}):")
    for label, cfg, shape in step_runs():
        use(libs["path"])
        mesh = make_mesh([torch.device(DEVICE, 0)] * (shape[0] * shape[1]),
                         shape=shape)
        state0, sources = _draw(cfg)
        state = shard_blocks(state0, mesh)
        zeros = shard_blocks(zero_sources(cfg), mesh)
        grouped = _BlockStep(cfg, mesh, False, True)
        per_block = _BlockStep(cfg, mesh, False, True)
        per_block.ops = per_block.ops._replace(jacobi_group=None,
                                               smooth_group=None)
        routes = {"per-block": (per_block, libs["path"]),
                  "grouped": (grouped, libs["path"])}
        if "divide" in libs:
            routes["grouped, dividing zeros"] = (grouped, libs["divide"])
        names = list(routes)
        turns = names + names[::-1]
        state = grouped(state, shard_blocks(sources, mesh))
        done = 1
        for when in (WARM, late):
            for _ in range(when - (done - 1)):
                state = grouped(state, zeros)
            done = when + 1
            tag = f"{label} on {shape}, state after {done} steps"
            print(f"{tag}: " + zeros_line(
                "u", torch.cat([b.flatten() for b in state[0]])))
            want = grouped(state, zeros)
            for name, (fn, lib) in routes.items():
                use(lib)
                if not _same(fn(state, zeros), want):
                    raise AssertionError(f"{tag}: {name} differs")
            got = {name: [] for name in names}
            for name in turns:
                fn, lib = routes[name]
                use(lib)
                _, eager = chip_smoke.timed_steps(lambda s: fn(s, zeros),
                                                  state, 2)
                graph = checks.device_ms(lambda: fn(state, zeros), reps=2)
                got[name].append((graph, eager))
            share = {}
            if when == WARM:
                for name in names[:2]:
                    fn, lib = routes[name]
                    use(lib)
                    per_kernel = chip_smoke.profile_step(
                        lambda: fn(state, zeros), f"{tag} {name}", card)
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
        use(libs["path"])
        del state, zeros, grouped, per_block, want


def _divergence(u, v):
    """-(du/dx + dv/dy)/2 at the interior cells, zero on the border (the
    shape of the pressure solve's rhs)."""
    d = torch.zeros_like(u)
    d[1:-1, 1:-1] = -0.5 * ((u[1:-1, 2:] - u[1:-1, :-2])
                            + (v[2:, 1:-1] - v[:-2, 1:-1]))
    return d


def chunk_fields(side: int, late: int):
    """(u, v, divergence) of the single-device parity step at ``side``
    after the impulse step and ``late - 1`` steps without sources."""
    from fluidsimulationcuda_torch import StableFluids2D

    cfg = SimConfig(n=side - 2, backend="cuda", device=DEVICE)
    sim = StableFluids2D(cfg)
    state0, sources = _draw(cfg)
    state = sim.step(state0, sources)
    for _ in range(late - 1):
        state = sim.step(state)
    u, v = state[0], state[1]
    return u, v, _divergence(u, v)


def chunk_times(card: str, libs: dict, late: int) -> None:
    from fluidsimulationcuda_torch.kernels import cuda_ops
    from fluidsimulationcuda_torch.parallel.mesh import Blocks

    print(f"\ngrouped K9-block chunks on a step's fields after {late} steps, "
          f"device ms a chunk (CUDA graph of 20; {card}):")
    for side, px, py in GRIDS:
        use(libs["path"])
        u, v, div = chunk_fields(side, late)
        blocks = Blocks(px, py, side)
        print(f"  {side}²: {zeros_line('u', u)}; "
              f"{zeros_line('its divergence', div)}")
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            us, vs, ds = (list(blocks.cut(f.to(dtype))) for f in (u, v, div))
            K = min(checks.BLOCK_CHUNK, blocks.m, blocks.k)
            forms = checks.block_chunk_forms(
                K, checks.DT * checks.VISC * (side - 2) ** 2)
            for mode, (xs, rhs) in (("jacobi", (us, us)),
                                    ("chebyshev+fast chained", (us, us)),
                                    ("zero_init", (us, ds)),
                                    ("damped 2", (us, ds))):
                form = forms[mode]
                args = (form, blocks, xs, rhs, vs, side - 2, K)
                fields, ops = checks._block_group_cost(form, blocks, K)
                bound = checks.Check("", (), None, None,
                                     (fields / 2 if bf16 else fields, ops),
                                     1).bound()[0]
                per = checks.device_ms(
                    lambda: checks.block_chunk("per-block", *args))
                want = checks.block_chunk("per-block", *args)
                line = (f"  {side}² on ({px}, {py}) "
                        f"{'bf16' if bf16 else 'float32'} {mode}: bound "
                        f"{bound:.5f} ms, per-block route {per:.5f} ms;")
                for rows in (32, 64):
                    for name, lib in libs.items():
                        use(lib)
                        with cuda_ops.launch_sweeps(K, tile_rows=rows):
                            got = checks.block_chunk("group", *args)
                            if checks.max_abs_diff(got, want) != 0.0:
                                raise AssertionError(
                                    f"{side}² {mode} {rows} rows {name} "
                                    f"differs from the per-block route")
                            ms = checks.device_ms(
                                lambda: checks.block_chunk("group", *args))
                        line += f" {rows} rows {name} {ms:.5f}"
                print(line)
                use(libs["path"])
            del us, vs, ds
        del u, v, div


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", action="store_true")
    parser.add_argument("--chunks", action="store_true")
    parser.add_argument("--divide", action="store_true",
                        help="also time a copy whose grouped kernel divides "
                             "zero numerators")
    parser.add_argument("--late", type=int, default=300,
                        help="steps before the later state")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_block_group.py needs a CUDA device")
    card = chip_smoke.card_line()
    print(card)
    libs = libraries(args.divide)
    if args.chunks:
        chunk_times(card, libs, args.late)
    if args.steps:
        step_times(card, libs, args.late)


if __name__ == "__main__":
    main()
