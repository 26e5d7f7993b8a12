#!/usr/bin/env python3
"""T3, the sweeps of one launch of the tiled 3-D Jacobi
(``csrc/jacobi3_tiles.cu``), and the route of the fast Chebyshev solves
(``cuda_ops.tiled3``), by measurement on the card.

    python3 dev/bench_sweeps3.py [--per-launch 1,2,3,4,5,6]
                                 [--only volume,slab,thin]
                                 [--dtypes float32,bfloat16]

At 256³ it times the compensated point's Chebyshev+fast solves, the one
mode the tiled kernel has (``PERF_POINT_3D``: the velocity solve with its
source fold and the zero-guess pressure solve), on a volume (K5), as
segments on an interior z-slab of 32 planes with the 8-slab step's halo
(K13; buffers of 54 and 58 planes), and as the 32-slab step's 7-sweep
segment on a slab of 8 planes (``thin``: a 24-plane buffer, which
``cuda_ops.tiled3`` leaves to the per-sweep K13), each at every T of
``--per-launch`` and on the per-sweep kernel (T = 0), in one process on
one card (device ms of a call, CUDA graphs of 20 calls,
``checks.device_ms``; the T values in turns forward, then backward, and
the mean), in each storage of ``--dtypes`` (bf16: the fields rounded to
bf16, the tiled kernel's and the per-sweep kernel's bf16 forms; on a
z-slab the rhs taken as already times 1/beta, as the bf16 step hands it
on).  Every tiled result is first held bit for bit against the per-sweep
chain.  Prints each time, its share of the solve's bound
(``checks._sweeps_cost``, ``checks._slab3_sweeps_cost``) and the card's
name and power limit.  Exits non-zero without a card or on a difference.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SIDE = 256


def volume(dtype) -> dict:
    """The two fast Chebyshev solves on a volume (K5)."""
    from fluidsimulationcuda_torch.core.config import PERF_POINT_3D
    from fluidsimulationcuda_torch.kernels import checks
    from fluidsimulationcuda_torch.kernels import cuda_ops_3d as co3

    rho, k_d, k_p = PERF_POINT_3D
    t = checks._Inputs(SIDE, "cuda", 0, ndim=3)
    av, bf16 = t.a_visc, dtype == torch.bfloat16
    src, x0, p = (f.to(dtype) for f in (t.src, t.x0, t.p))
    name = str(dtype)[6:]

    def vol(b, x, rhs, a, beta, iters, **kw):
        return lambda: co3.fused_jacobi3(b, x, rhs, a, beta, iters,
                                         fast=True, cheby_rho=rho, **kw)

    return {
        f"{name} volume {k_d}it chebyshev+fast (u)": (
            vol(1, src, x0, av, 1 + 6 * av, k_d, src_dt=checks.DT),
            checks._sweeps_cost(k_d, 3, src=True, fast=True, cheby=True,
                                bf16=bf16), t.cells),
        f"{name} volume {k_p}it chebyshev+fast (pressure)": (
            vol(0, p, p, 1.0, 6.0, k_p, zero_init=True),
            checks._sweeps_cost(k_p, 3, zero_init=True, fast=True,
                                cheby=True, bf16=bf16), t.cells),
    }


def segments(mz: int, dtype) -> dict:
    """The two fast Chebyshev segments on an interior slab of ``mz``
    planes (K13)."""
    from fluidsimulationcuda_torch.core.config import PERF_POINT_3D
    from fluidsimulationcuda_torch.kernels import checks
    from fluidsimulationcuda_torch.kernels import cuda_sharded_3d as cs3

    rho, k_d, k_p = PERF_POINT_3D
    t = checks._Slab3Inputs(SIDE, mz, "cuda", 0)
    i, av = t.slabs // 2, t.a_visc
    Kd, Kp = min(k_d, mz - 1), min(k_p, mz - 1)
    bf16 = dtype == torch.bfloat16
    what = f"{str(dtype)[6:]} slab of {mz} planes"

    def slab(b, x, x0, iters, **kw):
        H = iters + 1
        xe, re_ = t.ext(x, i, H).to(dtype), t.ext(x0, i, H).to(dtype)
        return lambda: cs3.fused_cheby3_slab(
            b, xe, None, re_, t.flags(i), mz=mz, H=H, cheby_rho=rho,
            start=0, sweeps=iters, fast=True, **kw)

    def cost(iters, **kw):
        return checks._slab3_sweeps_cost(
            iters, mz + 2 * (iters + 1), SIDE, fast=True, cheby=True,
            bf16=bf16, **kw)

    return {
        f"{what} {Kd}it chebyshev fast (u)": (
            slab(1, t.src, t.x0, Kd, alpha=av, beta=1 + 6 * av),
            cost(Kd), 1),
        f"{what} {Kp}it chebyshev fast (pressure)": (
            slab(0, t.p, t.p, Kp, alpha=1.0, beta=6.0, zero_init=True),
            cost(Kp, zero_init=True), 1),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--per-launch", default="1,2,3,4,5,6")
    ap.add_argument("--only", default="volume,slab,thin")
    ap.add_argument("--dtypes", default="float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_sweeps3: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from fluidsimulationcuda_torch.kernels import build, checks
    from fluidsimulationcuda_torch.kernels import cuda_ops as co

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}; library "
          f"{build.build()}")
    per_launch = [int(t) for t in args.per_launch.split(",")]
    solves = {}
    for name in args.dtypes.split(","):
        dtype = getattr(torch, name)
        if "volume" in args.only:
            solves.update(volume(dtype))
        if "slab" in args.only:
            solves.update(segments(32, dtype))
        if "thin" in args.only:
            solves.update(segments(8, dtype))
    failures = 0
    for name, (fn, cost, cells) in solves.items():
        bound, bound_by = checks.Check(name, (), None, None, cost,
                                       cells).bound()

        def run(per):
            with co.launch_sweeps(per):
                return fn()

        want = _as_tuple(run(0))
        for per in per_launch:
            if not all(map(torch.equal, _as_tuple(run(per)), want)):
                failures += 1
                print(f"  FAIL {name} T={per}: differs from the per-sweep "
                      f"chain")
        order = [0, *per_launch]
        ms = dict.fromkeys(order, 0.0)
        for per in order + order[::-1]:
            ms[per] += checks.device_ms(lambda per=per: run(per)) / 2
        chain = ms[0]
        line = "  ".join(f"T={per}: {ms[per]:.5f} "
                         f"({100 * bound / ms[per]:.1f}%)"
                         for per in per_launch)
        best = min(per_launch, key=ms.__getitem__)
        print(f"{name}: bound {bound:.5f} ms ({bound_by}); per-sweep "
              f"{chain:.5f} ms ({100 * bound / chain:.1f}%); {line}; best "
              f"T={best} ({chain / ms[best]:.2f}x the per-sweep kernel) "
              f"({card})", flush=True)
    print(f"{failures} failure(s)")
    return 1 if failures else 0


def _as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


if __name__ == "__main__":
    sys.exit(main())
