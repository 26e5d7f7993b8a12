#!/usr/bin/env python3
"""The bound of every solve row of PERF.md's kernel table, counted as
``kernels/checks.py`` counts it: each input read once and each output
written once, whatever the launches read again, and every sweep's
operations (``_sweeps_cost``, ``_slab_sweeps_cost``,
``_slab3_sweeps_cost``; composed calls by ``_function`` and ``_project``).

    python3 dev/solve_bounds.py

Runs on the CPU and allocates nothing: it evaluates the cost helpers with
the arguments the timing checks give them and prints, per row, the bound
(ms, and whether bytes or operations bind).  Nothing is measured here;
PERF.md sets each bound beside the measured time of its call.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fluidsimulationcuda_torch.core.config import (PERF_POINT_3D,  # noqa: E402
                                                   PERF_POINTS_2D)
from fluidsimulationcuda_torch.kernels import checks as c  # noqa: E402

RHO, K_D, K_P = PERF_POINTS_2D[2048]
_, K_D3, K_P3 = PERF_POINT_3D
C2048, C8192, CBATCH = 2048 ** 2, 8192 ** 2, 1024 * 256 ** 2
C256 = 256 ** 3


def slab(side: int, m: int, iters: int, K: int, **kw):
    """A row-slab solve on an interior slab of ``m`` rows with margin K."""
    return c._slab_sweeps_cost(iters, m + 2 * K, side, **kw), 1


def slab_project(side: int, m: int, iters: int, K: int, **kw):
    cost = c._function(2 * (m + 2 * K) * side + 2 * m * side,
                       c._scaled(c.DIV2, (m + 2 * K - 2) * side),
                       c._slab_sweeps_cost(iters, m + 2 * K, side,
                                           zero_init=True, **kw),
                       c._scaled(c.GRAD2, m * side))
    return cost, 1


def slab_dens(side: int, m: int, K: int):
    cost = c._function(2 * (m + 2 * K) * side + 3 * m * side,
                       c._slab_sweeps_cost(20, m + 2 * K, side, src=True),
                       c._scaled(c.ADVECT2_ONE, m * side))
    return cost, 1


def zslab(iters: int, H: int, **kw):
    return c._slab3_sweeps_cost(iters, 32 + 2 * H, 256, **kw), 1


def dens(iters: int, **kw):
    return c._function(c.DENS_ADVECT[0], c._sweeps_cost(iters - 1, 2,
                                                        src=True, **kw),
                       c.DENS_ADVECT)


def tail(iters: int, cheby: bool = False):
    ops = c._sweeps_cost(iters, 2, zero_init=True, cheby=cheby)[1]
    return (4, c.ADVECT2_PAIR[1] + c.DIV2[1] + ops + c.GRAD2[1])


S = c._sweeps_cost
# (row, call, (cost, cells))
ROWS = [
    ("B1", "20-sweep solve, source fold", (S(20, 2, src=True), C2048)),
    ("B1", "10-sweep Chebyshev+fast", (S(K_D, 2, src=True, fast=True,
                                          cheby=True), C2048)),
    ("B1", "batch: 20-sweep solve", (S(20, 2, src=True), CBATCH)),
    ("B1", "batch: Chebyshev+fast", (S(K_D, 2, src=True, fast=True,
                                         cheby=True), CBATCH)),
    ("B1", "bf16 20-sweep solve", (S(20, 2, src=True, bf16=True), C2048)),
    ("B1", "bf16 Chebyshev+fast", (S(K_D, 2, src=True, fast=True, cheby=True,
                                       bf16=True), C2048)),
    ("B1", "bf16 8192² 20-sweep solve", (S(20, 2, src=True, bf16=True),
                                          C8192)),
    ("B1", "bf16 batch 20-sweep solve", (S(20, 2, src=True, bf16=True),
                                          CBATCH)),
    ("B1", "bf16 batch Chebyshev+fast", (S(K_D, 2, src=True, fast=True,
                                             cheby=True, bf16=True), CBATCH)),
    ("B1", "damped 2-sweep smooth", (S(2, 2, damp=True), C2048)),
    ("B1", "damped 40 sweeps from zero", (S(40, 2, zero_init=True,
                                            damp=True), C2048)),
    ("B2", "fused_project 20 it", (c._project(S(20, 2, zero_init=True)),
                                   C2048)),
    ("B2", "fused_project Chebyshev 14", (c._project(S(K_P, 2, zero_init=True,
                                                       cheby=True)), C2048)),
    ("B2", "batch: fused_project 20 it", (c._project(S(20, 2,
                                                       zero_init=True)),
                                          CBATCH)),
    ("B2", "bf16 fused_project 20 it", (c._project(S(20, 2, zero_init=True),
                                                   bf16=True), C2048)),
    ("B4", "fused_dens_advect 20 it", (dens(20), C2048)),
    ("B4", "fused_dens_advect Chebyshev+fast 10", (dens(K_D, fast=True,
                                                        cheby=True), C2048)),
    ("B4", "batch: fused_dens_advect 20 it", (dens(20), CBATCH)),
    ("B12", "pair, two 256² grids", (c._scaled(S(20, 2, src=True), 2),
                                     256 ** 2)),
    ("B12", "pair, two 2048² grids", (c._scaled(S(20, 2, src=True), 2),
                                      C2048)),
    ("B6", "20-sweep u solve", (S(20, 3, src=True), C256)),
    ("B6", "20-sweep pressure", (S(20, 3, zero_init=True), C256)),
    ("B6c", "10-sweep u solve", (S(K_D3, 3, src=True, fast=True, cheby=True),
                                 C256)),
    ("B6c", "12-sweep pressure", (S(K_P3, 3, zero_init=True, fast=True,
                                    cheby=True), C256)),
    ("B9a", "20-sweep slab solve", slab(2048, 256, 20, 24)),
    ("B9a", "10-sweep Chebyshev+fast", slab(2048, 256, K_D, 16, fast=True,
                                            cheby=True)),
    ("B9a", "8192²: 20-sweep slab solve", slab(8192, 2048, 20, 24)),
    ("B9b", "fused_project_slab 20 it", slab_project(2048, 256, 20, 24)),
    ("B9b", "fused_project_slab Chebyshev 14", slab_project(
        2048, 256, K_P, 24, cheby=True)),
    ("B9b", "8192²: fused_project_slab 20 it", slab_project(8192, 2048, 20,
                                                            24)),
    ("B9c", "fused_dens_slab 20 it", slab_dens(2048, 256, 32)),
    ("B9c", "8192²: fused_dens_slab 20 it", slab_dens(8192, 2048, 32)),
    ("B10a", "20-sweep u segment", zslab(20, 21)),
    ("B10a", "20-sweep pressure", zslab(20, 21, zero_init=True)),
    ("B10b", "10-sweep Chebyshev+fast u", zslab(K_D3, K_D3 + 1, fast=True,
                                                cheby=True)),
    ("B10b", "12-sweep pressure", zslab(K_P3, K_P3 + 1, zero_init=True,
                                        fast=True, cheby=True)),
    ("B11", "K17 20 it", (tail(20), C2048)),
    ("B11", "K17 Chebyshev 14", (tail(K_P, cheby=True), C2048)),
    ("B13", "K18 + K9 20-sweep solve", slab(2048, 256, 20, 24)),
    ("B13", "8192²: K18 + K9 20-sweep solve", slab(8192, 2048, 20, 24)),
]


def main() -> None:
    for row, call, (cost, cells) in ROWS:
        check = c.Check(call, (), None, None, cost, cells)
        bound, bound_by = check.bound()
        print(f"{row:5s} {call:38s} bound {bound:.5f} ms ({bound_by})")


if __name__ == "__main__":
    main()
