"""The CUDA backend: one wrapper per ported TPU kernel, each beside its plain
PyTorch version.

Wrappers keep the names and signatures of ``fluidsimulationcuda_tpu.kernels.
pallas_ops`` minus the TPU-only knobs (``max_fused``, ``self_advect``;
``nb1`` is ``fused_jacobi_pair``'s, not a caller's).  ``fused_jacobi``
takes JAX's ``damp`` (damped Jacobi, the multigrid smoother), the gathers
JAX's ``cmax`` (the gather window in cells; None gathers exactly).  Like
the TPU kernels, each takes one (side, side) grid or a batch of them, (nb,
side, side), and launches its kernels once whatever nb is.
Each checks dtype, shape, contiguity and device.  On CPU tensors it
returns its plain version, built from ``ops/``; on CUDA tensors it
launches the hand-written kernels of ``csrc/`` (built on first use by
``build.py``) or raises.  Nothing falls back.

Every wrapper takes float32.  The five that JAX's bf16 storage mode runs
(``fused_jacobi``, ``fused_project``, ``divergence_p``, ``gradient_p`` and
the gathers ``advect_shift``/``advect_shift_fused``; JAX's ``supports``,
``pallas_ops.py:125-149``) also take bf16 fields, as the TPU kernels do:
they read bf16, compute in float32 and write bf16 (K1's iterate stays
float32 from the first sweep to the last, and only the folded or
prescaled rhs and the solve's output are rounded to bf16; inside
``fused_project`` the divergence and the pressure stay float32).  Each
bf16 form is a template instantiation of its kernel chosen at launch, and
counts apart (``jacobi_sweeps_bf16``, ``divergence_bf16``,
``gradient_bf16``, ``advect_bf16``; the per-sweep K1's
``jacobi_sweep_bf16``).  K3's bf16 form and K2's bf16 gradient run in
V-cell vectors, a thread owning V consecutive cells of a row, the first
of their ``VECTOR_WIDTHS`` that the side and the operands' alignment
allow (``vector_width``; else the one-cell kernel), counted by width too
(``width_counts``).  Its plain version widens the fields
to float32, runs the float32 plain version with the same roundings and
rounds the output to bf16.  K1-damp, the multigrid smoother, also takes
a bf16 rhs (the finest level of a bf16 multigrid solve; JAX smooths that
level in jnp): its bf16-rhs forms (``jacobi_sweeps_damp_bf16``) read the
rhs as bf16 and a float32 guess, or a bf16 guess or none, and write the
guess's dtype (``mg_smooth``).  The 3-D wrappers (``cuda_ops_3d.py``),
the z-slab wrappers (``cuda_sharded_3d.py``) and the block route's have
bf16 forms of their own.  A bf16 tensor reaching any other wrapper
(``fused_dens_advect``, ``fused_jacobi_pair``, the row-slab and tail
kernels) raises ``TypeError``: nothing widens it silently.

Four CUDA kernels (K1-K4) carry the five TPU kernel families of the 2-D
step:

- ``jacobi_sweeps`` (K1, ``csrc/jacobi_tiles.cu``): up to T sweeps of a
  solve per launch in shared-memory tiles (``sweep_plan``,
  ``SWEEPS_PER_LAUNCH``).  It is ``fused_jacobi`` (TPU
  ``pallas_ops.py:645``), ``fused_jacobi_pair`` (``:671``, u and v stacked
  on the batch axis, each with its boundary mode) and the sweep engine of
  ``fused_project`` and ``fused_dens_advect``.  Its damped form
  (``jacobi_sweeps_damp``, K1-damp, the same source) is the multigrid
  smoother (``damp``): a smooth in one launch, on K1's tiles or, on grids
  that one tile holds whole, every sweep of the solve in one launch a
  grid (``damped_plan``); on a bf16 rhs its bf16-rhs forms
  (``jacobi_sweeps_damp_bf16``).  The per-sweep K1 (``jacobi_sweep``,
  ``csrc/jacobi.cu``) computes the same sweeps one launch each, damped
  ones counted as ``jacobi_sweep_damp``; ``launch_sweeps(0)`` runs a
  solve through it, the "before" the tiled kernel is timed and held
  against.
- ``divergence`` and ``gradient`` (K2, ``csrc/project.cu``): with K1 they
  make ``fused_project`` (``:899``); alone they are ``divergence_p``
  (``:1622``) and ``gradient_p`` (``:1645``).
- ``advect`` (K3, ``csrc/advect.cu``): ``advect_shift`` and
  ``advect_shift_fused`` (``:1182``), an exact or windowed gather.
- ``dens_advect`` (K4, ``csrc/dens_advect.cu``): the last sweep and the
  gather of ``fused_dens_advect`` (``:1480``).

The 3-D kernels (K5-K8) have their wrappers in ``cuda_ops_3d.py``, the
row-slab kernels of the multi-device step (K9-K12 with K9-damp, the
slab multigrid's smoother, and B13's split-source first launch of
K9, with K18 before it) theirs in ``cuda_sharded.py``, its z-slab
kernels (K13-K16) theirs in ``cuda_sharded_3d.py``, the fused velocity tail
(K17) its wrapper in ``cuda_step.py``; all share this module's checks,
launch helper and counts.  ``launch_counts()`` reports how often each
kernel was launched since ``reset_launch_counts()``: every successful
launch adds one, nothing else does, so a run can show that it went through
the kernels.  Modes that no earlier path ran count under names of their
own: K1's damped sweeps (``jacobi_sweeps_damp``, and the per-sweep
``jacobi_sweep_damp``) and K6's windowed gather (``advect3_windowed``).
"""
from __future__ import annotations

import contextlib
import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.advect import advect, advect_windowed
from ..ops.boundary import embed_interior
from ..ops.chebyshev import cheby_diffuse, cheby_omegas
from ..ops.diffuse import damped_diffuse, diffuse
from ..ops.multigrid import OMEGA
from ..ops.project import apply_pressure_gradient, divergence, grid_h
from ..ops.source import add_source
from . import build
from .dispatch import OpSet

__all__ = [
    "KERNELS", "launch_counts", "reset_launch_counts", "check_grid",
    "make_opset", "SWEEPS_PER_LAUNCH", "SWEEPS_PER_LAUNCH_3D",
    "WALK_PLANE_CELLS", "tiled3",
    "SLAB_TILINGS", "SLAB_ONE_LAUNCH", "slab_tiling",
    "GROUP_SLABS", "GROUP_TILES", "group_smooth_tiling", "DAMPED_TILES",
    "GROUP_BLOCKS", "BLOCK_GROUP_TILES",
    "LONG_SOLVE_CELLS",
    "WHOLE_GRID_SIDE", "DampedRoute", "damped_plan", "launch_sweeps",
    "smooth_launches", "SweepLaunch", "sweep_plan", "VECTOR_WIDTHS",
    "vector_width", "vector_widths", "width_counts", "reset_width_counts",
    "fused_jacobi", "fused_jacobi_plain", "mg_smooth", "mg_smooth_plain",
    "fused_jacobi_pair",
    "fused_jacobi_pair_plain", "fused_project",
    "fused_project_plain", "advect_shift", "advect_shift_plain",
    "advect_shift_fused", "advect_shift_fused_plain", "fused_dens_advect",
    "fused_dens_advect_plain", "divergence_p", "divergence_p_plain",
    "gradient_p", "gradient_p_plain",
]

KERNELS = ("jacobi_sweep", "divergence", "gradient", "advect", "dens_advect",
           "jacobi3_sweep", "divergence3", "gradient3", "advect3",
           "jacobi_slab", "divergence_slab", "gradient_slab", "advect_slab",
           "jacobi3_slab", "divergence3_slab", "gradient3_slab",
           "advect3_slab", "advect_project", "jacobi_slab_split",
           "jacobi_sweep_damp", "advect3_windowed", "jacobi_sweep_bf16",
           "divergence_bf16", "gradient_bf16", "advect_bf16",
           "jacobi_sweeps", "jacobi_sweeps_bf16", "jacobi3_sweeps",
           "jacobi3_slab_sweeps", "jacobi_slab_sweeps", "jacobi_sweeps_damp",
           "jacobi_slab_sweeps_damp_group",
           "jacobi_slab_sweeps_split", "jacobi_sweeps_damp_bf16",
           "advect_slab_exact",
           "advect3_slab_exact", "jacobi_block_sweeps", "advect_block",
           "advect_block_exact", "divergence_block", "gradient_block",
           "jacobi_block_sweeps_bf16", "advect_block_bf16",
           "advect_block_exact_bf16", "divergence_block_bf16",
           "gradient_block_bf16", "jacobi3_sweep_bf16", "jacobi3_sweeps_bf16",
           "advect3_bf16", "advect3_windowed_bf16", "divergence3_bf16",
           "gradient3_bf16", "jacobi3_slab_bf16", "jacobi3_slab_sweeps_bf16",
           "advect3_slab_bf16", "advect3_slab_exact_bf16",
           "divergence3_slab_bf16", "gradient3_slab_bf16",
           "jacobi_block_group", "jacobi_block_group_bf16", "advect3_group",
           "advect3_group_exact", "advect3_group_bf16",
           "advect3_group_exact_bf16", "gradient_block_group",
           "gradient_block_group_bf16", "advect_block_group",
           "advect_block_group_exact", "advect_block_group_bf16",
           "advect_block_group_exact_bf16")
_launches = dict.fromkeys(KERNELS, 0)

# Sweep flags of csrc/fsc_common.cuh (fsc::SweepFlags).
_PREP, _FAST, _CHEBY, _DAMP = 1, 2, 4, 8
# Grids of one 2-D launch: CUDA's limit on the launch's third axis.
_MAX_BATCH = 65535
# The storage dtypes of the wrappers that have a bf16 form.
_F32_BF16 = (torch.float32, torch.bfloat16)
# fsc_jacobi(3)_sweep(s)_bf16's operand types (csrc/jacobi.cu,
# csrc/jacobi_tiles.cu, csrc/jacobi3.cu, csrc/jacobi3_tiles.cu): which of
# x, xm and out are bf16 (rhs and rhs_out always are).
_X_BF16, _XM_BF16, _OUT_BF16 = 1, 2, 4
# T, the sweeps of one tiled K1 launch, chosen by measurement
# (dev/bench_sweeps.py, PERF.md): the fastest or within 5% of it at 2048²,
# 8192² and 1024 x 256², in float32 and bf16, for each solve of the step.
SWEEPS_PER_LAUNCH = 10
# T3, the sweeps of one launch of the tiled 3-D Jacobi (csrc/jacobi3_tiles.cu,
# on a volume and on z-slabs), chosen by measurement (dev/bench_sweeps3.py,
# PERF.md): the fastest of 4, 5 and 6 for each fast Chebyshev solve at 256^3
# and on a 32-plane z-slab, the solves that take the kernel (tiled3); the
# library takes at most 6.
SWEEPS_PER_LAUNCH_3D = 6
# The cells of a plane from which the fast Chebyshev solves of K5 and K13
# take the per-sweep kernels' vector walk instead of the tiled 3-D kernel
# (tiled3): 256², the side the walk was measured to win at, in float32 and
# bf16, on a volume and on z-slab buffers (dev/bench_sweeps3.py, PERF.md).
WALK_PLANE_CELLS = 256 * 256
# The tilings of the tiled K9 on a row-slab buffer (csrc/jacobi_tiles.cu,
# fsc_jacobi_slab_sweeps), chosen by measurement (dev/bench_slab_sweeps.py,
# PERF.md): (fewest buffer cells, T, tile rows), the first whose cells a
# buffer reaches (slab_tiling); the library takes tiles of 64 or 32 rows.
SLAB_TILINGS = ((2_000_000, 8, 64), (0, 5, 32))
# A row-slab solve of at most this many sweeps runs in one launch.
SLAB_ONE_LAUNCH = 8
# K1-damp's tiles (csrc/jacobi_tiles.cu, fsc_jacobi_sweeps_damp), chosen
# by measurement (dev/bench_smooth.py, PERF.md): (fewest cells of a launch,
# tile rows), the first whose cells a launch reaches; and the largest
# padded side whose damped solves run all their sweeps in one whole-grid
# launch, in the 32-row tile (damped_plan).  The library takes tiles of
# 16 and 64 rows, whole grids in the 32-row one.
DAMPED_TILES = ((2_000_000, 64), (0, 16))
WHOLE_GRID_SIDE = 30
# K9-damp (fsc_jacobi_slab_sweeps_damp_group) takes every slab of a
# device in one launch, at most GROUP_SLABS (the library's kGroupSlabs) a
# launch, its tile by the launch's cells (group_smooth_tiling): (fewest
# cells of a launch, tile rows), chosen by measurement on the H100
# (dev/bench_slab_smooth.py, PERF.md): the 2-sweep smooth over 2048² took
# 0.0353 ms on 32-row tiles against 0.0359 on 64 and 0.0442 on 16 (8
# slabs), 0.0343 against 0.0354 and 0.0430 (one slab), 0.0495 against
# 0.0748 and 0.0585 (128 slabs of 16 rows); over 8192² on 4 slabs 0.396
# on 64 rows against 0.451 on 32.
GROUP_SLABS = 128
GROUP_TILES = ((16_000_000, 64), (0, 32))
# The grouped K9-block (fsc_jacobi_block_group) takes every block of a
# device in one launch, at most GROUP_BLOCKS (the library's kGroupBlocks)
# a launch, its tile rows by the launch's block cells
# (cuda_sharded.block_group_tile): (fewest cells of a launch, tile rows),
# the first whose cells a launch reaches, in tiles of 128 columns.  Chosen
# by measurement on the H100 (dev/bench_block_group.py --chunks, PERF.md
# §6) on a step's own velocity after 300 steps: the 8-sweep float32 Jacobi
# chunk over the (2, 4) blocks of 2048² took 0.0934 ms on 64-row tiles
# against 0.1311 on 32; over 8192² on (2, 2) 1.0985 against 1.7650; over
# the (64, 1) blocks of 512² (8-row slabs) 0.0234 on 32 rows against 0.0398
# on 64.  Tiles of 128 rows and of 256 columns (one block an SM, spills in
# the Chebyshev forms) were slower on fields zero outside a disc (0.1255,
# 0.1563 and 0.1526 ms against 0.0962 on 64 x 128) and are not built.
GROUP_BLOCKS = 64
BLOCK_GROUP_TILES = ((2_000_000, 64), (0, 32))
# A damped solve of more sweeps than one launch on its tile takes (the
# slab multigrid's 40-sweep coarse solve) takes 64-row tiles from this many
# cells a launch (damped_plan): at 1025² the 40 sweeps took 0.149 ms at
# T = 10 on 64 rows against 0.198 at T = 5 on 16 and 0.223 on the per-sweep
# damped K1 (dev/bench_slab_smooth.py --odd, PERF.md).
LONG_SOLVE_CELLS = 1_000_000
# The cells a thread of the vector kernels (K3's and K2's gradient's bf16
# forms, advect_vec_kernel and gradient_vec_kernel; the per-sweep K5's
# and K13's jacobi3_sweep_vec_kernel and jacobi3_slab_vec_kernel, float32
# and bf16) may take, by kernel, largest first (vector_width); 1 is the
# one-cell kernel.  K3's and K2's were chosen by measurement on the H100
# (dev/bench_bf16_stencils.py, PERF.md §6): K3 at V = 4 took
# 18-22% less time than at V = 8 on the step's velocities and stayed
# within 5.3% of it on smooth and shear ones, so its V = 8 form is not
# built (V = 2 was the fastest only on random velocities over the
# window); the gradient took V = 8 and 4 within 7% of each other, V = 8
# the faster on a bf16 pressure.
# The per-sweep K5 and K13 (csrc/jacobi3_walk.cuh) take V = 4, each
# thread walking SWEEP3_WALK planes in z, chosen with it by measurement on
# the H100 in bf16 (dev/bench_sweep3_bf16.py, PERF.md §6): at V = 4 and a
# walk of 3 the 20-sweep u solve at 256³ took 1.371 ms (float32 one-cell
# 1.797), the z-slab segment 0.301 (0.397), the bf16 parity steps 10.15
# and, on 8 z-slabs, 19.84 ms as graphs (float32 11.80, 22.22); walks of 2
# and 4 within 3% of it, walks of 1 and 6 3.5-14% slower; V = 8 at its
# best walk 3-6% slower, V = 2 slower still.  The float32 forms take the
# same width and walk (dev/bench_sweep3.py, PERF.md §6): a middle sweep
# at 256³ took 0.0726 ms at walks 2-4 within 1% (one-cell 0.0881), the
# 20-sweep u solve 1.477 (1.790), the 256³ parity step 9.96 and, on 8
# z-slabs, 18.88 ms as graphs (11.76, 22.36).  The grouped K11-block
# and K12-block (csrc/block_group.cuh) take the widths measured fastest
# over the (2, 4) blocks of 2048² (dev/bench_block_stencils.py, PERF.md
# §6): the gradient V = 2 in float32 and 8 in bf16, the gathers V = 4 but
# the float32 exact one's V = 2; the narrower ones where a width does not
# divide the blocks' side.
VECTOR_WIDTHS = {"advect_bf16": (4, 2), "gradient_bf16": (8, 4, 2),
                 "jacobi3_sweep": (4,), "jacobi3_slab": (4,),
                 "jacobi3_sweep_bf16": (4,), "jacobi3_slab_bf16": (4,),
                 "gradient_block_group": (2,),
                 "gradient_block_group_bf16": (8, 4, 2),
                 "advect_block_group": (4, 2),
                 "advect_block_group_exact": (2,),
                 "advect_block_group_bf16": (4, 2),
                 "advect_block_group_exact_bf16": (4, 2)}
SWEEP3_WALK = 3
# Launches of each vector kernel by its width since reset_width_counts().
_width_launches = {name: dict.fromkeys(widths + (1,), 0)
                   for name, widths in VECTOR_WIDTHS.items()}
# Set by vector_widths(): the widths every vector kernel may take, in place
# of VECTOR_WIDTHS.
_forced_widths: tuple[int, ...] | None = None
# Set by launch_sweeps(): the sweeps of a tiled launch, 0 for the per-sweep
# kernels; and the rows of a tiled K9's tile.  Set by smooth_launches():
# the route of every damped solve (a DampedRoute, its per_launch ignored
# for a whole grid).
_forced: int | None = None
_forced_tile: int | None = None
_forced_damp: "DampedRoute | None" = None


def tiled3(cheby: bool, fast: bool, planes: int | None = None,
           side: int | None = None) -> bool:
    """Whether a 3-D solve (``planes`` None) or a segment on a z-slab
    buffer of ``planes`` planes, of ``side``, takes the tiled 3-D Jacobi
    (T3 sweeps a launch) or the per-sweep K5 or K13 (one launch a sweep).

    The tiled kernel has one mode, a Chebyshev solve in fast mode, the
    one in which it beat the per-sweep one-cell chain on the H100
    (PERF.md §6: 1.10-1.19x; 0.83-0.99x in the three others, which it
    does not build).  The per-sweep kernels' vector walk beats it in that
    mode too, in float32 and in bf16 (PERF.md §6, ``dev/bench_sweeps3.py
    --dtypes float32,bfloat16``; the walk [the tiled kernel]: at 256³ the
    10-sweep u solve 0.909 ms [0.998] in float32 and 0.853 [1.098] in bf16,
    the 12-sweep pressure 1.051 [1.119] and 0.999 [1.213]; on a 32-plane
    slab's 54-plane buffer 0.154 [0.198] and 0.136 [0.210]), so from
    ``WALK_PLANE_CELLS`` cells a plane, where the walk takes its width (4
    divides the side), no solve takes the tiled kernel; below, where
    nothing was measured, the tiled kernel keeps them.  On a z-slab a
    launch of T3 sweeps writes ``planes - 2*T3`` planes and each block
    walks 3*T3 more of warm-up and drain (``plan_chunk`` in
    ``csrc/jacobi3_tiles.cu``);
    below 5*T3 planes the walk repeats more planes than the launch writes,
    while the per-sweep K13's fields of such a buffer stay in the L2, and
    the per-sweep K13 takes the segment (PERF.md §6: 24-plane buffers of
    8-plane slabs).  ``launch_sweeps`` overrides the geometry, not the
    mode."""
    if not (cheby and fast):
        return False
    if (side is not None and side * side >= WALK_PLANE_CELLS
            and side % VECTOR_WIDTHS["jacobi3_sweep"][0] == 0):
        return False
    return planes is None or planes >= 5 * SWEEPS_PER_LAUNCH_3D


def slab_tiling(rows: int, side: int, sweeps: int) -> tuple[int, int]:
    """(T, tile rows) of the tiled K9 for ``sweeps`` sweeps of a solve on
    a (rows, side) row-slab buffer: the first of ``SLAB_TILINGS`` whose
    cell count the buffer reaches, and T raised to ``sweeps`` where at most
    ``SLAB_ONE_LAUNCH`` remain.  By the H100 measurement (PERF.md §6,
    ``dev/bench_slab_sweeps.py``): a buffer of a few slab rows (304 x
    2048, 0.62 M cells) is one wave of 128 x 64 tiles, one block an SM,
    and 128 x 32 tiles at T = 5 spread it over twice the blocks (1.68x the
    per-sweep K9 against 1.33x); from 2096 x 2048 (4.3 M cells) up the
    taller tile at T = 8 repeats fewer halo rows (2.43x, and 3.33x on
    2096 x 8192, against 2.27x and 2.70x).  A launch costs a load, a store
    and a partial wave whatever its sweeps, so the 8-sweep chunks of thin
    buffers (48 x 2048) run in one launch (1.34x against 1.04x at T = 5).
    ``launch_sweeps`` overrides either."""
    cells = rows * side
    per, tile = next((per, tile) for least, per, tile in SLAB_TILINGS
                     if cells >= least)
    return (max(per, sweeps) if sweeps <= SLAB_ONE_LAUNCH else per), tile


def group_smooth_tiling(cells: int, m: int,
                        sweeps: int) -> tuple[int, int]:
    """(T, tile rows) of the grouped K9-damp for a smooth of ``sweeps``
    sweeps over slabs of ``m`` rows, ``cells`` cells in all in the launch:
    the first of ``GROUP_TILES`` whose cell count the launch reaches, and
    T = ``sweeps`` up to the most the tile's halo allows (``(tile - 3) //
    2``, at most 20) and the slab's rows (a launch reads ``T`` halo rows of
    each neighbouring slab).  ``launch_sweeps(t, tile_rows=h)`` forces T =
    t, capped so (0: one sweep a launch), and the tile (64, 32 or 16)."""
    tile = next(tile for least, tile in GROUP_TILES if cells >= least)
    if _forced_tile is not None:
        tile = _forced_tile
    per_launch = sweeps if _forced is None else max(_forced, 1)
    return min(per_launch, (tile - 3) // 2, 20, m), tile


class DampedRoute(NamedTuple):
    """How a damped solve runs (``damped_plan``)."""

    per_launch: int  # sweeps a launch; 0: a per-sweep damped K1 launch each
    tile_rows: int  # rows of K1-damp's tile: 16 or 64, 32 for a whole grid
    whole: bool  # each grid whole in one block's tile, all sweeps a launch


def damped_plan(side: int, sweeps: int, grids: int = 1) -> DampedRoute:
    """The route of a damped solve (the multigrid smoother, K1-damp) of
    ``sweeps`` sweeps on ``grids`` grids of padded ``side``: every sweep
    in one whole-grid launch, each grid in one block of the 32-row tile,
    up to side ``WHOLE_GRID_SIDE``; above, the tile of ``DAMPED_TILES`` by
    the launch's cells, ``SWEEPS_PER_LAUNCH`` sweeps a launch or the most
    its halo allows, so a smooth of 2 or 4 sweeps is one launch.  By the
    H100 measurement (PERF.md §6, ``dev/bench_smooth.py``; device time
    and the eager call's, host included, as the step calls it): 2048² and
    64 × 256² take 128 x 64 tiles (1.1-1.9x the per-sweep pair on the
    device), 1024² and below 128 x 16 ones (1.1-1.3x at 1024² and 512²;
    from 256² to 32², and on 64 × 128² to 64 × 32², the pair's device
    time is 2-30% less, while the eager call, one launch against two, is
    1.03-1.85x faster), the coarsest 16² its 40 sweeps in one whole-grid
    launch (2.2-2.6x; the 128 x 64 tile 1.8x).  A solve of more sweeps
    than a launch on its tile takes takes the 64-row tile from
    ``LONG_SOLVE_CELLS`` cells a launch (the slab multigrid's 40-sweep
    coarse solve at 1025²: 0.149 ms against 0.198 on 16 rows).  On an odd
    side T falls until the output tile leaves no last tile of the grid's
    last ghost line alone (``_deeper_halo``; at 1025² on 16 rows T = 6
    took 0.444 ms, T = 5 0.198).  ``smooth_launches``
    overrides it, ``launch_sweeps`` forces tiled launches of its count on
    64-row tiles (0: the per-sweep chain)."""
    if _forced_damp is not None:
        route = _forced_damp
        return route._replace(per_launch=sweeps) if route.whole else route
    if _forced is not None:
        return DampedRoute(_forced, 64, False)
    if side <= WHOLE_GRID_SIDE:
        return DampedRoute(sweeps, 32, True)
    cells = grids * side * side
    rows = next(rows for least, rows in DAMPED_TILES if cells >= least)
    # A launch of T sweeps takes a halo of T + 1 rows at most.
    if sweeps > (rows - 3) // 2 and cells >= LONG_SOLVE_CELLS:
        rows = DAMPED_TILES[0][1]
    per_launch = min(SWEEPS_PER_LAUNCH, (rows - 3) // 2)
    # On an odd side, a T whose output tile leaves a last tile of the
    # grid's last ghost line alone takes that deeper halo (plan_tiling in
    # csrc/jacobi_tiles.cu): the next smaller T that does not.
    while per_launch > 1 and _deeper_halo(side, per_launch, rows):
        per_launch -= 1
    return DampedRoute(per_launch, rows, False)


def _deeper_halo(side: int, per_launch: int, tile_rows: int) -> bool:
    """Whether a K1 launch of ``per_launch`` sweeps on grids of ``side``
    in tiles of ``tile_rows`` x 128 takes a halo one cell deeper: its
    output tile's height or width leaves the last tile of a row or
    column of tiles only the grid's last ghost line (``plan_tiling``).
    Output tiles are even, so only an odd side can."""
    return any(side % (extent - 2 * per_launch) == 1
               for extent in (tile_rows, 128))


def vector_width(kernel: str, side: int, *tensors: torch.Tensor) -> int:
    """The cells a thread of ``kernel``'s vector kernel takes on grids
    of ``side`` with these operands: the largest of its ``VECTOR_WIDTHS``
    that divides ``side`` and to whose access (that many values of a
    tensor's dtype, at most 16 bytes) every tensor's data is aligned, so
    that every row of every grid starts on such an access; else 1, the
    one-cell kernel.  A view with a storage offset may be misaligned."""
    widths = VECTOR_WIDTHS[kernel] if _forced_widths is None else _forced_widths
    for width in widths:
        if side % width == 0 and all(
                t.data_ptr() % min(width * t.element_size(), 16) == 0
                for t in tensors):
            return width
    return 1


@contextlib.contextmanager
def vector_widths(widths: tuple[int, ...]):
    """Let every vector kernel take only ``widths``, the
    first that the operands allow (``(1,)`` or ``()``: the one-cell
    kernel), whatever ``VECTOR_WIDTHS`` says: the forms
    (``checks.BF16_FORMS``) the tests hold and
    ``dev/bench_bf16_stencils.py`` times.  A width outside the kernel's
    ``VECTOR_WIDTHS`` is refused by the library, and its launch raises."""
    global _forced_widths
    saved, _forced_widths = _forced_widths, tuple(widths)
    try:
        yield
    finally:
        _forced_widths = saved


def width_counts() -> dict[str, dict[int, int]]:
    """Launches of each vector kernel (``VECTOR_WIDTHS``' kernels) by the
    cells a thread took (one of its widths or 1) since the last
    ``reset_width_counts``."""
    return {name: dict(counts) for name, counts in _width_launches.items()}


def reset_width_counts() -> None:
    for counts in _width_launches.values():
        for width in counts:
            counts[width] = 0


def _launch_vector(kernel: str, width: int, fn, *args) -> None:
    """``_launch`` of a vector kernel, counted by its width too."""
    _launch(kernel, fn, *args)
    _width_launches[kernel][width] += 1


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


# ---------------------------------------------------------------------------
# Checks and launches
# ---------------------------------------------------------------------------


def check_grid(shape: tuple[int, ...], ndim: int = 2) -> None:
    """Raise ``ValueError`` unless the kernels take a grid of ``shape``,
    ``(side,) * ndim`` or, in 2-D, a batch ``(nb, side, side)``.  The
    kernels index a batch with 32-bit ints and launch a batch's grids on
    the launch's third axis, so the cells of a call stay below 2**31 and nb
    at most 65535.  It needs no tensor: the CLI asks it of a configuration
    before anything is allocated."""
    shape = tuple(shape)
    if shape[-1] < 3 or math.prod(shape) >= 2**31:
        raise ValueError(f"unsupported grid shape {shape} for {ndim}-D")
    if len(shape) > ndim and not 1 <= shape[0] <= _MAX_BATCH:
        raise ValueError(f"a batch holds 1 to {_MAX_BATCH} grids, got "
                         f"{shape[0]}")


def _on_card(side: int, *tensors: torch.Tensor, ndim: int = 2,
             dtypes: tuple[torch.dtype, ...] = (torch.float32,)) -> bool:
    """Check that every tensor is a contiguous grid of shape ``(side,) *
    ndim`` or, in 2-D, that all are batches of the same shape ``(nb, side,
    side)`` (``check_grid``), of one dtype of ``dtypes``, on one device;
    True for CUDA, False for the CPU, and raise otherwise."""
    shape = (side,) * ndim
    if ndim == 2 and tensors[0].dim() == 3:
        shape = (tensors[0].shape[0],) + shape
    check_grid(shape, ndim)
    if len({t.dtype for t in tensors}) > 1:
        raise TypeError(
            f"mixed dtypes {sorted(str(t.dtype) for t in tensors)}")
    return _on_device(*((t, shape, dtypes) for t in tensors))


def _batch(t: torch.Tensor) -> int:
    """Grids in a checked 2-D operand: nb of (nb, side, side), else 1."""
    return t.shape[0] if t.dim() == 3 else 1


def _on_device(*specs: tuple) -> bool:
    """Check that each tensor of a spec ``(tensor, shape)`` or ``(tensor,
    shape, dtypes)`` is a contiguous array of its shape and of a dtype of
    ``dtypes`` (float32 if not given: a kernel without a bf16 form), all on
    one device; True for CUDA, False for the CPU, and raise otherwise."""
    for t, shape, *allowed in specs:
        dtypes = allowed[0] if allowed else (torch.float32,)
        if t.dtype not in dtypes:
            raise TypeError(f"expected {' or '.join(map(str, dtypes))}, got "
                            f"{t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("expected a contiguous tensor")
    devices = {spec[0].device for spec in specs}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type == "cuda"


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _f32(x: float) -> float:
    """``x`` rounded to float32, as ``jnp.asarray(x, float32)`` rounds it."""
    return float(np.float32(x))


def _round(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (float32 or bf16) as a 0-dim tensor of
    it rounds (``ops.diffuse.damped_diffuse``'s w and 1-w)."""
    return float(torch.full((), x, dtype=dtype))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(kernel: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError_t {err}")
    _launches[kernel] += 1


@contextlib.contextmanager
def launch_sweeps(per_launch: int, tile_rows: int | None = None):
    """Within the block every K1 solve, every row-slab solve, and every
    3-D Chebyshev solve or z-slab segment in fast mode (the tiled 3-D
    kernel's one mode; ``tiled3``), on the card takes ``per_launch`` sweeps
    a launch of the tiled kernel (the library refuses a launch of more
    than its kMaxSweeps: 20 for K1 and K9, 6 for the 3-D kernel), or with
    0 launches the per-sweep kernel (K1, K5, K9 or K13) for each sweep:
    the chains the checks hold the tiled kernels against and
    ``dev/bench_sweeps.py``, ``dev/bench_sweeps3.py`` and
    ``dev/bench_slab_sweeps.py`` time.  A damped K1 solve takes tiled
    launches of ``per_launch`` sweeps too, never a whole-grid one (0: the
    per-sweep damped K1).  ``tile_rows`` (64 or 32) sets the tiled K9's
    tile (B13's split-source first launch included; with 0, B13 runs
    K18's one sweep, then the per-sweep K9).  K9-damp, which has no
    per-sweep kernel, takes ``per_launch`` sweeps a launch (0: one) on
    tiles of ``tile_rows`` (64, 32 or 16; ``group_smooth_tiling``).  The
    grouped K9-block takes tiles of ``tile_rows`` (64 or 32;
    ``cuda_sharded.block_group_tile``; the library refuses others).  No
    path of the port enters it."""
    global _forced, _forced_tile
    if per_launch < 0:
        raise ValueError(f"per_launch {per_launch} < 0")
    saved = _forced, _forced_tile
    _forced, _forced_tile = per_launch, tile_rows
    try:
        yield
    finally:
        _forced, _forced_tile = saved


@contextlib.contextmanager
def smooth_launches(per_launch: int = SWEEPS_PER_LAUNCH, tile_rows: int = 64,
                    whole: bool = False):
    """Within the block every damped K1 solve (the multigrid smoother) on
    the card takes ``per_launch`` sweeps a launch on K1-damp's tiles of
    ``tile_rows`` rows (16 or 64; at most the halo allows; 0: one
    launch of the per-sweep damped K1 a sweep, the smoother before
    K1-damp) or, ``whole``, all its sweeps in one launch, each grid whole
    in a tile of ``tile_rows`` rows (32; the library refuses a grid of a
    larger side than 30).  It overrides ``damped_plan`` and
    ``launch_sweeps`` for damped solves only; for tests, ``chip_smoke.py``
    and ``dev/bench_smooth.py``.  No path of the port enters it."""
    global _forced_damp
    if per_launch < 0 or tile_rows not in (16, 32, 64):
        raise ValueError(f"per_launch {per_launch} < 0 or tile_rows "
                         f"{tile_rows} not 16, 32 or 64")
    saved = _forced_damp
    _forced_damp = DampedRoute(per_launch, tile_rows, whole)
    try:
        yield
    finally:
        _forced_damp = saved


class SweepLaunch(NamedTuple):
    """One tiled launch of a solve (``sweep_plan``): K1, or the 3-D
    kernel on a volume or a z-slab."""

    first: int  # the solve's index of its first sweep
    count: int  # its sweeps; sweep k combines with cheby_omegas[k-1], k >= 1
    reads_guess: bool  # reads the caller's guess as x_k (bf16 in bf16 storage)
    reads_guess_as_xm: bool  # reads it as x_{k-1}, after a 1-sweep launch
    stores_rhs: bool  # writes the rhs it builds, for the launches after it
    stores_xm: bool  # writes x_{k-1} beside x_k, for what follows
    ends_solve: bool  # writes the solve's result (bf16 in bf16 storage)


def sweep_plan(start: int, stop: int, end: int, per_launch: int, *,
               prep: bool, cheby: bool, guess: bool = True,
               carry_out: bool = False) -> list[SweepLaunch]:
    """The tiled launches that run sweeps [start, stop) of a solve whose
    sweeps end at ``end`` (K4 runs the last where ``stop`` < ``end``):
    ``per_launch`` sweeps each, the remainder last.  ``prep``: the first
    launch builds the rhs (a folded source or fast mode); ``cheby``: a
    Chebyshev solve; ``guess``: the first launch reads a guess, not the
    zero guess; ``carry_out``: the chain goes on after ``end`` (a z-slab
    segment that hands x_{k-1} to the next).  What follows a launch reads
    the rhs it built and, in a Chebyshev chain, its x_{k-1}; a 1-sweep
    launch's x_{k-1} is its input, so it stores none."""
    plan, k = [], start
    while k < stop:
        count = min(per_launch, stop - k)
        follows = k + count < end
        plan.append(SweepLaunch(
            first=k, count=count, reads_guess=guess and k == start,
            reads_guess_as_xm=cheby and guess and k == start + 1,
            stores_rhs=prep and k == start and follows,
            stores_xm=cheby and count >= 2 and (follows or carry_out),
            ends_solve=k + count == end))
        k += count
    return plan


class _Sweeps:
    """The sweep launches of one solve (K1 on a grid or a batch of grids,
    K5 on a volume, K13 on a z-slab, K9 on a row slab): ``sweep()``
    advances one iterate by a launch of the per-sweep kernel, ``run()`` a
    K1 solve, ``run3()`` a 3-D solve or z-slab segment, ``run_slab()`` a
    row-slab solve and ``run_slab_split()`` one on split operands (B13) by
    the launches of ``sweep_plan`` (the tiled K1, the tiled 3-D kernel or
    the tiled K9, ``launch()``).

    It owns the scratch it ping-pongs through (two tensors, three for
    Chebyshev, whose x_{k-1} and x_k are read-only while x_{k+1} is
    written, so no ghost thread races a neighbour's update).  A solve with
    a source or in fast mode builds its rhs in the first sweep, which stores
    it for every later sweep: the fold reaches every sweep, not only the
    first launch (the trap of ``pallas_ops.py:550-559``).  The Chebyshev
    weights come from ``cheby_omegas`` on the host, one per launch; the
    first sweep of a solve is plain.  ``damp`` makes every sweep damped
    Jacobi (K1 only; ``omw``, 1-w rounded once from float64, goes to the
    launch beside the geometry): ``run()`` takes the launches of
    ``damped_plan`` (K1-damp, counted as ``jacobi_sweeps_damp``, or one
    per-sweep launch a sweep, ``jacobi_sweep_damp``).  A damped solve on a
    bf16 rhs takes K1-damp's bf16-rhs forms (``jacobi_sweeps_damp_bf16``):
    from zero or a bf16 guess, w and 1-w rounded to bf16 in every launch
    and the solve's last output bf16 (the iterate float32 in between);
    from a float32 guess, float32 w and output.  The
    per-sweep damped K1 has no bf16 form: inside ``smooth_launches(0)`` or
    ``launch_sweeps(0)`` such a solve raises ``TypeError``.

    A Chebyshev chain may run in segments (the z-slab step exchanges halos
    between them): ``start`` is the segment's first global sweep, whose ω
    is ``cheby_omegas[start-1]``, ``xm`` the x_{k-1} carried in, and after
    the segment ``x`` and ``xm`` are both final iterates, to carry out
    (the trap of ``pallas_ops.py:560-585``: a chain that restarts ω or
    drops x_{k-1} at a segment boundary looks plausible and is wrong).

    A bf16 rhs (K1, K5 on a volume and K13 on a z-slab) makes the solve
    JAX's bf16 storage form: it launches ``fsc_jacobi_sweeps_bf16``
    (``fsc_jacobi_sweep_bf16`` a sweep on the per-sweep K1; counted as
    ``jacobi_sweeps_bf16`` and ``jacobi_sweep_bf16``; K5's
    ``jacobi3_sweeps_bf16`` and ``jacobi3_sweep_bf16``, K13's
    ``jacobi3_slab_sweeps_bf16`` and ``jacobi3_slab_bf16``), the iterate
    lives in float32 (shared memory
    within a launch, scratch between launches) from the first sweep to the
    last, the guess and x_{k-1} are read as bf16 where they are bf16 (the
    caller's), the folded or prescaled rhs is rounded to bf16 before any
    sweep reads it (``pallas_ops.py:416-428``, ``rdt``), and only the last
    sweep (the ``iters``-th of this call) writes bf16.  A z-slab segment
    that does not end its solve (``final=False``) writes float32 there
    too: the next segment reads it, so the solve still rounds once.
    ``prescaled``: the rhs is already times 1/beta (a bf16 rhs in fast
    mode, built and rounded once by the caller), so no sweep scales it
    again.

    A tiled launch (``launch()``) leaves the state as the per-sweep
    launches of its sweeps leave it: x, x_{k-1} (written by the launch where
    a Chebyshev chain goes on), the stored rhs, k and prep, so K4 takes
    the last sweep of a density solve from either (``next_args()``)."""

    # The tiled kernel of each per-sweep kernel.
    TILED = {"jacobi_sweep": "jacobi_sweeps", "jacobi3_sweep": "jacobi3_sweeps",
             "jacobi3_slab": "jacobi3_slab_sweeps",
             "jacobi_slab": "jacobi_slab_sweeps"}

    def __init__(self, b, x_init, rhs, alpha, beta, iters, *, zero_init,
                 src_dt, fast, cheby_rho, kernel="jacobi_sweep", start=0,
                 xm=None, damp=None, final=True, prescaled=False):
        self.kernel = kernel
        self.bf16 = rhs.dtype == torch.bfloat16
        self.final = final
        self.count = (f"{kernel}_damp" if damp is not None
                      else f"{kernel}_bf16" if self.bf16 else kernel)
        self.symbol = f"fsc_{self.count if self.bf16 else kernel}"
        # A damped solve on a bf16 rhs from zero or a bf16 guess takes w
        # and 1-w in bf16, the guess's dtype, as JAX's _smooth takes them,
        # and ends in bf16.
        self.damp_bf16 = damp is not None and self.bf16 and (
            zero_init or x_init.dtype == torch.bfloat16)
        wdt = torch.bfloat16 if self.damp_bf16 else torch.float32
        self.damp = None if damp is None else _round(damp, wdt)
        self.omw = 0.0 if damp is None else _round(1.0 - damp, wdt)
        self.b = b
        self.side = rhs.shape[-1]
        self.stream = _stream(rhs)
        self.x = None if zero_init else x_init  # None: the zero guess
        self.xm = xm  # None: zero (the chain's x_{-1} is never read)
        self.rhs = rhs
        self.src = x_init if (src_dt is not None and not zero_init) else None
        self.prep = src_dt is not None or (fast and not prescaled)
        self.fast = fast
        self.omegas = (None if cheby_rho is None
                       else cheby_omegas(float(cheby_rho), start + iters))
        self.k = start
        self.end = start + iters
        self.coefs = (_f32(alpha), _f32(beta), _f32(alpha / beta),
                      _f32(1.0 / beta), _f32(0.0 if src_dt is None else src_dt))
        self._pool: list[torch.Tensor] = []

    def next_args(self) -> tuple:
        """Pointer and scalar arguments (x, rhs, src, xm, alpha, beta, ab,
        inv_b, src_dt, w, flags) of the next sweep."""
        cheby = self.omegas is not None and self.k >= 1
        damp = self.damp is not None
        flags = ((_PREP if self.prep else 0) | (_FAST if self.fast else 0)
                 | (_CHEBY if cheby else 0) | (_DAMP if damp else 0))
        w = (_f32(self.omegas[self.k - 1]) if cheby
             else self.damp if damp else 0.0)
        return (_ptr(self.x), self.rhs.data_ptr(),
                _ptr(self.src if self.prep else None),
                _ptr(self.xm if cheby else None), *self.coefs, w, flags)

    def _scratch(self, *busy: torch.Tensor) -> torch.Tensor:
        """A float32 scratch tensor that is none of x, x_{k-1} and ``busy``."""
        taken = (self.x, self.xm, *busy)
        for t in self._pool:
            if all(t is not b for b in taken):
                return t
        t = torch.empty_like(self.rhs, dtype=torch.float32)
        self._pool.append(t)
        return t

    def _types(self, out: torch.Tensor) -> int:
        """fsc_jacobi_sweep_bf16's operand types of the next per-sweep
        launch."""
        def bf16(t):
            return t is not None and t.dtype == torch.bfloat16
        cheby = self.omegas is not None and self.k >= 1
        return ((_X_BF16 if bf16(self.x) else 0)
                | (_XM_BF16 if cheby and bf16(self.xm) else 0)
                | (_OUT_BF16 if bf16(out) else 0))

    def ran_first_sweep(self, x: torch.Tensor) -> None:
        """Take x_1 from a first sweep another kernel ran (K18, which also
        stored the rhs it built in ``self.rhs``)."""
        self.x, self.prep, self.k = x, False, self.k + 1

    def sweep(self, lib, *geometry: int) -> None:
        """One launch; ``geometry`` goes between the sweep scalars and the
        stream (K1's batch and boundary split and ``omw``, the slab
        kernel's row range and wall rows).  K5 and K13 take the width
        ``vector_width`` gives their operands and walk ``SWEEP3_WALK``
        planes a thread."""
        last = self.bf16 and self.final and self.k + 1 == self.end
        out = torch.empty_like(self.rhs) if last else self._scratch()
        rhs_out = torch.empty_like(self.rhs) if self.prep else None
        x, rhs, src, xm, *scalars = self.next_args()
        args = (getattr(lib, self.symbol), x, rhs, src, xm, out.data_ptr(),
                _ptr(rhs_out), self.side, self.b, *scalars, *geometry)
        types = (self._types(out),) if self.bf16 else ()
        if self.count in VECTOR_WIDTHS:
            cheby = self.omegas is not None and self.k >= 1
            operands = (self.x, self.rhs, self.src if self.prep else None,
                        self.xm if cheby else None, out, rhs_out)
            width = vector_width(self.count, self.side,
                                 *(t for t in operands if t is not None))
            _launch_vector(self.count, width, *args, *types, width,
                           SWEEP3_WALK, self.stream)
        else:
            _launch(self.count, *args, *types, self.stream)
        if self.prep:
            self.rhs, self.prep = rhs_out, False
        if self.omegas is not None:
            self.xm = self.x
        self.x = out
        self.k += 1

    def run(self, lib, sweeps: int, nb: int, nb1: int, b1: int) -> None:
        """The next ``sweeps`` sweeps of a K1 solve on ``nb`` grids (grids
        [0, nb1) in boundary mode b, the rest b1): the tiled K1's launches
        of ``sweep_plan``, T = ``SWEEPS_PER_LAUNCH`` sweeps each, or for
        the damped smoother K1-damp's of ``damped_plan``; one per-sweep
        launch a sweep inside ``launch_sweeps(0)``."""
        route = (damped_plan(self.side, sweeps, nb) if self.damp is not None
                 else None)
        per_launch = (route.per_launch if route is not None
                      else SWEEPS_PER_LAUNCH if _forced is None else _forced)
        if per_launch == 0:
            if self.damp is not None and self.bf16:
                raise TypeError("the per-sweep damped K1 has no bf16 form; "
                                "a damped solve on a bf16 rhs runs on "
                                "K1-damp's tiles or whole grids")
            for _ in range(sweeps):
                self.sweep(lib, nb, nb1, b1, self.omw)
            return
        for step in sweep_plan(self.k, self.k + sweeps, self.end, per_launch,
                               prep=self.prep, cheby=self.omegas is not None,
                               guess=self.x is not None):
            if self.damp is None:
                self.launch(lib, step, nb, nb1, b1)
            else:
                self.launch_damped(lib, step, nb, nb1, b1, route)

    def run3(self, lib, slab: tuple[int, int, int] | None = None,
             carry_out: bool = False) -> None:
        """Every sweep of a 3-D solve (K5's, ``slab`` None) or of a z-slab
        segment on a buffer of ``slab = (planes, gtop, gbot)`` (K13's;
        sweep k of the segment, from 1, computes buffer planes [k,
        planes-k)): where ``tiled3`` says so, the tiled 3-D kernel's
        launches of ``sweep_plan``, T3 = ``SWEEPS_PER_LAUNCH_3D`` sweeps
        each, otherwise one per-sweep launch a sweep (``launch_sweeps``
        forces either in the tiled kernel's mode).  ``carry_out``: the
        last launch also stores x_{k-1}, which the segment hands on."""
        cheby = self.omegas is not None
        if _forced is not None:
            per_launch = _forced if tiled3(cheby, self.fast) else 0
        else:
            per_launch = (SWEEPS_PER_LAUNCH_3D if tiled3(
                cheby, self.fast, None if slab is None else slab[0],
                self.side) else 0)
        start = self.k
        if per_launch == 0:
            while self.k < self.end:
                if slab is None:
                    self.sweep(lib)
                else:
                    planes, gtop, gbot = slab
                    k = self.k - start + 1
                    self.sweep(lib, k, planes - k, gtop, gbot)
            return
        for step in sweep_plan(self.k, self.end, self.end, per_launch,
                               prep=self.prep, cheby=self.omegas is not None,
                               guess=self.x is not None,
                               carry_out=carry_out):
            if slab is None:
                self.launch(lib, step)
            else:
                planes, gtop, gbot = slab
                self.launch(lib, step, planes, step.first - start, gtop,
                            gbot)

    def run_slab(self, lib, rows: int, gtop: int, gbot: int) -> None:
        """The remaining sweeps of a row-slab solve (K9's) on a buffer of
        ``rows`` rows with wall rows ``gtop``/``gbot`` (-1 when absent):
        sweep k of the solve, from 1, computes buffer rows [k, rows-k), so
        a launch after ``k`` sweeps writes the band its last sweep leaves
        exact: the tiled K9's launches of ``sweep_plan``, T sweeps each on
        tiles of ``slab_tiling``'s rows, or inside ``launch_sweeps(0)`` one
        per-sweep launch a sweep."""
        per_launch, tile = self._slab_tiling(rows)
        if per_launch == 0:
            while self.k < self.end:
                self.sweep(lib, self.k + 1, rows - self.k - 1, gtop, gbot)
            return
        for step in sweep_plan(self.k, self.end, self.end, per_launch,
                               prep=self.prep, cheby=self.omegas is not None,
                               guess=self.x is not None):
            self.launch(lib, step, rows, step.first, gtop, gbot, tile)

    def _slab_tiling(self, rows: int) -> tuple[int, int]:
        """(T, tile rows) of the tiled K9's launches for the rest of the
        solve: ``slab_tiling``'s, or what ``launch_sweeps`` forces."""
        per_launch, tile = slab_tiling(rows, self.side, self.end - self.k)
        if _forced is not None:
            per_launch = _forced
        if _forced_tile is not None:
            tile = _forced_tile
        return per_launch, tile

    def run_slab_split(self, lib, xs: tuple, rhss: tuple, m: int, K: int,
                       gtop: int, gbot: int) -> None:
        """Every sweep of a row-slab Jacobi solve (no Chebyshev) whose
        extended (m + 2K)-row buffers are split operands, (slab, top halo,
        bottom halo) of x (all None: the zero guess) and of the rhs (B13):
        the first tiled K9 launch reads its tiles from the split operands
        and writes x_T and the rhs it read (pre-scaled in fast mode) on its
        band of ``self.rhs``'s shape, the launches after it run on those
        as ``run_slab``'s.  ``launch_sweeps(0)`` is not taken here (the
        per-sweep chain starts with K18, ``cuda_sharded``)."""
        rows = m + 2 * K
        per_launch, tile = self._slab_tiling(rows)
        first, *rest = sweep_plan(self.k, self.end, self.end, per_launch,
                                  prep=self.prep, cheby=False,
                                  guess=xs[0] is not None)
        out = self._scratch()
        rhs_out = None if first.ends_solve else self.rhs
        flags = (_PREP if self.prep else 0) | (_FAST if self.fast else 0)
        _launch("jacobi_slab_sweeps_split", lib.fsc_jacobi_slab_sweeps_split,
                *map(_ptr, xs), *map(_ptr, rhss), out.data_ptr(),
                _ptr(rhs_out), self.side, self.b, *self.coefs[:4], flags,
                first.count, m, K, gtop, gbot, tile, self.stream)
        self.prep = False
        self.x = out
        self.k += first.count
        for step in rest:
            self.launch(lib, step, rows, step.first, gtop, gbot, tile)

    def launch(self, lib, step: SweepLaunch, *geometry: int) -> None:
        """One tiled launch: the sweeps of ``step``; ``geometry`` goes
        between the launch's sweeps and the stream (K1's batch and boundary
        split, a z-slab's planes, sweeps done and wall planes, a row slab's
        rows, sweeps done, wall rows and tile rows)."""
        cheby = self.omegas is not None
        out = (torch.empty_like(self.rhs)
               if self.bf16 and self.final and step.ends_solve
               else self._scratch())
        xm_out = self._scratch(out) if step.stores_xm else None
        rhs_out = torch.empty_like(self.rhs) if step.stores_rhs else None
        ks = range(step.first, step.first + step.count)
        omegas = (ctypes.c_float * step.count)(
            *(_f32(self.omegas[k - 1]) if cheby and k >= 1 else 0.0
              for k in ks))
        flags = ((_PREP if self.prep else 0) | (_FAST if self.fast else 0)
                 | (_CHEBY if cheby else 0))
        name = self.TILED[self.kernel] + ("_bf16" if self.bf16 else "")
        # The operands as they are stored: a bf16 guess read as x_k (or
        # as x_{k-1} after a 1-sweep first launch); float32 scratch, or a
        # z-slab segment's float32 iterate and x_{k-1} carried in.
        types = (self._types(out),) if self.bf16 else ()
        _launch(name, getattr(lib, f"fsc_{name}"), _ptr(self.x),
                self.rhs.data_ptr(), _ptr(self.src if self.prep else None),
                _ptr(self.xm if cheby else None), out.data_ptr(),
                _ptr(xm_out), _ptr(rhs_out), self.side, self.b, *self.coefs,
                ctypes.addressof(omegas), flags, step.first, step.count,
                *geometry, *types, self.stream)
        if rhs_out is not None:
            self.rhs, self.prep = rhs_out, False
        if cheby:
            self.xm = self.x if step.count == 1 else xm_out
        self.x = out
        self.k += step.count

    def launch_damped(self, lib, step: SweepLaunch, nb: int, nb1: int,
                      b1: int, route: DampedRoute) -> None:
        """One K1-damp launch: the damped sweeps of ``step`` on tiles or
        whole grids, as ``route`` says; on a bf16 rhs its bf16-rhs form,
        the output bf16 where it ends a solve from zero."""
        out_bf16 = self.damp_bf16 and step.ends_solve
        out = torch.empty_like(self.rhs) if out_bf16 else self._scratch()
        alpha, beta = self.coefs[:2]
        args = (_ptr(self.x), self.rhs.data_ptr(), out.data_ptr(), self.side,
                self.b, alpha, beta, self.damp, self.omw, step.count, nb, nb1,
                b1, route.tile_rows, int(route.whole))
        if self.bf16:
            x_bf16 = self.x is not None and self.x.dtype == torch.bfloat16
            types = (_X_BF16 if x_bf16 else 0) | (_OUT_BF16 if out_bf16
                                                  else 0)
            _launch("jacobi_sweeps_damp_bf16", lib.fsc_jacobi_sweeps_damp_bf16,
                    *args, types, self.stream)
        else:
            _launch("jacobi_sweeps_damp", lib.fsc_jacobi_sweeps_damp, *args,
                    self.stream)
        self.x = out
        self.k += step.count


# ---------------------------------------------------------------------------
# B1 fused_jacobi (K1)
# ---------------------------------------------------------------------------


def _check_damp(damp, src_dt, fast, cheby_rho, x_init, x0,
                zero_init) -> None:
    """``damp`` is the multigrid smoother's alone: no source fold, no
    reciprocal form and no Chebyshev weights (JAX asserts the last,
    ``pallas_ops.py:540``).  A float32 rhs takes a float32 guess; a bf16
    rhs (the finest level of a bf16 multigrid solve) a bf16 guess or the
    zero guess, or a float32 guess: K1-damp's two bf16-rhs forms."""
    if damp is None:
        return
    if src_dt is not None or fast or cheby_rho is not None:
        raise ValueError("damp takes no src_dt, fast or cheby_rho")
    if x0.dtype == torch.float32 and x_init.dtype != torch.float32:
        raise TypeError(f"K1's damped sweeps on a float32 rhs take a float32 "
                        f"guess, got {x_init.dtype}")


def _fma_diffuse(b, x_init, rhs, ab, iters, cheby_rho=None):
    """``iters`` sweeps of the reciprocal form ``x' = rhs + ab*neigh`` (rhs
    already scaled by 1/beta) with the product and the sum rounded once, as
    K1's ``fmaf`` rounds them: in float64, where the product of two float32
    values is exact, then back to float32.  That second rounding can differ
    from the single one only where the float64 sum lands exactly halfway
    between two float32 values.  With ``cheby_rho`` each sweep after the
    first is combined with x_{k-1} in float32 as K1 combines it
    (``w*x' + (1-w)*x_{k-1}``, ``ops/chebyshev.py``)."""
    ab = _f32(ab)
    rhs_int = rhs[..., 1:-1, 1:-1].double()

    def sweep(x):
        neigh = (((x[..., 1:-1, :-2] + x[..., 1:-1, 2:]) + x[..., :-2, 1:-1])
                 + x[..., 2:, 1:-1])
        return (rhs_int + ab * neigh.double()).to(x.dtype)

    xm, x = x_init, embed_interior(b, sweep(x_init))
    omegas = () if cheby_rho is None else cheby_omegas(cheby_rho, iters)
    for k in range(1, iters):
        val = sweep(x)
        if omegas:
            w = torch.full((), omegas[k - 1], dtype=x.dtype, device=x.device)
            val = w * val + (1.0 - w) * xm[..., 1:-1, 1:-1]
        xm, x = x, embed_interior(b, val)
    return x


def fused_jacobi_plain(b, x_init, x0, alpha, beta, iters, *, zero_init=False,
                       src_dt=None, fast=False, cheby_rho=None, damp=None):
    """Plain form of ``fused_jacobi``: ``ops.diffuse``,
    ``ops.chebyshev.cheby_diffuse`` or ``ops.diffuse.damped_diffuse`` on
    the rhs ``x0 + dt*x_init`` (with b=0, alpha=1, beta=4 and damp=0.8 the
    multigrid smoother ``ops.multigrid._smooth``).  ``fast`` Jacobi sweeps
    and Chebyshev sweeps round as K1's do (``_fma_diffuse``), so the two
    agree to the bit.  bf16 fields are widened to float32, the rhs built in
    float32 and rounded to bf16 once (K1's bf16 form, ``_Sweeps``), the
    sweeps run in float32 and the result is rounded to bf16.  A damped
    solve on a bf16 rhs is K1-damp's bf16-rhs forms: float32 sweeps with
    w and 1-w in the guess's dtype, as JAX's ``_smooth`` takes them, and
    the result in it: from zero or a bf16 guess, w and 1-w rounded to bf16
    and the result rounded to bf16 once; from a float32 guess, float32
    throughout (``_smooth`` on that guess, bit for bit)."""
    _check_damp(damp, src_dt, fast, cheby_rho, x_init, x0, zero_init)
    if damp is not None and x0.dtype == torch.bfloat16:
        dtype = torch.bfloat16 if zero_init else x_init.dtype
        x = (torch.zeros_like(x0, dtype=torch.float32) if zero_init
             else x_init.float())
        return damped_diffuse(b, x, x0.float(), alpha, beta, iters, damp,
                              omega_dtype=dtype).to(dtype)
    if zero_init:
        x_init = torch.zeros_like(x0)
    if x0.dtype == torch.bfloat16:
        x_init = x_init.float()
        rhs = _plain_rhs(x_init, x0.float(), beta, src_dt, fast)
        return _plain_sweeps(b, x_init, rhs.to(torch.bfloat16).float(),
                             alpha, beta, iters, fast, cheby_rho,
                             damp).to(torch.bfloat16)
    return _plain_sweeps(b, x_init, _plain_rhs(x_init, x0, beta, src_dt, fast),
                         alpha, beta, iters, fast, cheby_rho, damp)


def _plain_rhs(x_init, x0, beta, src_dt, fast):
    """The rhs a solve's first sweep builds: ``x0 + dt*x_init``, times
    1/beta in fast mode."""
    rhs = x0 if src_dt is None else add_source(x0, x_init, src_dt)
    return rhs * (1.0 / beta) if fast else rhs


def _plain_sweeps(b, x_init, rhs, alpha, beta, iters, fast, cheby_rho, damp):
    """The sweeps of ``fused_jacobi_plain`` on a built rhs."""
    if fast:
        # The reciprocal form rhs/beta + (alpha/beta)*neigh on a pre-scaled
        # rhs, one fmaf a sweep.
        return _fma_diffuse(b, x_init, rhs, alpha / beta, iters, cheby_rho)
    if cheby_rho is not None:
        return cheby_diffuse(b, x_init, rhs, alpha, beta, iters, cheby_rho)
    if damp is not None:
        return damped_diffuse(b, x_init, rhs, alpha, beta, iters, damp)
    return diffuse(b, x_init, rhs, alpha, beta, iters)


def fused_jacobi(b, x_init, x0, alpha, beta, iters, *, zero_init=False,
                 src_dt=None, fast=False, cheby_rho=None, damp=None):
    """``iters`` Jacobi sweeps (semantics of ``ops.diffuse``) from guess
    ``x_init`` with rhs ``x0``.  ``zero_init`` starts from zero (pressure
    solve); ``src_dt`` folds the source ``x_init`` into the rhs as
    ``x0 + src_dt*x_init``; ``fast`` uses the reciprocal form
    (``pallas_ops.py:423-456``); ``cheby_rho`` switches to Chebyshev sweeps
    (``ops/chebyshev.py``); ``damp`` to damped Jacobi, x <- (1-damp)*x +
    damp*sweep (``pallas_ops.py:432-459``, the multigrid smoother), which
    takes none of ``src_dt``, ``fast`` and ``cheby_rho``.  The tiled K1
    runs T sweeps a launch (``sweep_plan``); K1-damp the launches of
    ``damped_plan``."""
    if iters < 1:
        raise ValueError("iters must be >= 1")
    _check_damp(damp, src_dt, fast, cheby_rho, x_init, x0, zero_init)
    # A damped solve's guess may be float32 beside a bf16 rhs.
    card = _on_card(x0.shape[-1], *((x0,) if damp is not None
                                    else (x_init, x0)), dtypes=_F32_BF16)
    _on_device((x_init, x0.shape, _F32_BF16), (x0, x0.shape, _F32_BF16))
    if not card:
        return fused_jacobi_plain(b, x_init, x0, alpha, beta, iters,
                                  zero_init=zero_init, src_dt=src_dt,
                                  fast=fast, cheby_rho=cheby_rho, damp=damp)
    return _solve(b, _batch(x0), b, x_init, x0, alpha, beta, iters,
                  zero_init=zero_init, src_dt=src_dt, fast=fast,
                  cheby_rho=cheby_rho, damp=damp)


def mg_smooth_plain(p, div, sweeps, zero_init=False):
    """Plain form of ``mg_smooth``."""
    return fused_jacobi_plain(0, p, div, 1.0, 4.0, sweeps,
                              zero_init=zero_init, damp=OMEGA)


def mg_smooth(p, div, sweeps, zero_init=False):
    """The multigrid smoother on K1-damp (the ``cuda`` OpSet's
    ``smooth``): ``sweeps`` damped sweeps, w = ``ops.multigrid.OMEGA``, of
    the pressure problem (b=0, alpha=1, beta=4) from ``p`` or from zero, in
    the launches of ``damped_plan``; equal to ``ops.multigrid._smooth`` bit
    for bit in float32 and from a float32 guess on a bf16 rhs.  From zero
    or a bf16 guess on a bf16 rhs (a bf16 solve's first pre-smooth; below
    16² its whole solve) the iterate stays float32 and is rounded to bf16
    once, at the store, where JAX's jnp ``_smooth`` rounds every operation
    (ROADMAP §C)."""
    return fused_jacobi(0, p, div, 1.0, 4.0, sweeps, zero_init=zero_init,
                        damp=OMEGA)


def _solve(b, nb1, b1, x_init, x0, alpha, beta, iters, **kw):
    """The K1 launches of one solve on the card: grids [0, nb1) of the
    batch take boundary mode ``b``, the rest ``b1``."""
    with torch.cuda.device(x0.device):
        lib = build.load()
        sweeps = _Sweeps(b, x_init, x0, alpha, beta, iters, **kw)
        sweeps.run(lib, iters, _batch(x0), nb1, b1)
        return sweeps.x


def fused_jacobi_pair_plain(b1, b2, s1, s2, base1, base2, alpha, beta, iters,
                            *, src_dt=None, fast=False):
    """Plain form of ``fused_jacobi_pair``: the two solves it stacks."""
    return tuple(fused_jacobi_plain(b, s, base, alpha, beta, iters,
                                    src_dt=src_dt, fast=fast)
                 for b, s, base in ((b1, s1, base1), (b2, s2, base2)))


def fused_jacobi_pair(b1, b2, s1, s2, base1, base2, alpha, beta, iters, *,
                      src_dt=None, fast=False):
    """Two same-coefficient solves with boundary modes ``b1`` and ``b2``
    (the velocity pair, ``FluidSequential.c:228-229``) in one set of K1
    launches: as JAX's ``fused_jacobi_pair`` (``pallas_ops.py:671``), the
    operands stack on the batch axis (``torch.cat``, so both fields are
    copied once) and grids at or past ``nb1`` (the first operand's grid
    count) take ``b2``.  Operands are (side, side) or (nb, side, side);
    returns the two results, each equal to its own ``fused_jacobi`` bit for
    bit.  JAX measured it slower than two singles and does not wire it into
    the step; neither does the port."""
    if iters < 1:
        raise ValueError("iters must be >= 1")
    if not _on_card(base1.shape[-1], s1, s2, base1, base2):
        return fused_jacobi_pair_plain(b1, b2, s1, s2, base1, base2, alpha,
                                       beta, iters, src_dt=src_dt, fast=fast)
    nb = _batch(base1)

    def stack(a, c):
        return torch.cat([a, c]) if a.dim() == 3 else torch.stack([a, c])

    out = _solve(b1, nb, b2, stack(s1, s2), stack(base1, base2), alpha,
                 beta, iters, zero_init=False, src_dt=src_dt, fast=fast,
                 cheby_rho=None)
    if base1.dim() == 2:
        return out[0], out[1]
    return out[:nb], out[nb:]


# ---------------------------------------------------------------------------
# B5a divergence_p, B5b gradient_p (K2) and B2 fused_project (K2 + K1)
# ---------------------------------------------------------------------------


def _divergence_plain(u, v, n, out_dtype):
    return divergence(u.float(), v.float(), n).to(out_dtype)


def _divergence(u, v, n, out_dtype):
    """K2's divergence of float32 or bf16 u, v into ``out_dtype``: float32
    out of float32; bf16 u, v into float32 (``fused_project``'s stage) or
    into bf16 (``divergence_p``).  The arithmetic is float32."""
    if not _on_card(n + 2, u, v, dtypes=_F32_BF16):
        return _divergence_plain(u, v, n, out_dtype)
    with torch.cuda.device(u.device):
        lib = build.load()
        out = torch.empty_like(u, dtype=out_dtype)
        coef = -0.5 * grid_h(n)
        if u.dtype == torch.float32:
            _launch("divergence", lib.fsc_divergence, u.data_ptr(),
                    v.data_ptr(), out.data_ptr(), n + 2, _batch(u), coef,
                    _stream(u))
        else:
            _launch("divergence_bf16", lib.fsc_divergence_bf16, u.data_ptr(),
                    v.data_ptr(), out.data_ptr(), n + 2, _batch(u), coef,
                    int(out_dtype == torch.bfloat16), _stream(u))
        return out


def divergence_p_plain(u, v, n):
    return _divergence_plain(u, v, n, u.dtype)


def divergence_p(u, v, n):
    """Divergence with the b=0 border (``ops.project.divergence``), in the
    fields' dtype (float32 arithmetic)."""
    return _divergence(u, v, n, u.dtype)


def _check_gradient(u, v, p) -> None:
    """u and v of one dtype; p float32 or theirs."""
    if u.dtype != v.dtype or p.dtype not in (torch.float32, u.dtype):
        raise TypeError(f"gradient_p takes u and v of one dtype and p of "
                        f"theirs or float32, got {u.dtype}, {v.dtype}, "
                        f"{p.dtype}")


def gradient_p_plain(u, v, p, n):
    _check_gradient(u, v, p)
    return tuple(f.to(u.dtype) for f in apply_pressure_gradient(
        u.float(), v.float(), p.float(), n))


def gradient_p(u, v, p, n):
    """Pressure-gradient subtraction with the b=1 (u) and b=2 (v) borders
    (``ops.project.apply_pressure_gradient``), in u's dtype (float32
    arithmetic): float32 u, v, p; or bf16 u, v with a float32 p
    (``fused_project``'s stage) or a bf16 one (``gradient_p``)."""
    _check_gradient(u, v, p)
    card = _on_card(n + 2, u, v, dtypes=_F32_BF16)
    _on_device((u, u.shape, _F32_BF16), (p, u.shape, _F32_BF16))
    if not card:
        return gradient_p_plain(u, v, p, n)
    with torch.cuda.device(u.device):
        lib = build.load()
        uo = torch.empty_like(u)
        vo = torch.empty_like(v)
        if u.dtype == torch.float32:
            _launch("gradient", lib.fsc_gradient, u.data_ptr(), v.data_ptr(),
                    p.data_ptr(), uo.data_ptr(), vo.data_ptr(), n + 2,
                    _batch(u), grid_h(n), _stream(u))
        else:
            width = vector_width("gradient_bf16", n + 2, u, v, p, uo, vo)
            _launch_vector("gradient_bf16", width, lib.fsc_gradient_bf16,
                           u.data_ptr(), v.data_ptr(), p.data_ptr(),
                           uo.data_ptr(), vo.data_ptr(), n + 2, _batch(u),
                           grid_h(n), int(p.dtype == torch.bfloat16), width,
                           _stream(u))
        return uo, vo


def fused_project_plain(u, v, n, iters, *, cheby_rho=None):
    div = _divergence_plain(u, v, n, torch.float32)
    p = fused_jacobi_plain(0, div, div, 1.0, 4.0, iters, zero_init=True,
                           cheby_rho=cheby_rho)
    return gradient_p_plain(u, v, p, n)


def fused_project(u, v, n, iters, *, cheby_rho=None):
    """Projection: divergence (K2), ``iters`` pressure sweeps from zero with
    alpha=1, beta=4 (K1, Jacobi or Chebyshev), gradient (K2).  The
    divergence and the pressure are float32 whatever u and v store, as in
    the TPU kernel's bf16 mode (``pallas_ops.py:791-797``, ``:828-834``):
    only u and v are read and written as bf16."""
    div = _divergence(u, v, n, torch.float32)
    p = fused_jacobi(0, div, div, 1.0, 4.0, iters, zero_init=True,
                     cheby_rho=cheby_rho)
    return gradient_p(u, v, p, n)


# ---------------------------------------------------------------------------
# B3 advect_shift / advect_shift_fused (K3)
# ---------------------------------------------------------------------------


def _advect_plain(b, d0, u, v, dt, n, cmax):
    if cmax is None:
        return advect(b, d0, u, v, dt, n)
    return advect_windowed(b, d0, u, v, dt, n, cmax)


def advect_shift_plain(b, d0, u, v, dt, n, cmax=None):
    return _advect_plain(b, d0, u, v, dt, n, cmax)


def advect_shift_fused_plain(bs, d0s, u, v, dt, n, cmax=None):
    return tuple(_advect_plain(b, d0, u, v, dt, n, cmax)
                 for b, d0 in zip(bs, d0s))


def _dt0(dt: float, n: int) -> float:
    return float(np.float32(dt) * np.float32(n))


def _cmax_arg(cmax) -> int:
    """The kernels' ``cmax`` argument: 0 gathers exactly."""
    if cmax is None:
        return 0
    if cmax < 1:
        raise ValueError(f"the gather window is >= 1 cell, got cmax={cmax}")
    return int(cmax)


def advect_shift_fused(bs, d0s, u, v, dt, n, cmax=None):
    """Advect one or two fields by the same velocity with one shared
    backtrace (the u/v self-advection pair, ``FluidSequential.c:232,237``).
    Exact at any displacement, or with ``cmax`` clamped to the gather
    window of ``cmax`` cells (``ops.advect.advect_windowed``); outputs are
    fresh tensors, so advecting u and v by themselves reads the
    pre-advection velocity.  Fields and velocities are all float32 or all
    bf16; the backtrace and the blend are float32 either way (the plain
    ``ops.advect`` widens bf16 the same way)."""
    bs, d0s = tuple(bs), tuple(d0s)
    if len(bs) != len(d0s) or len(d0s) not in (1, 2):
        raise ValueError("advect_shift_fused takes one or two fields")
    window = _cmax_arg(cmax)
    if not _on_card(n + 2, u, v, *d0s, dtypes=_F32_BF16):
        return advect_shift_fused_plain(bs, d0s, u, v, dt, n, cmax)
    with torch.cuda.device(u.device):
        lib = build.load()
        outs = tuple(torch.empty_like(d) for d in d0s)
        d2, o2, b2 = ((d0s[1], outs[1], bs[1]) if len(d0s) == 2
                      else (None, None, 0))
        args = (d0s[0].data_ptr(), _ptr(d2), u.data_ptr(), v.data_ptr(),
                outs[0].data_ptr(), _ptr(o2), n + 2, _batch(u), bs[0], b2,
                _dt0(dt, n), window)
        if u.dtype == torch.float32:
            _launch("advect", lib.fsc_advect, *args, _stream(u))
        else:
            width = vector_width("advect_bf16", n + 2, u, v, *d0s, *outs)
            _launch_vector("advect_bf16", width, lib.fsc_advect_bf16, *args,
                           width, _stream(u))
        return outs


def advect_shift(b, d0, u, v, dt, n, cmax=None):
    """Semi-Lagrangian advection of one field (``ops.advect.advect``, or
    ``advect_windowed`` with ``cmax``)."""
    return advect_shift_fused((b,), (d0,), u, v, dt, n, cmax)[0]


# ---------------------------------------------------------------------------
# B4 fused_dens_advect (K1 + K4)
# ---------------------------------------------------------------------------


def fused_dens_advect_plain(b, src, base, u, v, alpha, beta, iters, dt, n, *,
                            cmax=None, fast=False, cheby_rho=None):
    d = fused_jacobi_plain(b, src, base, alpha, beta, iters, src_dt=dt,
                           fast=fast, cheby_rho=cheby_rho)
    return _advect_plain(b, d, u, v, dt, n, cmax)


def fused_dens_advect(b, src, base, u, v, alpha, beta, iters, dt, n, *,
                      cmax=None, fast=False, cheby_rho=None):
    """``advect(b, diffuse_src(b, src, base, ...), u, v)``: the tiled K1
    runs the first ``iters-1`` sweeps, then K4 evaluates the last sweep at the gather
    points and blends them, so the diffused field is never stored.  The
    gather is exact, or windowed with ``cmax`` as ``advect_shift``'s."""
    if iters < 1:
        raise ValueError("iters must be >= 1")
    window = _cmax_arg(cmax)
    if not _on_card(n + 2, src, base, u, v):
        return fused_dens_advect_plain(b, src, base, u, v, alpha, beta, iters,
                                       dt, n, cmax=cmax, fast=fast,
                                       cheby_rho=cheby_rho)
    with torch.cuda.device(base.device):
        lib = build.load()
        nb = _batch(base)
        sweeps = _Sweeps(b, src, base, alpha, beta, iters, zero_init=False,
                         src_dt=dt, fast=fast, cheby_rho=cheby_rho)
        sweeps.run(lib, iters - 1, nb, nb, b)
        out = torch.empty_like(base)
        _launch("dens_advect", lib.fsc_dens_advect, *sweeps.next_args(),
                u.data_ptr(), v.data_ptr(), out.data_ptr(), n + 2, nb, b,
                _dt0(dt, n), window, sweeps.stream)
        return out


# ---------------------------------------------------------------------------
# OpSet wiring
# ---------------------------------------------------------------------------


def make_opset(cfg, plain: bool = False) -> OpSet:
    """The CUDA OpSet (twin of ``pallas_ops.make_opset``) for ``cfg``.  It
    reads ``fast_math``, and ``advect_mode``: ``"windowed"`` gathers under
    the window of ``max_courant`` cells, as JAX's Pallas OpSet always does;
    ``"auto"`` and ``"exact"`` gather exactly.  The multigrid smoother is
    K1-damp on every level (JAX's Pallas OpSet takes its damped kernel
    where the TPU tiling allows, ``ops/multigrid.py:242-251``); like JAX's,
    it ignores ``fast_math``.

    ``plain`` binds every op to its kernel's plain twin on any device, fast
    math's reciprocal form included: the same arithmetic as the kernels in
    torch ops, which launch nothing.  The ``reference`` backend ignores
    ``fast_math``, so this is what a fast-math step on the card is held to
    (``chip_smoke.py``).

    In bf16 (``cfg.dtype``, chosen here once) ``diffuse_advect`` composes
    the density solve and its gather, K1 then K3, as JAX's bf16 OpSet
    composes ``diffuse_src`` and ``advect`` (``pallas_ops.py:1730-1741``):
    K4 has no bf16 form, in JAX as here."""
    fast = cfg.fast_math
    cmax = cfg.max_courant if cfg.advect_mode == "windowed" else None
    bf16 = cfg.dtype == torch.bfloat16
    if plain:
        jacobi, adv, adv_fused, dens_adv = (
            fused_jacobi_plain, advect_shift_plain, advect_shift_fused_plain,
            fused_dens_advect_plain)
        div, grad, project, smooth = (divergence_p_plain, gradient_p_plain,
                                      fused_project_plain, mg_smooth_plain)
    else:
        jacobi, adv, adv_fused, dens_adv = (
            fused_jacobi, advect_shift, advect_shift_fused, fused_dens_advect)
        div, grad, project, smooth = (divergence_p, gradient_p,
                                      fused_project, mg_smooth)

    def diffuse_op(b, x_init, x0, alpha, beta, iters, cheby_rho=None):
        return jacobi(b, x_init, x0, alpha, beta, iters, fast=fast,
                      cheby_rho=cheby_rho)

    def diffuse_src(b, src, base, alpha, beta, iters, dt, cheby_rho=None):
        return jacobi(b, src, base, alpha, beta, iters, src_dt=dt, fast=fast,
                      cheby_rho=cheby_rho)

    def advect(b, d0, u, v, dt, n):
        return adv(b, d0, u, v, dt, n, cmax)

    def advect_pair(b1, b2, d1, d2, u, v, dt, n):
        return adv_fused((b1, b2), (d1, d2), u, v, dt, n, cmax)

    def pressure_solve(div, iters, cheby_rho=None):
        return jacobi(0, div, div, 1.0, 4.0, iters, zero_init=True,
                      cheby_rho=cheby_rho)

    def diffuse_advect(b, src, base, u, v, alpha, beta, iters, dt, n,
                       cheby_rho=None):
        if bf16:
            d = diffuse_src(b, src, base, alpha, beta, iters, dt,
                            cheby_rho=cheby_rho)
            return advect(b, d, u, v, dt, n)
        return dens_adv(b, src, base, u, v, alpha, beta, iters, dt, n,
                        cmax=cmax, fast=fast, cheby_rho=cheby_rho)

    return OpSet(
        diffuse=diffuse_op,
        advect=advect,
        divergence=div,
        pressure_solve=pressure_solve,
        apply_pressure_gradient=grad,
        advect_pair=advect_pair,
        project=project,
        diffuse_src=diffuse_src,
        smooth=smooth,
        diffuse_advect=diffuse_advect,
    )
