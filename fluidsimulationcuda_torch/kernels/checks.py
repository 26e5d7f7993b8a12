"""Kernel-against-plain comparisons and device timing on the card.

Shared by ``chip_smoke.py`` and the GPU tests: each ``Check`` calls one
``cuda_ops``, ``cuda_ops_3d``, ``cuda_step``, ``cuda_sharded`` or
``cuda_sharded_3d`` wrapper on CUDA tensors and its plain version on the
same tensors, at the coefficients the 2-D, 3-D or multi-device step gives
it.  Inputs come from ``np.random.default_rng(seed)``: fields in [-1, 1],
velocities scaled so the backtrace moves at most two cells (six for the
gathers that test the window clamp).

A timed check also carries its cost: the field-sized arrays the call must
move (each of its inputs read once and each of its outputs written once,
whatever its launches read again; a solve's intermediate iterates are
neither) and its float operations per cell.  ``Check.bound()`` turns them
into the least time the card could take for the same work.  A fused
kernel's timed check also carries the composition it replaces
(``composed``), and a call with tiled solves in it (K1, or the 3-D kernel
of K5 and K13) the same call on the per-sweep kernels (``chain``), each
timed beside it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch

from ..core.config import PERF_POINT_3D, PERF_POINTS_2D
from ..ops.advect import backtrace, departure
from ..ops.chebyshev import cheby_omegas
from ..ops.multigrid import OMEGA, _smooth
from ..ops.three_d import backtrace3, departure3
from . import cuda_ops as co
from . import cuda_ops_3d as co3
from . import cuda_sharded as cs
from . import cuda_sharded_3d as cs3
from . import cuda_step as cst

__all__ = ["TOL", "HBM_BYTES_PER_S", "F32_OPS_PER_S", "Check",
           "kernel_checks", "timing_checks", "kernel_checks3",
           "timing_checks3", "kernel_checks_slab", "timing_checks_slab",
           "kernel_checks_slab3", "kernel_checks_slab3_flows",
           "timing_checks_slab3", "slab_per_sweep_checks",
           "split_against_concat", "timing_checks_tail",
           "timing_checks_tail_batched",
           "kernel_checks_batched", "batched_against_grids",
           "timing_checks_batched",
           "pair_against_singles", "timing_checks_pair",
           "timing_checks_split", "split_against_k18", "kernel_checks_damp",
           "MG_SMOOTHS_BF16",
           "timing_checks_damp", "kernel_checks_group_smooth", "timing_checks_group_smooth",
           "GROUP_SMOOTHS", "kernel_checks3_windowed",
           "timing_checks3_windowed", "K4_TILE", "K4_BOX_CAP",
           "footprint_boxes", "gather_velocities", "kernel_checks_flows",
           "staged_share", "max_abs_diff", "device_ms",
           "kernel_checks_bf16", "timing_checks_bf16", "k1_checks",
           "BF16_FORM_VELOCITIES", "BF16_FORM_FIELDS", "BF16_FORMS",
           "kernel_checks_bf16_forms",
           "per_sweep_checks", "kernel_checks_block", "timing_checks_block",
           "block_chunk_forms", "block_chunk", "kernel_checks_block_group",
           "timing_checks_block_group", "block_stencil", "BLOCK_STENCIL_FORMS",
           "kernel_checks_block_stencil_group",
           "timing_checks_block_stencil_group",
           "kernel_checks3_bf16", "timing_checks3_bf16",
           "kernel_checks_slab3_bf16", "timing_checks_slab3_bf16"]

# Kernel against plain version on the same inputs.  Both evaluate the same
# float32 expressions in the same order (the kernels build with
# --fmad=false), so parity modes agree to a few ulps; fast mode differs by
# one rounding per sweep (fmaf against a multiply and an add).
TOL = 1e-5

# The H100 SXM's published peaks (NVIDIA data sheet): HBM3 bandwidth and
# float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

DT, VISC, DIFF = 0.016, 0.0025, 0.1


@dataclasses.dataclass
class Check:
    label: str
    kernels: tuple[str, ...]  # the CUDA kernels this wrapper call launches
    run: Callable[[], object]
    plain: Callable[[], object]
    cost: tuple[int, int] = (0, 0)  # (field passes, float ops per cell)
    cells: int = 0  # cells of one field
    composed: Callable[[], object] | None = None  # what a fusion replaces
    # The same call with its tiled solves on the per-sweep kernels
    # (``_k1_timed``).
    chain: Callable[[], object] | None = None
    # A gather's fields and its departure coordinates (x, y[, z]) in each
    # field's own cells, for a library gather's time beside the kernel's.
    gather: Callable[[], tuple[list, tuple]] | None = None
    # K4's footprint box per block of its launch (footprint_boxes).
    boxes: Callable[[], torch.Tensor] | None = None
    # A block form's slab counterpart on as many cells (its slab kernel on
    # a slab of the same cell count), or a bf16 form's float32 form on the
    # same values, timed beside it (``counterpart_label`` says which).
    counterpart: Callable[[], object] | None = None
    counterpart_label: str = "slab counterpart on as many cells"
    # A 3-D solve or z-slab segment in the tiled 3-D kernel's mode (fast
    # Chebyshev), which ``per_sweep_checks`` holds on the tiled kernel
    # against the per-sweep kernels, whatever the path takes.
    tiled_mode: bool = False

    def bound(self) -> tuple[float, str]:
        """(ms, "bytes" or "operations"): the larger of the bytes the
        launches must move over the HBM rate and their float operations
        over the float32 peak."""
        fields, ops = self.cost
        bytes_ms = 1e3 * fields * self.cells * 4 / HBM_BYTES_PER_S
        ops_ms = 1e3 * ops * self.cells / F32_OPS_PER_S
        return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                               "operations")


def _check(label, kernels, fn, plain, *args, **kw) -> Check:
    return Check(label, kernels, lambda: fn(*args, **kw),
                 lambda: plain(*args, **kw))


def _timed(cost: tuple[int, int], cells: int, label, kernels, fn, plain,
           *args, **kw) -> Check:
    check = _check(label, kernels, fn, plain, *args, **kw)
    check.cost, check.cells = cost, cells
    return check


def _per_sweep(fn, *args, **kw):
    """``fn(*args, **kw)`` with every K1 solve and 3-D solve or z-slab
    segment in it on the per-sweep kernels (``cuda_ops.launch_sweeps(0)``:
    K1, K5, K13)."""
    with co.launch_sweeps(0):
        return fn(*args, **kw)


def _k1_timed(cost: tuple[int, int], cells: int, label, kernels, fn, plain,
              *args, **kw) -> Check:
    """A timed check of a call whose solves take a tiled kernel (K1, or
    the 3-D kernel of K5 and K13), carrying the same call on the per-sweep
    kernels (``chain``), timed beside it."""
    check = _timed(cost, cells, label, kernels, fn, plain, *args, **kw)
    check.chain = functools.partial(_per_sweep, fn, *args, **kw)
    return check


def _tiled(fn, *args, **kw):
    """``fn(*args, **kw)`` with every 3-D solve or z-slab segment in the
    tiled kernel's mode on the tiled 3-D kernel, whatever
    ``cuda_ops.tiled3`` gives the path: T3 sweeps a launch, or the sweeps a
    caller's ``cuda_ops.launch_sweeps`` forces."""
    if co._forced:
        return fn(*args, **kw)
    with co.launch_sweeps(co.SWEEPS_PER_LAUNCH_3D):
        return fn(*args, **kw)


def _tiled_timed(cost: tuple[int, int], cells: int, label, kernels, fn,
                 plain, *args, **kw) -> Check:
    """A timed check of a 3-D solve or z-slab segment in the tiled
    kernel's mode, run on the tiled 3-D kernel (``_tiled``), carrying the
    same call on the per-sweep kernels (``chain``, the path's where
    ``cuda_ops.tiled3`` gives it the vector walk), timed beside it."""
    check = _timed(cost, cells, label, kernels, fn, plain, *args, **kw)
    check.run = functools.partial(_tiled, fn, *args, **kw)
    check.chain = functools.partial(_per_sweep, fn, *args, **kw)
    check.tiled_mode = True
    return check


def _solve3(check: Check, kw: dict) -> Check:
    """``check``, a 3-D solve or z-slab segment of keyword arguments
    ``kw``, marked where it is in the tiled kernel's mode."""
    check.tiled_mode = (kw.get("cheby_rho") is not None
                        and kw.get("fast", False))
    return check


def _sweep_ops(iters: int, ndim: int, *, src=False, fast=False,
               cheby=False, damp=False) -> list[int]:
    """Float operations per cell of each sweep of one solve: the neighbour
    sum, alpha*sum + rhs and /beta; the first sweep of a folded or fast
    solve also builds the rhs; a Chebyshev sweep after the first combines
    with x_{k-1}; a damped sweep blends with x_k."""
    prep = src or fast
    return [(2 * ndim + 2) + ((2 * src + fast) if prep and k == 0 else 0)
            + 4 * (cheby and k >= 1) + 3 * damp for k in range(iters)]


def _sweeps_cost(iters: int, ndim: int, *, zero_init=False, bf16=False,
                 **kw) -> tuple[float, int]:
    """Cost of one solve of ``iters`` sweeps over a whole grid: its
    inputs read once (the guess, none for the zero guess, and the rhs or
    base; the folded source is the guess) and its result written once, at
    their storage widths (in K1's bf16 form a bf16 field counts half a
    float32 pass), whatever its launches read again; and the operations of
    every sweep (``_sweep_ops``)."""
    store = 0.5 if bf16 else 1
    return ((0 if zero_init else store) + 2 * store,
            sum(_sweep_ops(iters, ndim, **kw)))


def _slab_sweeps_cost(iters: int, rows: int, side: int, *, zero_init=False,
                      **kw) -> tuple[int, int]:
    """Cost of one slab solve on a buffer of ``rows`` rows, in field-cells
    (use with ``cells=1``): the buffer's guess (none for the zero guess)
    and rhs read once, the rows its last sweep computes written once;
    sweep k computes rows [k, rows-k)."""
    ops = sum(o * (rows - 2 * k) * side for k, o in
              enumerate(_sweep_ops(iters, 2, **kw), start=1))
    return ((1 - zero_init + 1) * rows + rows - 2 * iters) * side, ops


def _scaled(cost: tuple[int, int], cells: int) -> tuple[int, int]:
    return cost[0] * cells, cost[1] * cells


def _function(passes: float, *costs: tuple[float, int]) -> tuple[float, int]:
    """The cost of a call that composes ``costs``: the call's own inputs
    and outputs, ``passes``, each once; every part's operations."""
    return passes, sum(c[1] for c in costs)


def _project(solve: tuple[float, int], bf16: bool = False
             ) -> tuple[float, int]:
    """``fused_project``'s cost with the pressure ``solve``: u and v read
    and written once (bf16 in bf16 storage), the divergence, the solve's
    and the gradient's operations."""
    if bf16:
        return _function(2, DIV2_BF16, solve, GRAD2_BF16)
    return _function(4, DIV2, solve, GRAD2)


# (field passes, float ops per cell) of one launch of the other kernels.
DIV2, GRAD2 = (3, 4), (5, 8)
ADVECT2_PAIR, ADVECT2_ONE = (4, 24), (4, 18)
# Their bf16 forms, a bf16 pass counting half: the divergence into float32
# (fused_project's) and into bf16 (divergence_p's); the gradient from a
# float32 pressure (fused_project's) and from a bf16 one (gradient_p's).
DIV2_BF16, DIVP_BF16 = (2, 4), (1.5, 4)
GRAD2_BF16, GRADP_BF16 = (3, 8), (2.5, 8)
ADVECT2_PAIR_BF16, ADVECT2_ONE_BF16 = (2, 24), (2, 18)
# K4 alone, and the function fused_dens_advect at any sweep count: src,
# base, u and v read, the result written; four stencil evaluations and a
# bilinear blend.
DENS_ADVECT = (5, 50)
DIV3, GRAD3 = (4, 6), (7, 12)
ADVECT3_ONE, ADVECT3_TRIPLE = (5, 39), (6, 81)


class _Inputs:
    """Random fields at grid ``side`` (``ndim``-D; with ``batch``, a batch
    of that many 2-D grids) and the step's coefficients there; in 2-D also
    velocities that move the backtrace up to 6 cells (``uf``, ``vf``: over
    the 4-cell window)."""

    def __init__(self, side: int, device, seed: int, ndim: int = 2,
                 batch: int = 0):
        rng = np.random.default_rng(seed)
        self.n = n = side - 2
        shape = ((batch,) if batch else ()) + (side,) * ndim
        self.cells = math.prod(shape)

        def field(scale=1.0):
            a = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
            return torch.from_numpy(a * np.float32(scale)).to(device)

        vscale = 2.0 / (DT * n)  # |dt*n*u| <= 2 cells
        self.x, self.x0, self.src, self.p = field(), field(), field(), field()
        self.u, self.v = field(vscale), field(vscale)
        self.w = field(vscale) if ndim == 3 else None
        self.a_visc = DT * VISC * n * n
        self.a_diff = DT * DIFF * n * n
        if ndim == 2:
            rng = np.random.default_rng(seed + 1)
            vfast = 6.0 / (DT * n)
            self.uf, self.vf = (torch.from_numpy(
                rng.uniform(-vfast, vfast, shape).astype(np.float32)
            ).to(device) for _ in range(2))
        self._spec = (shape, ndim, device, seed)

    @functools.cached_property
    def smooth(self) -> tuple[torch.Tensor, ...]:
        """Velocities of the kind the steps run (``_smooth_velocities``),
        from a generator of their own, so the fields above stay as they
        were."""
        shape, ndim, device, seed = self._spec
        return tuple(torch.from_numpy(f).to(device) for f in
                     _smooth_velocities(np.random.default_rng(seed + 2),
                                        shape, ndim, self.n))

    @functools.cached_property
    def blob(self) -> torch.Tensor:
        """A 2-D density as a step leaves it: a Gaussian blob of width
        side/32 in the middle of each grid, exactly zero or subnormal far
        from it (the sweep's division meets such values in a step, not on
        the random fields)."""
        shape, _, device, _ = self._spec
        side = shape[-1]
        r = (np.arange(side, dtype=np.float32) - side / 2) / (side / 32)
        g = np.exp(-0.5 * r * r).astype(np.float32)
        blob = np.broadcast_to(g[:, None] * g[None, :], shape).copy()
        return torch.from_numpy(blob).to(device)

    @functools.cached_property
    def shear(self) -> tuple[torch.Tensor, ...]:
        """A shear layer (``_shear_velocities``)."""
        shape, ndim, device, _ = self._spec
        return tuple(torch.from_numpy(f).to(device) for f in
                     _shear_velocities(shape, ndim, self.n))


def _smooth_velocities(rng, shape: tuple[int, ...], ndim: int, n: int,
                       cells: float = 2.0) -> list[np.ndarray]:
    """``ndim`` velocity components on ``shape`` (grids on the last
    ``ndim`` axes, a batch before them): each a sum of three sine modes of
    wave numbers 1-3 per axis over the grid, a phase per mode and grid,
    scaled so that the backtrace moves at most ``cells`` cells."""
    side = shape[-1]
    axes = np.meshgrid(*[np.arange(side, dtype=np.float32) / side] * ndim,
                       indexing="ij")
    batch = shape[:-ndim]
    out = []
    for _ in range(ndim):
        f = np.zeros(shape, np.float32)
        for _ in range(3):
            k = rng.integers(1, 4, ndim)
            phase = rng.uniform(0.0, 2 * np.pi, batch + (1,) * ndim)
            arg = 2 * np.pi * sum(kk * a for kk, a in zip(k, axes))
            f += np.sin(arg + phase.astype(np.float32))
        f *= np.float32(cells / (DT * n)) / np.abs(f).max()
        out.append(f)
    return out


def _shear_velocities(shape: tuple[int, ...], ndim: int,
                      n: int) -> list[np.ndarray]:
    """A shear layer: every component moves the backtrace ``c`` =
    min(16, side // 2) cells one way above row side // 2 + 3 (the last axis
    but one) and ``c`` cells the other way below it, a jump of 2c cells
    across one row, so the blocks of K4 astride it gather from boxes past
    its cap (``footprint_boxes``)."""
    side = shape[-1]
    cells = min(16, side // 2)
    rows = np.arange(side).reshape((side, 1))
    sign = np.where(rows < side // 2 + 3, 1.0, -1.0).astype(np.float32)
    f = np.broadcast_to(sign * np.float32(cells / (DT * n)), shape)
    return [np.ascontiguousarray(f) for _ in range(ndim)]


JAC = ("jacobi_sweeps",)
DAMP = ("jacobi_sweeps_damp",)
PROJ = ("divergence", "jacobi_sweeps", "gradient")
DENS = ("jacobi_sweeps", "dens_advect")
TAIL = ("advect_project",)
CMAX = 4  # SimConfig.max_courant's default: the windowed step's window


def kernel_checks(side: int, device, seed: int = 0) -> list[Check]:
    """Every wrapper of the 2-D step in every mode the step uses, at grid
    ``side``: 20 parity sweeps, and the compensated perf mode's
    (rho, k_d, k_p) = (0.9, 10, 14); the gathers exact and windowed (4
    cells, under and over the window; the pair also at 1 cell); and K17,
    the fused velocity tail, at 20 parity sweeps with windows of 1 and 4
    cells, at the compensated mode's Chebyshev pressure solve, and on a
    batch of two grids."""
    t = _Inputs(side, device, seed)
    n, av, ad = t.n, t.a_visc, t.a_diff
    iters, (rho, k_d, k_p) = 20, PERF_POINTS_2D[2048]
    modes = {
        "jacobi": dict(),
        "src_dt": dict(src_dt=DT),
        "zero_init": dict(zero_init=True),
        "fast": dict(src_dt=DT, fast=True),
        "chebyshev": dict(src_dt=DT, cheby_rho=rho),
        "chebyshev+fast": dict(src_dt=DT, cheby_rho=rho, fast=True),
        "damped": dict(damp=OMEGA),
    }
    out = []
    for b in (0, 1, 2):
        for mode, kw in modes.items():
            k = k_d if "cheby_rho" in kw else iters
            out.append(_check(f"fused_jacobi b={b} {mode} {k}it",
                              DAMP if "damp" in kw else JAC,
                              co.fused_jacobi, co.fused_jacobi_plain, b, t.x,
                              t.x0, av, 1 + 4 * av, k, **kw))
    return out + [
        _check("divergence_p", ("divergence",), co.divergence_p,
               co.divergence_p_plain, t.u, t.v, n),
        _check("gradient_p", ("gradient",), co.gradient_p,
               co.gradient_p_plain, t.u, t.v, t.p, n),
        _check(f"fused_project jacobi {iters}it", PROJ, co.fused_project,
               co.fused_project_plain, t.u, t.v, n, iters),
        _check(f"fused_project chebyshev {k_p}it", PROJ, co.fused_project,
               co.fused_project_plain, t.u, t.v, n, k_p, cheby_rho=rho),
        _check("advect_shift b=0", ("advect",), co.advect_shift,
               co.advect_shift_plain, 0, t.x, t.u, t.v, DT, n),
        _check("advect_shift_fused u/v pair", ("advect",),
               co.advect_shift_fused, co.advect_shift_fused_plain, (1, 2),
               (t.u, t.v), t.u, t.v, DT, n),
        _check(f"fused_dens_advect jacobi {iters}it", DENS,
               co.fused_dens_advect, co.fused_dens_advect_plain, 0, t.src,
               t.x0, t.u, t.v, ad, 1 + 4 * ad, iters, DT, n),
        _check(f"fused_dens_advect chebyshev+fast {k_d}it", DENS,
               co.fused_dens_advect, co.fused_dens_advect_plain, 0, t.src,
               t.x0, t.u, t.v, ad, 1 + 4 * ad, k_d, DT, n, fast=True,
               cheby_rho=rho),
    ] + [
        _check(f"advect_shift b=0 cmax={CMAX}, {window} the window",
               ("advect",), co.advect_shift, co.advect_shift_plain, 0, t.x,
               u, v, DT, n, CMAX)
        for window, (u, v) in (("under", (t.u, t.v)), ("over", (t.uf, t.vf)))
    ] + [
        _check(f"advect_shift_fused u/v pair cmax={cmax}", ("advect",),
               co.advect_shift_fused, co.advect_shift_fused_plain, (1, 2),
               (u, v), u, v, DT, n, cmax)
        for cmax, (u, v) in ((1, (t.u, t.v)), (CMAX, (t.uf, t.vf)))
    ] + [
        _check(f"fused_dens_advect jacobi {iters}it cmax={CMAX}, over the "
               f"window", DENS, co.fused_dens_advect,
               co.fused_dens_advect_plain, 0, t.src, t.x0, t.uf, t.vf, ad,
               1 + 4 * ad, iters, DT, n, cmax=CMAX),
        _check(f"fused_dens_advect chebyshev+fast {k_d}it cmax={CMAX}", DENS,
               co.fused_dens_advect, co.fused_dens_advect_plain, 0, t.src,
               t.x0, t.uf, t.vf, ad, 1 + 4 * ad, k_d, DT, n, cmax=CMAX,
               fast=True, cheby_rho=rho),
        _check(f"fused_advect_project {iters}it cmax=1", TAIL,
               cst.fused_advect_project, cst.fused_advect_project_plain, t.u,
               t.v, n, iters, DT, cmax=1),
        _check(f"fused_advect_project {iters}it cmax={CMAX}, over the "
               f"window", TAIL, cst.fused_advect_project,
               cst.fused_advect_project_plain, t.uf, t.vf, n, iters, DT,
               cmax=CMAX),
        _check(f"fused_advect_project chebyshev {k_p}it cmax={CMAX}", TAIL,
               cst.fused_advect_project, cst.fused_advect_project_plain,
               t.uf, t.vf, n, k_p, DT, cmax=CMAX, cheby_rho=rho),
        _check(f"fused_advect_project batch of 2, {iters}it cmax=2", TAIL,
               cst.fused_advect_project, cst.fused_advect_project_plain,
               torch.stack([t.u, t.uf]), torch.stack([t.v, t.vf]), n, iters,
               DT, cmax=2),
        # The form the launch did not choose for one grid: the streaming
        # one, which larger grids and batches take.
        _check(f"fused_advect_project streaming form {iters}it cmax={CMAX}, "
               f"over the window", TAIL, cst.fused_advect_project,
               cst.fused_advect_project_plain, t.uf, t.vf, n, iters, DT,
               cmax=CMAX, form="streaming"),
        _check(f"fused_advect_project streaming form chebyshev {k_p}it "
               f"cmax={CMAX}", TAIL, cst.fused_advect_project,
               cst.fused_advect_project_plain, t.uf, t.vf, n, k_p, DT,
               cmax=CMAX, cheby_rho=rho, form="streaming"),
    ]


def _unfused_density(t: "_Inputs", src, base, u, v, cmax=None):
    """The density step K4 stands for, unfused: K1's 20 sweeps, then K3."""
    def run():
        d = co.fused_jacobi(0, src, base, t.a_diff, 1 + 4 * t.a_diff, 20,
                            src_dt=DT)
        return co.advect_shift(0, d, u, v, DT, t.n, cmax)
    return run


def _dens_timed(t: "_Inputs", label: str, u, v, iters: int, cmax=None,
                fields=None) -> Check:
    """K4's wrapper at ``iters`` parity sweeps (one launch of K4 alone for
    ``iters=1``; at 20, beside the unfused step, K1 20it + K3) on the
    source and base ``fields`` (``t.src``, ``t.x0`` by default)."""
    ad = t.a_diff
    src, base = fields or (t.src, t.x0)
    cost = _function(DENS_ADVECT[0], _sweeps_cost(iters - 1, 2, src=True),
                     DENS_ADVECT)
    make = _k1_timed if iters > 1 else _timed
    check = make(cost, t.cells, label,
                   ("dens_advect",) if iters == 1 else DENS,
                   co.fused_dens_advect, co.fused_dens_advect_plain, 0, src,
                   base, u, v, ad, 1 + 4 * ad, iters, DT, t.n, cmax=cmax)
    check.boxes = functools.partial(footprint_boxes, (u, v), t.n, cmax)
    if iters == 20:
        check.composed = _unfused_density(t, src, base, u, v, cmax)
    return check


def _gather2(fields, u, v, n: int, cmax=None):
    """A 2-D gather's fields and departure coordinates (``Check.gather``)."""
    return lambda: (list(fields), backtrace(u, v, DT, n, cmax))


def _gather3(fields, u, v, w, n: int, cmax=None):
    """A 3-D gather's fields and departure coordinates (``Check.gather``)."""
    return lambda: (list(fields), backtrace3(u, v, w, DT, n, cmax))


def timing_checks(side: int, device, seed: int = 0) -> list[Check]:
    """What ``chip_smoke.py`` times: first one launch of each CUDA kernel
    (labelled by the kernel's name; the tiled K1's runs T sweeps, the
    per-sweep K1's one) beside its plain version, then each wrapper at the
    main path's iteration counts, each with K1 solves in it beside the
    same call on the per-sweep K1 (``chain``); K4 also on smooth and shear
    velocities, and at 20 sweeps beside the unfused density step (K1 then
    K3), also on a density blob."""
    t = _Inputs(side, device, seed)
    n, av, ad, cells = t.n, t.a_visc, t.a_diff, t.cells
    bv, bd = 1 + 4 * av, 1 + 4 * ad
    rho, k_d, k_p = PERF_POINTS_2D[2048]
    us, vs = t.smooth
    per_launch = co.SWEEPS_PER_LAUNCH

    def sweeps(iters, **kw):
        return _sweeps_cost(iters, 2, **kw)

    advect = _timed(ADVECT2_PAIR, cells, "advect", ("advect",),
                    co.advect_shift_fused, co.advect_shift_fused_plain,
                    (1, 2), (t.u, t.v), t.u, t.v, DT, n)
    advect.gather = _gather2((t.u, t.v), t.u, t.v, n)
    return [
        _k1_timed(sweeps(per_launch), cells, "jacobi_sweeps", JAC,
                  co.fused_jacobi, co.fused_jacobi_plain, 1, t.x, t.x0, av,
                  bv, per_launch),
        _timed(sweeps(1), cells, "jacobi_sweep", ("jacobi_sweep",),
               functools.partial(_per_sweep, co.fused_jacobi),
               co.fused_jacobi_plain, 1, t.x, t.x0, av, bv, 1),
        _timed(DIV2, cells, "divergence", ("divergence",), co.divergence_p,
               co.divergence_p_plain, t.u, t.v, n),
        _timed(GRAD2, cells, "gradient", ("gradient",), co.gradient_p,
               co.gradient_p_plain, t.u, t.v, t.p, n),
        advect,
        _dens_timed(t, "dens_advect", t.u, t.v, 1),
        _dens_timed(t, "dens_advect smooth velocities", us, vs, 1),
        _dens_timed(t, "dens_advect shear velocities", *t.shear, 1),
        _k1_timed(sweeps(20, src=True), cells,
                  "fused_jacobi 20it src_dt (u diffusion)", JAC,
                  co.fused_jacobi, co.fused_jacobi_plain, 1, t.src, t.x0, av,
                  bv, 20, src_dt=DT),
        _k1_timed(sweeps(20, zero_init=True), cells,
                  "fused_jacobi 20it zero_init (pressure)", JAC,
                  co.fused_jacobi, co.fused_jacobi_plain, 0, t.p, t.p, 1.0,
                  4.0, 20, zero_init=True),
        _k1_timed(sweeps(k_d, src=True, fast=True, cheby=True), cells,
                  f"fused_jacobi {k_d}it chebyshev+fast", JAC,
                  co.fused_jacobi, co.fused_jacobi_plain, 1, t.src, t.x0, av,
                  bv, k_d, src_dt=DT, fast=True, cheby_rho=rho),
        _k1_timed(_project(sweeps(20, zero_init=True)), cells,
                  "fused_project 20it", PROJ, co.fused_project,
                  co.fused_project_plain, t.u, t.v, n, 20),
        _k1_timed(_project(sweeps(k_p, zero_init=True, cheby=True)), cells,
                  f"fused_project {k_p}it chebyshev", PROJ, co.fused_project,
                  co.fused_project_plain, t.u, t.v, n, k_p, cheby_rho=rho),
        _dens_timed(t, "fused_dens_advect 20it", t.u, t.v, 20),
        _dens_timed(t, "fused_dens_advect 20it smooth velocities", us, vs,
                    20),
        _dens_timed(t, "fused_dens_advect 20it smooth velocities, a density "
                    "blob", us, vs, 20, fields=(torch.zeros_like(t.blob),
                                                t.blob)),
        _k1_timed(_function(DENS_ADVECT[0],
                            sweeps(k_d - 1, src=True, fast=True, cheby=True),
                            DENS_ADVECT), cells,
                  f"fused_dens_advect {k_d}it chebyshev+fast", DENS,
                  co.fused_dens_advect, co.fused_dens_advect_plain, 0, t.src,
                  t.x0, t.u, t.v, ad, bd, k_d, DT, n, fast=True,
                  cheby_rho=rho),
    ]


# (sweeps, zero_init) of the multigrid cycle's smoothing calls: the pre- and
# post-smooth of a level from a guess, the first pre-smooth of a level
# from zero, the coarsest level's 40 sweeps from zero.
MG_SMOOTHS = ((2, False), (2, True), (40, True))


def _damp_cost(sweeps: int, zero_init: bool) -> tuple[float, int]:
    return _sweeps_cost(sweeps, 2, zero_init=zero_init, damp=True)


# K1-damp's bf16-rhs calls (sweeps, the guess): the finest level of a bf16
# multigrid solve, its first pre-smooth from zero and its later smooths
# from the float32 iterate; below 16² the whole one-level solve from zero
# and, in the second cycle, from its bf16 result.
MG_SMOOTHS_BF16 = ((2, "zero"), (2, "float32"), (40, "zero"), (40, "bf16"))
DAMP_BF16 = ("jacobi_sweeps_damp_bf16",)


def _damp_bf16_cost(sweeps: int, guess: str) -> tuple[float, int]:
    """A bf16-rhs smooth's cost: the bf16 rhs read (half a float32 pass),
    the guess read (none from zero) and the result written in the guess's
    dtype; 4 bytes a cell from zero, 10 from a float32 guess."""
    store = {"zero": 0.5, "bf16": 0.5, "float32": 1.0}[guess]
    return ((0.0 if guess == "zero" else store) + 0.5 + store,
            sum(_sweep_ops(sweeps, 2, damp=True)))


def _damp_bf16_check(t: "_Inputs", label: str, sweeps: int,
                     guess: str) -> Check:
    rhs = t.x0.to(torch.bfloat16)
    x = t.x.to(torch.bfloat16) if guess == "bf16" else t.x
    return _timed(_damp_bf16_cost(sweeps, guess), t.cells, label, DAMP_BF16,
                  co.mg_smooth, co.mg_smooth_plain, x, rhs, sweeps,
                  guess == "zero")


def kernel_checks_damp(side: int, device, seed: int = 0,
                       batch: int = 0, bf16: bool = False) -> list[Check]:
    """K1-damp (B1's ``damp``, the multigrid smoother, in the launches of
    ``cuda_ops.damped_plan``) against the plain multigrid smoother
    ``ops.multigrid._smooth`` at grid ``side`` (a batch of ``batch``
    grids), in the calls a V-cycle makes (``MG_SMOOTHS``), each carrying
    the same call on the per-sweep damped K1 (``chain``); with
    ``--fmad=false`` all three agree bit for bit.  ``bf16``: instead its
    bf16-rhs forms in the calls of ``MG_SMOOTHS_BF16``, each against its
    plain twin ``cuda_ops.mg_smooth_plain`` (no chain: the per-sweep damped
    K1 has no bf16 form)."""
    t = _Inputs(side, device, seed, batch=batch)
    size = f"{batch} × {side}²" if batch else f"{side}²"
    if bf16:
        return [_damp_bf16_check(t, f"{size} damped jacobi {k} sweeps bf16 "
                                 f"rhs, {g} guess", k, g)
                for k, g in MG_SMOOTHS_BF16]
    return [_k1_timed(_damp_cost(k, z), t.cells,
                      f"{size} damped jacobi {k} sweeps"
                      f"{' zero_init' if z else ''}", DAMP, co.mg_smooth,
                      _smooth, t.x, t.x0, k, z) for k, z in MG_SMOOTHS]


def timing_checks_damp(side: int, device, seed: int = 0,
                       batch: int = 0, bf16: bool = False) -> list[Check]:
    """What ``chip_smoke.py`` times of K1-damp at grid ``side`` (a batch
    of ``batch`` grids): the path's launch of a 2-sweep smooth from a guess
    (labelled by its count's name), then the cycle's smoothing calls of
    ``MG_SMOOTHS`` (``kernel_checks_damp``), each beside ``_smooth`` and
    the per-sweep damped K1.  ``bf16``: the bf16-rhs forms' 2-sweep smooth
    from a float32 guess (the path's most launched, labelled by the
    count's name), then the calls of ``MG_SMOOTHS_BF16``."""
    t = _Inputs(side, device, seed, batch=batch)
    if bf16:
        return [_damp_bf16_check(t, "jacobi_sweeps_damp_bf16", 2, "float32")
                ] + kernel_checks_damp(side, device, seed, batch, bf16=True)
    return [_k1_timed(_damp_cost(2, False), t.cells, "jacobi_sweeps_damp",
                      DAMP, co.mg_smooth, _smooth, t.x, t.x0, 2)
            ] + kernel_checks_damp(side, device, seed, batch)


def _tail_timed(t: "_Inputs", label: str, u, v, cmax: int, k: int,
                cheby_rho=None, form=None) -> Check:
    """K17 on ``t``'s grid or batch beside the composition it replaces.
    The bound counts the function's own traffic, u and v read once and the
    projected pair written once."""
    n = t.n
    sweep_ops = _sweeps_cost(k, 2, zero_init=True,
                             cheby=cheby_rho is not None)[1]
    check = _timed(
        (4, ADVECT2_PAIR[1] + DIV2[1] + sweep_ops + GRAD2[1]), t.cells,
        label, TAIL, cst.fused_advect_project,
        cst.fused_advect_project_plain, u, v, n, k, DT, cmax=cmax,
        cheby_rho=cheby_rho, form=form)
    check.composed = lambda: co.fused_project(
        *co.advect_shift_fused((1, 2), (u, v), u, v, DT, n, cmax), n, k,
        cheby_rho=cheby_rho)
    return check


def timing_checks_tail(side: int, device, seed: int = 0) -> list[Check]:
    """What ``chip_smoke.py`` times of K17 at grid ``side``, in the form the
    launch chooses and each beside the composition it replaces (K3's
    windowed pair, then ``fused_project``): 20 parity sweeps with the
    step's 4-cell window on velocities that cross it (labelled by the
    kernel's name), with JAX's measured 1-cell window, and the compensated
    mode's 14-sweep Chebyshev pressure solve; then the first and the last
    in the streaming form."""
    t = _Inputs(side, device, seed)
    iters = 20
    rho, _, k_p = PERF_POINTS_2D[2048]
    return [
        _tail_timed(t, "advect_project", t.uf, t.vf, CMAX, iters),
        _tail_timed(t, f"fused_advect_project {iters}it cmax=1", t.u, t.v, 1,
                    iters),
        _tail_timed(t, f"fused_advect_project chebyshev {k_p}it "
                    f"cmax={CMAX}", t.uf, t.vf, CMAX, k_p, rho),
        _tail_timed(t, f"fused_advect_project streaming form {iters}it "
                    f"cmax={CMAX}", t.uf, t.vf, CMAX, iters,
                    form="streaming"),
        _tail_timed(t, f"fused_advect_project streaming form chebyshev "
                    f"{k_p}it cmax={CMAX}", t.uf, t.vf, CMAX, k_p, rho,
                    form="streaming"),
    ]


def timing_checks_tail_batched(nb: int, side: int, device,
                               seed: int = 0) -> list[Check]:
    """K17 on a batch of ``nb`` grids of ``side`` (the datagen batch takes
    the streaming form), 20 parity sweeps and the 14-sweep Chebyshev solve
    in a 1-cell window (the batched step's probed window at that size),
    each beside the composition it replaces."""
    t = _Inputs(side, device, seed, batch=nb)
    rho, _, k_p = PERF_POINTS_2D[2048]
    tag = f"{nb} x {side}²"
    return [
        _tail_timed(t, f"{tag} fused_advect_project 20it cmax=1", t.u, t.v,
                    1, 20),
        _tail_timed(t, f"{tag} fused_advect_project chebyshev {k_p}it "
                    f"cmax=1", t.u, t.v, 1, k_p, rho),
    ]


def _batched_cases(t: "_Inputs", cmax: int) -> list[tuple]:
    """(label, kernels, wrapper, plain version, args, kwargs) of every 2-D
    wrapper call of ``kernel_checks_batched`` on the batched inputs ``t``."""
    n, av, ad = t.n, t.a_visc, t.a_diff
    bv, bd = 1 + 4 * av, 1 + 4 * ad
    rho, k_d, k_p = PERF_POINTS_2D[2048]
    return [
        ("fused_jacobi 1 sweep", JAC, co.fused_jacobi, co.fused_jacobi_plain,
         (1, t.x, t.x0, av, bv, 1), {}),
        ("fused_jacobi 20it src_dt", JAC, co.fused_jacobi,
         co.fused_jacobi_plain, (1, t.src, t.x0, av, bv, 20),
         dict(src_dt=DT)),
        ("fused_jacobi 20it zero_init", JAC, co.fused_jacobi,
         co.fused_jacobi_plain, (0, t.p, t.p, 1.0, 4.0, 20),
         dict(zero_init=True)),
        (f"fused_jacobi {k_d}it chebyshev+fast", JAC, co.fused_jacobi,
         co.fused_jacobi_plain, (2, t.src, t.x0, av, bv, k_d),
         dict(src_dt=DT, fast=True, cheby_rho=rho)),
        ("fused_jacobi_pair u/v 20it src_dt", JAC, co.fused_jacobi_pair,
         co.fused_jacobi_pair_plain, _pair_args(t), dict(src_dt=DT)),
        ("fused_project 20it", PROJ, co.fused_project,
         co.fused_project_plain, (t.u, t.v, n, 20), {}),
        (f"fused_project chebyshev {k_p}it", PROJ, co.fused_project,
         co.fused_project_plain, (t.u, t.v, n, k_p), dict(cheby_rho=rho)),
        ("divergence_p", ("divergence",), co.divergence_p,
         co.divergence_p_plain, (t.u, t.v, n), {}),
        ("gradient_p", ("gradient",), co.gradient_p, co.gradient_p_plain,
         (t.u, t.v, t.p, n), {}),
        ("advect_shift_fused u/v pair", ("advect",), co.advect_shift_fused,
         co.advect_shift_fused_plain, ((1, 2), (t.u, t.v), t.u, t.v, DT, n),
         {}),
        (f"advect_shift_fused u/v pair cmax={cmax}", ("advect",),
         co.advect_shift_fused, co.advect_shift_fused_plain,
         ((1, 2), (t.u, t.v), t.u, t.v, DT, n, cmax), {}),
        ("advect_shift b=0", ("advect",), co.advect_shift,
         co.advect_shift_plain, (0, t.x, t.u, t.v, DT, n), {}),
        (f"fused_dens_advect 20it cmax={cmax}", DENS, co.fused_dens_advect,
         co.fused_dens_advect_plain,
         (0, t.src, t.x0, t.u, t.v, ad, bd, 20, DT, n), dict(cmax=cmax)),
        (f"fused_dens_advect chebyshev+fast {k_d}it cmax={cmax}", DENS,
         co.fused_dens_advect, co.fused_dens_advect_plain,
         (0, t.src, t.x0, t.u, t.v, ad, bd, k_d, DT, n),
         dict(cmax=cmax, fast=True, cheby_rho=rho)),
    ]


def kernel_checks_batched(nb: int, side: int, device, seed: int = 0,
                          cmax: int = 1) -> list[Check]:
    """Every 2-D wrapper on a batch of ``nb`` grids at ``side``, at the
    counts and coefficients of the batched datagen step: K1 one sweep, the
    20-sweep velocity solve with its source fold, the zero-guess pressure
    solve, the compensated point's 10-sweep Chebyshev+fast solve; the u/v
    pair (``fused_jacobi_pair``, the batch stacked twice); ``fused_project``
    at 20 sweeps and at the 14-sweep Chebyshev solve; K2's two stencils;
    K3 on the u/v pair exact and in the window of ``cmax`` cells, and on
    one field; K4 at 20 sweeps and at 10 Chebyshev+fast sweeps, in the
    window."""
    t = _Inputs(side, device, seed, batch=nb)
    return [_check(f"{nb}x{side}² {label}", kernels, fn, plain, *args, **kw)
            for label, kernels, fn, plain, args, kw in _batched_cases(t, cmax)]


def _grid(x, g: int):
    """Grid ``g`` of a batched operand (tensors, tuples of them); other
    arguments as they are."""
    if isinstance(x, torch.Tensor):
        return x[g]
    if isinstance(x, tuple):
        return tuple(_grid(y, g) for y in x)
    return x


def _per_grid(nb: int, fn, *args, **kw):
    """``fn`` called on each grid of a batch alone, results stacked."""
    outs = [fn(*(_grid(a, g) for a in args), **kw) for g in range(nb)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def batched_against_grids(nb: int, side: int, device, seed: int = 0,
                          cmax: int = 1) -> list[Check]:
    """The calls of ``kernel_checks_batched``, each against the same
    wrapper called on every grid of the batch alone (equal bit for bit:
    a batch changes which grids a launch covers, not any cell's
    arithmetic)."""
    t = _Inputs(side, device, seed, batch=nb)
    return [_check(f"{label} vs per grid", kernels, fn,
                   functools.partial(_per_grid, nb, fn), *args, **kw)
            for label, kernels, fn, _, args, kw in _batched_cases(t, cmax)]


def timing_checks_batched(nb: int, side: int, device, seed: int = 0,
                          cmax: int = 1) -> list[Check]:
    """What ``chip_smoke.py`` times on a batch of ``nb`` grids at ``side``
    (the batched datagen step's shapes): one launch of each of K1-K4
    beside its plain version (K4 also on smooth velocities, and exact on
    shear velocities), then each wrapper at the step's counts (K4 at 20
    sweeps on random and smooth velocities, beside K1 20it + K3), K1's
    solves beside the per-sweep K1 (``chain``).  The bound counts every
    grid of the batch."""
    t = _Inputs(side, device, seed, batch=nb)
    n, av, ad, cells = t.n, t.a_visc, t.a_diff, t.cells
    bv, bd = 1 + 4 * av, 1 + 4 * ad
    rho, k_d, k_p = PERF_POINTS_2D[2048]
    tag = f"{nb}x{side}²"
    per_launch = co.SWEEPS_PER_LAUNCH

    def sweeps(iters, **kw):
        return _sweeps_cost(iters, 2, **kw)

    advect = _timed(ADVECT2_PAIR, cells,
                    f"{tag} advect (u/v pair cmax={cmax})", ("advect",),
                    co.advect_shift_fused, co.advect_shift_fused_plain,
                    (1, 2), (t.u, t.v), t.u, t.v, DT, n, cmax)
    advect.gather = _gather2((t.u, t.v), t.u, t.v, n, cmax)
    return [
        _k1_timed(sweeps(per_launch), cells, f"{tag} jacobi_sweeps", JAC,
                  co.fused_jacobi, co.fused_jacobi_plain, 1, t.x, t.x0, av,
                  bv, per_launch),
        _timed(sweeps(1), cells, f"{tag} jacobi_sweep", ("jacobi_sweep",),
               functools.partial(_per_sweep, co.fused_jacobi),
               co.fused_jacobi_plain, 1, t.x, t.x0, av, bv, 1),
        _timed(DIV2, cells, f"{tag} divergence", ("divergence",),
               co.divergence_p, co.divergence_p_plain, t.u, t.v, n),
        _timed(GRAD2, cells, f"{tag} gradient", ("gradient",), co.gradient_p,
               co.gradient_p_plain, t.u, t.v, t.p, n),
        advect,
        _dens_timed(t, f"{tag} dens_advect (cmax={cmax})", t.u, t.v, 1,
                    cmax),
        _dens_timed(t, f"{tag} dens_advect (cmax={cmax}) smooth velocities",
                    *t.smooth, 1, cmax),
        _dens_timed(t, f"{tag} dens_advect exact, shear velocities",
                    *t.shear, 1),
        _k1_timed(sweeps(20, src=True), cells,
                  f"{tag} fused_jacobi 20it src_dt", JAC, co.fused_jacobi,
                  co.fused_jacobi_plain, 1, t.src, t.x0, av, bv, 20,
                  src_dt=DT),
        _k1_timed(sweeps(k_d, src=True, fast=True, cheby=True), cells,
                  f"{tag} fused_jacobi {k_d}it chebyshev+fast", JAC,
                  co.fused_jacobi, co.fused_jacobi_plain, 1, t.src, t.x0, av,
                  bv, k_d, src_dt=DT, fast=True, cheby_rho=rho),
        _k1_timed(_project(sweeps(20, zero_init=True)), cells,
                  f"{tag} fused_project 20it", PROJ, co.fused_project,
                  co.fused_project_plain, t.u, t.v, n, 20),
        _k1_timed(_project(sweeps(k_p, zero_init=True, cheby=True)), cells,
                  f"{tag} fused_project {k_p}it chebyshev", PROJ,
                  co.fused_project, co.fused_project_plain, t.u, t.v, n, k_p,
                  cheby_rho=rho),
        _dens_timed(t, f"{tag} fused_dens_advect 20it cmax={cmax}", t.u,
                    t.v, 20, cmax),
        _dens_timed(t, f"{tag} fused_dens_advect 20it cmax={cmax} smooth "
                    f"velocities", *t.smooth, 20, cmax),
    ]


# The CUDA kernels of the bf16 wrappers (cuda_ops: each bf16 form counts
# under its own name).
JAC16 = ("jacobi_sweeps_bf16",)
PROJ16 = ("divergence_bf16", "jacobi_sweeps", "gradient_bf16")


class _Bf16Inputs:
    """``_Inputs``'s fields rounded to bf16 (a batch of ``batch`` grids if
    given), with the step's coefficients; ``p32`` keeps a float32
    pressure for the gradient's fused_project form."""

    def __init__(self, side: int, device, seed: int, batch: int = 0):
        t = _Inputs(side, device, seed, batch=batch)
        self.n, self.cells = t.n, t.cells
        self.a_visc, self.a_diff = t.a_visc, t.a_diff
        for name in ("x", "x0", "src", "p", "u", "v", "uf", "vf"):
            setattr(self, name, getattr(t, name).to(torch.bfloat16))
        self.p32 = t.p


def _bf16_cases(t: "_Bf16Inputs") -> list[tuple]:
    """(label, kernels, wrapper, plain version, args, kwargs) of every bf16
    wrapper call of ``kernel_checks_bf16``."""
    n, av = t.n, t.a_visc
    bv = 1 + 4 * av
    rho, k_d, k_p = PERF_POINTS_2D[2048]
    f32 = torch.float32
    return [
        ("fused_jacobi 1 sweep", JAC16, co.fused_jacobi,
         co.fused_jacobi_plain, (1, t.x, t.x0, av, bv, 1), {}),
        ("fused_jacobi 20it src_dt", JAC16, co.fused_jacobi,
         co.fused_jacobi_plain, (1, t.src, t.x0, av, bv, 20),
         dict(src_dt=DT)),
        ("fused_jacobi 20it src_dt fast", JAC16, co.fused_jacobi,
         co.fused_jacobi_plain, (2, t.src, t.x0, av, bv, 20),
         dict(src_dt=DT, fast=True)),
        ("fused_jacobi 20it zero_init (pressure_solve)", JAC16,
         co.fused_jacobi, co.fused_jacobi_plain, (0, t.p, t.p, 1.0, 4.0, 20),
         dict(zero_init=True)),
        ("fused_jacobi 2it chebyshev", JAC16, co.fused_jacobi,
         co.fused_jacobi_plain, (1, t.src, t.x0, av, bv, 2),
         dict(src_dt=DT, cheby_rho=rho)),
        (f"fused_jacobi {k_d}it chebyshev", JAC16, co.fused_jacobi,
         co.fused_jacobi_plain, (1, t.src, t.x0, av, bv, k_d),
         dict(src_dt=DT, cheby_rho=rho)),
        (f"fused_jacobi {k_d}it chebyshev+fast", JAC16, co.fused_jacobi,
         co.fused_jacobi_plain, (2, t.src, t.x0, av, bv, k_d),
         dict(src_dt=DT, fast=True, cheby_rho=rho)),
        ("fused_project 20it", PROJ16, co.fused_project,
         co.fused_project_plain, (t.u, t.v, n, 20), {}),
        (f"fused_project chebyshev {k_p}it", PROJ16, co.fused_project,
         co.fused_project_plain, (t.u, t.v, n, k_p), dict(cheby_rho=rho)),
        ("divergence into float32 (fused_project's)", ("divergence_bf16",),
         co._divergence, co._divergence_plain, (t.u, t.v, n, f32), {}),
        ("divergence_p", ("divergence_bf16",), co.divergence_p,
         co.divergence_p_plain, (t.u, t.v, n), {}),
        ("gradient, float32 p (fused_project's)", ("gradient_bf16",),
         co.gradient_p, co.gradient_p_plain, (t.u, t.v, t.p32, n), {}),
        ("gradient_p", ("gradient_bf16",), co.gradient_p,
         co.gradient_p_plain, (t.u, t.v, t.p, n), {}),
        ("advect_shift_fused u/v pair", ("advect_bf16",),
         co.advect_shift_fused, co.advect_shift_fused_plain,
         ((1, 2), (t.u, t.v), t.u, t.v, DT, n), {}),
        ("advect_shift b=0", ("advect_bf16",), co.advect_shift,
         co.advect_shift_plain, (0, t.x, t.u, t.v, DT, n), {}),
        (f"advect_shift b=0 cmax={CMAX}, over the window", ("advect_bf16",),
         co.advect_shift, co.advect_shift_plain,
         (0, t.x, t.uf, t.vf, DT, n, CMAX), {}),
        ("advect_shift_fused u/v pair cmax=1", ("advect_bf16",),
         co.advect_shift_fused, co.advect_shift_fused_plain,
         ((1, 2), (t.u, t.v), t.u, t.v, DT, n, 1), {}),
    ]


def kernel_checks_bf16(side: int, device, seed: int = 0,
                       batch: int = 0) -> list[Check]:
    """Every bf16 form of K1-K3 against its plain version at grid ``side``
    (a batch of ``batch`` grids if given), in the calls the bf16 step makes
    and the standalone forms: K1 one sweep (bf16 in and out in one
    launch), the 20-sweep velocity solve with its source fold (plain and
    fast), the zero-guess pressure solve on a bf16 rhs, Chebyshev at 2
    sweeps (the guess read as x_{k-1}) and at the compensated point's 10
    (plain and fast); ``fused_project`` at 20 and Chebyshev 14 sweeps; K2's
    divergence into float32 and into bf16, its gradient from a float32 and
    from a bf16 pressure; K3 on the u/v pair, exact and at a 1-cell window,
    and on one field, exact and over a 4-cell window.  Expected bit for
    bit: kernel and plain version do the same float32 arithmetic and round
    once."""
    t = _Bf16Inputs(side, device, seed, batch)
    tag = f"{batch}x{side}² " if batch else ""
    return [_check(f"{tag}bf16 {label}", kernels, fn, plain, *args, **kw)
            for label, kernels, fn, plain, args, kw in _bf16_cases(t)]


def timing_checks_bf16(side: int, device, seed: int = 0,
                       batch: int = 0) -> list[Check]:
    """What ``chip_smoke.py`` times of the bf16 forms at grid ``side`` (a
    batch if given), each beside the same call in float32 on the same
    values and beside its plain version: first one launch of each form on
    the main path (labelled by its count's name: the tiled K1's T sweeps,
    the per-sweep K1's one sweep, K2's divergence into float32 and
    gradient from a float32 pressure, K3's u/v pair), then K2's standalone
    forms and the wrappers at the step's counts, K1's solves beside the
    per-sweep K1 (``chain``)."""
    t = _Bf16Inputs(side, device, seed, batch)
    w = _Inputs(side, device, seed, batch=batch)
    n, av, cells = t.n, t.a_visc, t.cells
    bv = 1 + 4 * av
    rho, k_d, k_p = PERF_POINTS_2D[2048]
    f32 = torch.float32
    tag = f"{batch}x{side}² " if batch else ""
    per_launch = co.SWEEPS_PER_LAUNCH
    chain = functools.partial(_per_sweep, co.fused_jacobi)

    def sweeps(iters, **kw):
        return _sweeps_cost(iters, 2, **kw)

    def pair(label, kernels, cost16, cost32, fn, plain, args16, args32,
             **kw):
        name = label if not tag else f"{tag}{label}"
        make = _k1_timed if any("jacobi_sweeps" in k for k in kernels) \
            else _timed
        return [make(cost16, cells, name, kernels, fn, plain, *args16, **kw),
                make(cost32, cells, f"{tag}{label} (float32)", (), fn, plain,
                     *args32, **kw)]

    advect = pair("advect_bf16", ("advect_bf16",), ADVECT2_PAIR_BF16,
                  ADVECT2_PAIR, co.advect_shift_fused,
                  co.advect_shift_fused_plain,
                  ((1, 2), (t.u, t.v), t.u, t.v, DT, n),
                  ((1, 2), (w.u, w.v), w.u, w.v, DT, n))
    advect[0].gather = _gather2((t.u, t.v), t.u, t.v, n)
    return (
        pair("jacobi_sweeps_bf16", JAC16, sweeps(per_launch, bf16=True),
             sweeps(per_launch), co.fused_jacobi, co.fused_jacobi_plain,
             (1, t.x, t.x0, av, bv, per_launch),
             (1, w.x, w.x0, av, bv, per_launch))
        + pair("jacobi_sweep_bf16", ("jacobi_sweep_bf16",),
               sweeps(1, bf16=True), sweeps(1), chain, co.fused_jacobi_plain,
               (1, t.x, t.x0, av, bv, 1), (1, w.x, w.x0, av, bv, 1))
        + pair("divergence_bf16", ("divergence_bf16",), DIV2_BF16, DIV2,
               co._divergence, co._divergence_plain, (t.u, t.v, n, f32),
               (w.u, w.v, n, f32))
        + pair("gradient_bf16", ("gradient_bf16",), GRAD2_BF16, GRAD2,
               co.gradient_p, co.gradient_p_plain, (t.u, t.v, t.p32, n),
               (w.u, w.v, w.p, n))
        + advect
        + pair("divergence_p bf16", ("divergence_bf16",), DIVP_BF16, DIV2,
               co.divergence_p, co.divergence_p_plain, (t.u, t.v, n),
               (w.u, w.v, n))
        + pair("gradient_p bf16", ("gradient_bf16",), GRADP_BF16, GRAD2,
               co.gradient_p, co.gradient_p_plain, (t.u, t.v, t.p, n),
               (w.u, w.v, w.p, n))
        + pair("fused_jacobi 20it src_dt bf16", JAC16,
               sweeps(20, src=True, bf16=True), sweeps(20, src=True),
               co.fused_jacobi, co.fused_jacobi_plain,
               (1, t.src, t.x0, av, bv, 20), (1, w.src, w.x0, av, bv, 20),
               src_dt=DT)
        + pair(f"fused_jacobi {k_d}it chebyshev+fast bf16", JAC16,
               sweeps(k_d, src=True, fast=True, cheby=True, bf16=True),
               sweeps(k_d, src=True, fast=True, cheby=True),
               co.fused_jacobi, co.fused_jacobi_plain,
               (1, t.src, t.x0, av, bv, k_d), (1, w.src, w.x0, av, bv, k_d),
               src_dt=DT, fast=True, cheby_rho=rho)
        + pair("fused_project 20it bf16", PROJ16,
               _project(sweeps(20, zero_init=True), bf16=True),
               _project(sweeps(20, zero_init=True)),
               co.fused_project, co.fused_project_plain, (t.u, t.v, n, 20),
               (w.u, w.v, n, 20))
        + pair(f"fused_project {k_p}it chebyshev bf16", PROJ16,
               _project(sweeps(k_p, zero_init=True, cheby=True), bf16=True),
               _project(sweeps(k_p, zero_init=True, cheby=True)),
               co.fused_project, co.fused_project_plain,
               (t.u, t.v, n, k_p), (w.u, w.v, n, k_p), cheby_rho=rho))


# The velocities K3's and K2's bf16 vector forms are held on (besides
# gather_velocities' three): one that moves every departure up to a grid
# side, so most land on the clamp, the walls' or the window's.
BF16_FORM_VELOCITIES = ("random", "smooth", "shear", "clamp")
# K3's fields: one field with each border mode, and the u/v pair.
BF16_FORM_FIELDS = ("b=0", "b=1", "b=2", "u/v pair")
# Every form of the two vector kernels, by kernel: the cells a thread,
# the path's widths (cuda_ops.VECTOR_WIDTHS) and 1, the one-cell kernel;
# cuda_ops.vector_widths((V,)) forces one.
BF16_FORMS = {name: co.VECTOR_WIDTHS[name] + (1,)
              for name in ("advect_bf16", "gradient_bf16")}


def kernel_checks_bf16_forms(side: int, device, seed: int = 0,
                             batch: int = 0,
                             velocities=BF16_FORM_VELOCITIES,
                             windows=(None, 1, CMAX)) -> list[Check]:
    """K3's bf16 form and K2's bf16 gradient (the vector kernels, in the
    width ``cuda_ops.vector_width`` gives ``side``, else the one-cell
    kernel) against their plain versions at grid ``side`` (a batch
    of ``batch`` grids if given): K3 on one field with each border mode and
    on the u/v pair, on each of ``velocities`` in each of ``windows``
    (None gathers exactly); the gradient from a float32 and from a bf16
    pressure.  Expected bit for bit.  ``cuda_ops.vector_widths`` forces
    another width."""
    t = _Inputs(side, device, seed, batch=batch)
    n = t.n
    bf = torch.bfloat16
    clamp = tuple(3.0 * (side / 6.0) * f for f in (t.uf, t.vf))
    flows = dict(gather_velocities(t), clamp=clamp)
    tag = (f"{batch}x" if batch else "") + f"{side}² bf16"
    x, p32 = t.x.to(bf), t.p
    out = []
    for name in velocities:
        u, v = (f.to(bf) for f in flows[name][:2])
        for cmax in windows:
            win = "exact" if cmax is None else f"cmax={cmax}"
            for fields in BF16_FORM_FIELDS:
                if fields == "u/v pair":
                    args = ((1, 2), (u, v), u, v, DT, n, cmax)
                else:
                    args = ((int(fields[-1]),), (x,), u, v, DT, n, cmax)
                out.append(_check(f"{tag} advect {fields} {win}, {name} "
                                  f"velocities", ("advect_bf16",),
                                  co.advect_shift_fused,
                                  co.advect_shift_fused_plain, *args))
    u, v = t.u.to(bf), t.v.to(bf)
    for label, p in (("float32 p", p32), ("bf16 p", p32.to(bf))):
        out.append(_check(f"{tag} gradient, {label}", ("gradient_bf16",),
                          co.gradient_p, co.gradient_p_plain, u, v, p, n))
    return out


def _k1_cases(t, bf16: bool) -> list[tuple]:
    """(label, kernels, wrapper, plain version, args, kwargs) of every call
    with a K1 solve in it: ``fused_jacobi`` in each mode the step runs
    (``kernel_checks``) and the calls of ``_batched_cases`` (float32) or
    ``_bf16_cases`` (bf16)."""
    if bf16:
        return [c for c in _bf16_cases(t)
                if any(k.startswith("jacobi_sweeps") for k in c[1])]
    av = t.a_visc
    rho, k_d, _ = PERF_POINTS_2D[2048]
    modes = (("jacobi 20it", 20, dict()),
             ("chebyshev", k_d, dict(src_dt=DT, cheby_rho=rho)),
             ("fast 20it", 20, dict(src_dt=DT, fast=True)))
    return [(f"fused_jacobi b=2 {mode}", JAC, co.fused_jacobi,
             co.fused_jacobi_plain, (2, t.x, t.x0, av, 1 + 4 * av, k), kw)
            for mode, k, kw in modes] + [
        c for c in _batched_cases(t, CMAX) if JAC[0] in c[1]]


def k1_checks(side: int, device, seed: int = 0, batch: int = 0,
              bf16: bool = False, chain: bool = False) -> list[Check]:
    """Every call with a K1 solve in it (``_k1_cases``) at grid ``side`` (a
    batch of ``batch`` grids if given; bf16 storage with ``bf16``) against
    its plain version or, with ``chain``, against the same call on the
    per-sweep K1: equal bit for bit either way, the tiled K1 computing
    what the per-sweep launches of its sweeps compute."""
    t = _Bf16Inputs(side, device, seed, batch) if bf16 else _Inputs(
        side, device, seed, batch=batch)
    tag = (f"{batch}x" if batch else "") + f"{side}² " + ("bf16 " if bf16
                                                          else "")
    return [_check(f"{tag}{label}{' vs per-sweep K1' if chain else ''}",
                   kernels, fn,
                   functools.partial(_per_sweep, fn) if chain else plain,
                   *args, **kw)
            for label, kernels, fn, plain, args, kw in _k1_cases(t, bf16)]


def _pair_args(t: "_Inputs") -> tuple:
    """The u/v velocity diffusion of the step as ``fused_jacobi_pair``
    takes it: modes 1 and 2, sources as guesses, 20 sweeps."""
    av = t.a_visc
    return (1, 2, t.src, t.x, t.x0, t.p, av, 1 + 4 * av, 20)


def _two_singles(b1, b2, s1, s2, base1, base2, alpha, beta, iters, **kw):
    return (co.fused_jacobi(b1, s1, base1, alpha, beta, iters, **kw),
            co.fused_jacobi(b2, s2, base2, alpha, beta, iters, **kw))


def pair_against_singles(side: int, device, seed: int = 0,
                         batch: int = 0) -> list[Check]:
    """``fused_jacobi_pair`` (B12) against two ``fused_jacobi`` calls on the
    same operands (JAX's contract: equal bit for bit), with operands of
    one grid at ``side`` (or, with ``batch``, of that many grids each):
    with the source fold, in fast mode, and as guesses only."""
    t = _Inputs(side, device, seed, batch=batch)
    args = _pair_args(t)
    return [_check(f"fused_jacobi_pair {side}² {mode}", JAC,
                   co.fused_jacobi_pair, _two_singles, *args, **kw)
            for mode, kw in (("src_dt", dict(src_dt=DT)),
                             ("src_dt fast", dict(src_dt=DT, fast=True)),
                             ("guess only", dict()))]


def timing_checks_pair(side: int, device, seed: int = 0) -> list[Check]:
    """What ``chip_smoke.py`` times of B12 at grid ``side``: the u/v
    velocity diffusion (20 sweeps, source fold) as one stacked pair beside
    its plain version and the two ``fused_jacobi`` calls it stands for.
    The bound counts both fields' sweeps, not the stacking copies."""
    t = _Inputs(side, device, seed)
    args = _pair_args(t)
    check = _timed(_scaled(_sweeps_cost(20, 2, src=True), 2), t.cells,
                   f"fused_jacobi_pair {side}² u/v 20it src_dt", JAC,
                   co.fused_jacobi_pair, co.fused_jacobi_pair_plain, *args,
                   src_dt=DT)
    check.composed = lambda: _two_singles(*args, src_dt=DT)
    return [check]


JAC3 = ("jacobi3_sweeps",)
JAC3_SWEEP = ("jacobi3_sweep",)


def _jac3(kw: dict, side: int, planes: int | None = None
          ) -> tuple[str, ...]:
    """The kernel a 3-D solve of ``side`` (a segment on a z-slab buffer of
    ``planes`` planes) of keyword arguments ``kw`` takes on the path
    (``cuda_ops.tiled3``)."""
    if co.tiled3(kw.get("cheby_rho") is not None, kw.get("fast", False),
                 planes, side):
        return JAC3 if planes is None else JAC3_SLAB
    return JAC3_SWEEP if planes is None else JAC3_SLAB_SWEEP


def per_sweep_checks(check_list: list[Check]) -> list[Check]:
    """Each check of ``check_list`` whose call is in the tiled 3-D
    Jacobi's mode (``tiled_mode``: a Chebyshev solve or z-slab segment in
    fast mode; float32 or bf16), run on the tiled kernel (``_tiled``)
    against the same call on the per-sweep K5 and K13 (their bf16 forms
    for a bf16 call): equal bit for bit, the tiled kernel computing what
    the per-sweep launches of its sweeps compute."""
    tiled = {JAC3_SWEEP: JAC3, JAC3_SLAB_SWEEP: JAC3_SLAB,
             JAC3_SWEEP_16: JAC3_16, JAC3_SLAB_SWEEP_16: JAC3_SLAB_16}
    return [dataclasses.replace(c, label=f"{c.label} tiled vs per-sweep",
                                kernels=tiled.get(c.kernels, c.kernels),
                                run=functools.partial(_tiled, c.run),
                                plain=functools.partial(_per_sweep, c.run))
            for c in check_list if c.tiled_mode]


def kernel_checks3(side: int, device, seed: int = 0) -> list[Check]:
    """Every wrapper of the 3-D step in every mode the step uses, at volume
    ``side``: K5 for b = 0..3 in the parity modes (20 sweeps: plain, source
    fold, zero guess) and the compensated mode's Chebyshev sweeps
    (``PERF_POINT_3D``, with and without fast math), the compensated
    pressure solve, K7, K8, and K6 for one field and for the (u, v, w)
    triple."""
    t = _Inputs(side, device, seed, ndim=3)
    n, av = t.n, t.a_visc
    iters, (rho, k_d, k_p) = 20, PERF_POINT_3D
    modes = {
        "jacobi": dict(),
        "src-fold": dict(src_dt=DT),
        "zero_init": dict(zero_init=True),
        "chebyshev": dict(src_dt=DT, cheby_rho=rho),
        "chebyshev+fast": dict(src_dt=DT, cheby_rho=rho, fast=True),
    }
    out = []
    for b in (0, 1, 2, 3):
        for mode, kw in modes.items():
            k = k_d if "cheby_rho" in kw else iters
            out.append(_solve3(_check(
                f"fused_jacobi3 b={b} {mode} {k}it", _jac3(kw, side),
                co3.fused_jacobi3, co3.fused_jacobi3_plain, b, t.x, t.x0, av,
                1 + 6 * av, k, **kw), kw))
    uvw = (t.u, t.v, t.w)
    return out + [
        _solve3(_check(f"pressure3 chebyshev+fast {k_p}it",
                       _jac3(dict(fast=True, cheby_rho=rho), side),
                       co3.fused_jacobi3, co3.fused_jacobi3_plain, 0, t.p,
                       t.p, 1.0, 6.0, k_p, zero_init=True, fast=True,
                       cheby_rho=rho), dict(fast=True, cheby_rho=rho)),
        _check("divergence3_p", ("divergence3",), co3.divergence3_p,
               co3.divergence3_p_plain, *uvw, n),
        _check("gradient3_p", ("gradient3",), co3.gradient3_p,
               co3.gradient3_p_plain, *uvw, t.p, n),
        _check("advect3_shift b=0", ("advect3",), co3.advect3_shift,
               co3.advect3_shift_plain, 0, t.x, *uvw, DT, n),
        _check("advect3_shift_fused u/v/w triple", ("advect3",),
               co3.advect3_shift_fused, co3.advect3_shift_fused_plain,
               (1, 2, 3), uvw, *uvw, DT, n),
    ]


def timing_checks3(side: int, device, seed: int = 0) -> list[Check]:
    """What ``chip_smoke.py`` times in 3-D: one launch of each CUDA kernel
    (labelled by the kernel's name; the tiled K5's runs the first T3 sweeps
    of a fast Chebyshev solve, the per-sweep K5's one Jacobi sweep;
    ``advect3`` is the self-advected triple), then K6 on one field and on
    smooth and shear velocities, and each solve at the main path's
    iteration counts on the kernel the path takes (``cuda_ops.tiled3``),
    beside the same solve on the per-sweep K5 (``chain``) where that is
    the tiled kernel."""
    t = _Inputs(side, device, seed, ndim=3)
    n, av, cells = t.n, t.a_visc, t.cells
    bv = 1 + 6 * av
    rho, k_d, k_p = PERF_POINT_3D
    uvw = (t.u, t.v, t.w)
    per_launch = co.SWEEPS_PER_LAUNCH_3D

    def sweeps(iters, **kw):
        return _sweeps_cost(iters, 3, **kw)

    def k6(label, cost, bs, fields, vel):
        check = _timed(cost, cells, label, ("advect3",),
                       co3.advect3_shift_fused,
                       co3.advect3_shift_fused_plain, bs, fields, *vel, DT,
                       n)
        check.gather = _gather3(fields, *vel, n)
        return check

    return [
        _tiled_timed(sweeps(per_launch, src=True, fast=True, cheby=True),
                     cells, "jacobi3_sweeps", JAC3, co3.fused_jacobi3,
                     co3.fused_jacobi3_plain, 1, t.x, t.x0, av, bv,
                     per_launch, src_dt=DT, fast=True, cheby_rho=rho),
        _timed(sweeps(1), cells, "jacobi3_sweep", JAC3_SWEEP,
               co3.fused_jacobi3, co3.fused_jacobi3_plain, 1, t.x, t.x0, av,
               bv, 1),
        _timed(DIV3, cells, "divergence3", ("divergence3",),
               co3.divergence3_p, co3.divergence3_p_plain, *uvw, n),
        _timed(GRAD3, cells, "gradient3", ("gradient3",), co3.gradient3_p,
               co3.gradient3_p_plain, *uvw, t.p, n),
        k6("advect3", ADVECT3_TRIPLE, (1, 2, 3), uvw, uvw),
        k6("advect3 one field (density)", ADVECT3_ONE, (0,), (t.x,), uvw),
        k6("advect3 smooth velocities", ADVECT3_TRIPLE, (1, 2, 3), t.smooth,
           t.smooth),
        k6("advect3 one field, smooth velocities", ADVECT3_ONE, (0,),
           (t.x,), t.smooth),
        k6("advect3 shear velocities", ADVECT3_TRIPLE, (1, 2, 3), t.shear,
           t.shear),
        k6("advect3 one field, shear velocities", ADVECT3_ONE, (0,), (t.x,),
           t.shear),
        _timed(sweeps(20, src=True), cells,
               "fused_jacobi3 20it src_dt (u diffusion)", JAC3_SWEEP,
               co3.fused_jacobi3, co3.fused_jacobi3_plain, 1, t.src, t.x0, av,
               bv, 20, src_dt=DT),
        _tiled_timed(sweeps(k_d, src=True, fast=True, cheby=True), cells,
                     f"fused_jacobi3 {k_d}it chebyshev+fast", JAC3,
                     co3.fused_jacobi3, co3.fused_jacobi3_plain, 1, t.src,
                     t.x0, av, bv, k_d, src_dt=DT, fast=True, cheby_rho=rho),
        _timed(sweeps(20, zero_init=True), cells, "pressure3 20it",
               JAC3_SWEEP, co3.fused_jacobi3, co3.fused_jacobi3_plain, 0,
               t.p, t.p, 1.0, 6.0, 20, zero_init=True),
        _tiled_timed(sweeps(k_p, zero_init=True, fast=True, cheby=True), cells,
                     f"pressure3 {k_p}it chebyshev+fast", JAC3,
                     co3.fused_jacobi3, co3.fused_jacobi3_plain, 0, t.p, t.p,
                     1.0, 6.0, k_p, zero_init=True, fast=True, cheby_rho=rho),
    ]


ADV3_WIN = ("advect3_windowed",)
WINDOW3 = 2  # the window of the TPU kernel's own tests (test_pallas_3d.py)
# Constant displacements in cells, (x, y, z): inside the window, across its
# edge, and far over it (tests/test_pallas_3d.py:173-174).
DISPLACEMENTS3 = ((0.4, -0.3, 0.2), (1.7, 1.7, -1.7), (9.0, -9.0, 9.0))


def kernel_checks3_windowed(side: int, device, seed: int = 0) -> list[Check]:
    """K6 in the gather window (B7/B7f's ``cmax``) against
    ``ops.three_d.advect3_windowed`` at volume ``side``: one field under
    each constant displacement of ``DISPLACEMENTS3`` (window of
    ``WINDOW3`` cells), and random velocities moving the backtrace up to 6
    cells (one field and the self-advected triple, windows of ``WINDOW3``
    and of the step's 4 cells)."""
    t = _Inputs(side, device, seed, ndim=3)
    n = t.n
    dt0 = DT * n
    out = []
    for disp in DISPLACEMENTS3:
        uvw = tuple(torch.full_like(t.x, float(np.float32(-d / dt0)))
                    for d in disp)
        out.append(_check(f"advect3_shift b=0 cmax={WINDOW3} displacement "
                          f"{disp}", ADV3_WIN, co3.advect3_shift,
                          co3.advect3_shift_plain, 0, t.x, *uvw, DT, n,
                          WINDOW3))
    fast = tuple(3.0 * f for f in (t.u, t.v, t.w))  # up to 6 cells
    for cmax in (WINDOW3, CMAX):
        out += [
            _check(f"advect3_shift b=0 cmax={cmax}, random velocities",
                   ADV3_WIN, co3.advect3_shift, co3.advect3_shift_plain, 0,
                   t.x, *fast, DT, n, cmax),
            _check(f"advect3_shift_fused u/v/w triple cmax={cmax}", ADV3_WIN,
                   co3.advect3_shift_fused, co3.advect3_shift_fused_plain,
                   (1, 2, 3), fast, *fast, DT, n, cmax),
        ]
    return out


def timing_checks3_windowed(side: int, device,
                            seed: int = 0) -> list[Check]:
    """What ``chip_smoke.py`` times of K6 in the window at volume ``side``,
    on the inputs of ``timing_checks3``'s exact K6 (the backtrace moves up
    to 2 cells): the self-advected triple (labelled by its count's name)
    and one field in the step's 4-cell window, the triple there on smooth
    velocities, then in a 2-cell window on velocities that cross it.  The
    window adds a second clamp of each coordinate: its two bounds and a min
    and a max, 12 operations a cell."""
    t = _Inputs(side, device, seed, ndim=3)
    n, cells = t.n, t.cells
    uvw = (t.u, t.v, t.w)
    fast = tuple(3.0 * f for f in uvw)

    def win(label, cost, bs, fields, vel, cmax):
        check = _timed((cost[0], cost[1] + 4 * 3), cells, label, ADV3_WIN,
                       co3.advect3_shift_fused,
                       co3.advect3_shift_fused_plain, bs, fields, *vel, DT,
                       n, cmax)
        check.gather = _gather3(fields, *vel, n, cmax)
        return check

    return [
        win("advect3_windowed", ADVECT3_TRIPLE, (1, 2, 3), uvw, uvw, CMAX),
        win(f"advect3_windowed one field cmax={CMAX}", ADVECT3_ONE, (0,),
            (t.x,), uvw, CMAX),
        win(f"advect3_windowed triple cmax={CMAX}, smooth velocities",
            ADVECT3_TRIPLE, (1, 2, 3), t.smooth, t.smooth, CMAX),
        win(f"advect3_windowed triple cmax={WINDOW3}, over the window",
            ADVECT3_TRIPLE, (1, 2, 3), fast, fast, WINDOW3),
    ]


# The bf16 forms of K5-K8 (cuda_ops_3d: each counts under its own name).
JAC3_16 = ("jacobi3_sweeps_bf16",)
JAC3_SWEEP_16 = ("jacobi3_sweep_bf16",)
ADV3_16, ADV3_WIN_16 = ("advect3_bf16",), ("advect3_windowed_bf16",)
# (field passes, float ops per cell) of one launch, a bf16 pass counting
# half: K7 reads bf16 u, v, w and writes float32, K8 reads bf16 u, v, w and
# a float32 p and writes bf16, K6 reads and writes bf16.
DIV3_BF16, GRAD3_BF16 = (2.5, 6), (4, 12)
ADVECT3_ONE_BF16, ADVECT3_TRIPLE_BF16 = (2.5, 39), (3, 81)


def _jac3_16(kw: dict, side: int) -> tuple[str, ...]:
    """The bf16 form a 3-D solve of ``side`` of keyword arguments ``kw``
    takes on the path (``cuda_ops.tiled3``)."""
    tiled = co.tiled3(kw.get("cheby_rho") is not None, kw.get("fast", False),
                      None, side)
    return JAC3_16 if tiled else JAC3_SWEEP_16


class _Bf16Inputs3(_Inputs):
    """``_Inputs``' 3-D fields rounded to bf16 (``x``, ``x0``, ``src``,
    ``p``, ``u``, ``v``, ``w``), the float32 pressure ``p32`` that K8's
    bf16 form reads, and the float32 fields widened back from the bf16
    ones (``f32``: the same values in float32 storage)."""

    def __init__(self, side: int, device, seed: int):
        super().__init__(side, device, seed, ndim=3)
        self.p32 = self.p
        names = ("x", "x0", "src", "p", "u", "v", "w")
        for name in names:
            setattr(self, name, getattr(self, name).to(torch.bfloat16))
        self.f32 = {name: getattr(self, name).float() for name in names}


def kernel_checks3_bf16(side: int, device, seed: int = 0) -> list[Check]:
    """Every bf16 form of K5-K8 against its plain twin at volume ``side``,
    in the calls the bf16 3-D step makes and a few more: K5 for b = 0..3
    in the parity modes (20 sweeps: a guess, a source fold, the zero
    guess), one sweep (bf16 in and out in one launch), Chebyshev at 2
    sweeps (the guess read as x_{k-1}) and at the compensated point's 10,
    and in fast mode (Jacobi and Chebyshev: the tiled K5's bf16 form, also
    of 1 and T3 + 1 sweeps); K7 into float32; K8 from a float32 pressure;
    K6 on one field and on the (u, v, w) triple, exact and in windows of
    2 and 4 cells on velocities that move the backtrace up to 6 cells.
    Expected bit for bit: kernel and twin do the same float32 arithmetic
    and round where the kernel stores."""
    t = _Bf16Inputs3(side, device, seed)
    n, av = t.n, t.a_visc
    bv = 1 + 6 * av
    rho, k_d, _ = PERF_POINT_3D
    per_launch = co.SWEEPS_PER_LAUNCH_3D
    modes = {
        "jacobi 20it": (20, dict()),
        "src-fold 20it": (20, dict(src_dt=DT)),
        "zero_init 20it": (20, dict(zero_init=True)),
        f"chebyshev {k_d}it": (k_d, dict(src_dt=DT, cheby_rho=rho)),
        f"chebyshev+fast {k_d}it": (k_d, dict(src_dt=DT, cheby_rho=rho,
                                              fast=True)),
    }
    out = []
    for b in (0, 1, 2, 3):
        for mode, (k, kw) in modes.items():
            out.append(_solve3(_check(
                f"bf16 fused_jacobi3 b={b} {mode}", _jac3_16(kw, side),
                co3.fused_jacobi3, co3.fused_jacobi3_plain, b, t.x, t.x0, av,
                bv, k, **kw), kw))
    for label, k, kw in (
            ("1 sweep", 1, dict()),
            ("2it chebyshev", 2, dict(src_dt=DT, cheby_rho=rho)),
            ("20it src_dt fast", 20, dict(src_dt=DT, fast=True)),
            ("1 sweep chebyshev+fast", 1, dict(src_dt=DT, cheby_rho=rho,
                                               fast=True)),
            (f"{per_launch + 1}it chebyshev+fast", per_launch + 1,
             dict(src_dt=DT, cheby_rho=rho, fast=True))):
        out.append(_solve3(_check(
            f"bf16 fused_jacobi3 b=1 {label}", _jac3_16(kw, side),
            co3.fused_jacobi3, co3.fused_jacobi3_plain, 1, t.src, t.x0, av,
            bv, k, **kw), kw))
    uvw = (t.u, t.v, t.w)
    fast = tuple((3.0 * f.float()).to(torch.bfloat16) for f in uvw)
    out += [
        _check("bf16 divergence3_p (into float32)", ("divergence3_bf16",),
               co3.divergence3_p, co3.divergence3_p_plain, *uvw, n),
        _check("bf16 gradient3_p (float32 p)", ("gradient3_bf16",),
               co3.gradient3_p, co3.gradient3_p_plain, *uvw, t.p32, n),
        _check("bf16 advect3_shift b=0", ADV3_16, co3.advect3_shift,
               co3.advect3_shift_plain, 0, t.x, *uvw, DT, n),
        _check("bf16 advect3_shift_fused u/v/w triple", ADV3_16,
               co3.advect3_shift_fused, co3.advect3_shift_fused_plain,
               (1, 2, 3), uvw, *uvw, DT, n),
    ]
    for cmax in (WINDOW3, CMAX):
        out += [
            _check(f"bf16 advect3_shift b=0 cmax={cmax}, random velocities",
                   ADV3_WIN_16, co3.advect3_shift, co3.advect3_shift_plain,
                   0, t.x, *fast, DT, n, cmax),
            _check(f"bf16 advect3_shift_fused u/v/w triple cmax={cmax}",
                   ADV3_WIN_16, co3.advect3_shift_fused,
                   co3.advect3_shift_fused_plain, (1, 2, 3), fast, *fast,
                   DT, n, cmax),
        ]
    return out


def timing_checks3_bf16(side: int, device, seed: int = 0) -> list[Check]:
    """What ``chip_smoke.py`` times of the bf16 forms of K5-K8 at volume
    ``side``, each beside its float32 form on the same values
    (``counterpart``) and its plain twin, its bound counting a bf16 pass
    half: first one launch of each form on the main path (labelled by its
    count's name: the tiled K5's T3 sweeps of a fast Chebyshev solve, the
    per-sweep K5's one Jacobi sweep, K7 into float32, K8 from a float32
    pressure, K6's triple exact and in the step's 4-cell window, the
    gathers beside ``grid_sample`` on bf16), then K6 on one field, and
    each solve at the main path's counts on the kernel the path takes, the
    tiled one beside the per-sweep chain (``chain``)."""
    t = _Bf16Inputs3(side, device, seed)
    w = t.f32
    n, av, cells = t.n, t.a_visc, t.cells
    bv = 1 + 6 * av
    rho, k_d, _ = PERF_POINT_3D
    per_launch = co.SWEEPS_PER_LAUNCH_3D
    uvw, uvw32 = (t.u, t.v, t.w), (w["u"], w["v"], w["w"])

    def sweeps(iters, **kw):
        return _sweeps_cost(iters, 3, bf16=True, **kw)

    def form(make, cost, label, kernels, fn, plain, args16, args32, **kw):
        check = make(cost, cells, label, kernels, fn, plain, *args16, **kw)
        counterpart = functools.partial(fn, *args32, **kw)
        check.counterpart = (functools.partial(_tiled, counterpart)
                             if check.tiled_mode else counterpart)
        check.counterpart_label = "float32 form on the same values"
        return check

    def k6(label, cost, kernels, bs, fields, fields32, cmax=None):
        extra = 0 if cmax is None else 4 * 3
        check = form(_timed, (cost[0], cost[1] + extra), label, kernels,
                     co3.advect3_shift_fused, co3.advect3_shift_fused_plain,
                     (bs, fields, *uvw, DT, n, cmax),
                     (bs, fields32, *uvw32, DT, n, cmax))
        check.gather = _gather3(fields, *uvw, n, cmax)
        return check

    fold = dict(src_dt=DT, fast=True, cheby_rho=rho)
    return [
        form(_tiled_timed, sweeps(per_launch, src=True, fast=True, cheby=True),
             "jacobi3_sweeps_bf16", JAC3_16, co3.fused_jacobi3,
             co3.fused_jacobi3_plain, (1, t.x, t.x0, av, bv, per_launch),
             (1, w["x"], w["x0"], av, bv, per_launch), **fold),
        form(_timed, sweeps(1), "jacobi3_sweep_bf16", JAC3_SWEEP_16,
             co3.fused_jacobi3, co3.fused_jacobi3_plain,
             (1, t.x, t.x0, av, bv, 1), (1, w["x"], w["x0"], av, bv, 1)),
        form(_timed, DIV3_BF16, "divergence3_bf16", ("divergence3_bf16",),
             co3.divergence3_p, co3.divergence3_p_plain, (*uvw, n),
             (*uvw32, n)),
        form(_timed, GRAD3_BF16, "gradient3_bf16", ("gradient3_bf16",),
             co3.gradient3_p, co3.gradient3_p_plain, (*uvw, t.p32, n),
             (*uvw32, t.p32, n)),
        k6("advect3_bf16", ADVECT3_TRIPLE_BF16, ADV3_16, (1, 2, 3), uvw,
           uvw32),
        k6("advect3_windowed_bf16", ADVECT3_TRIPLE_BF16, ADV3_WIN_16,
           (1, 2, 3), uvw, uvw32, CMAX),
        k6("advect3 bf16 one field (density)", ADVECT3_ONE_BF16, ADV3_16,
           (0,), (t.x,), (w["x"],)),
        form(_timed, sweeps(20, src=True),
             "fused_jacobi3 20it src_dt bf16 (u diffusion)", JAC3_SWEEP_16,
             co3.fused_jacobi3, co3.fused_jacobi3_plain,
             (1, t.src, t.x0, av, bv, 20), (1, w["src"], w["x0"], av, bv, 20),
             src_dt=DT),
        form(_tiled_timed, sweeps(k_d, src=True, fast=True, cheby=True),
             f"fused_jacobi3 {k_d}it chebyshev+fast bf16", JAC3_16,
             co3.fused_jacobi3, co3.fused_jacobi3_plain,
             (1, t.src, t.x0, av, bv, k_d),
             (1, w["src"], w["x0"], av, bv, k_d), **fold),
    ]


SLAB_CMAX = 4  # SimConfig.max_courant's default: the main path's window


# Every row-slab solve takes the tiled K9 (cuda_ops.slab_tiling).
JAC_SLAB = ("jacobi_slab_sweeps",)
PROJ_SLAB = ("divergence_slab", "jacobi_slab_sweeps", "gradient_slab")
DENS_SLAB = ("jacobi_slab_sweeps", "advect_slab")
SPLIT = ("jacobi_slab_sweeps_split", "jacobi_slab_sweeps")
# B13 before the split-source tiled K9: K18's one sweep, then the tiled K9.
SPLIT_K18 = ("jacobi_slab_split", "jacobi_slab_sweeps")


def slab_per_sweep_checks(check_list: list[Check]) -> list[Check]:
    """Each check of ``check_list`` whose call takes the tiled K9 held
    against the same call on the per-sweep K9 (``launch_sweeps(0)``):
    equal bit for bit, the tiled kernel computing what the per-sweep
    launches of its sweeps compute on every row the wrappers return or
    gather from."""
    return [dataclasses.replace(c, label=f"{c.label} tiled vs per-sweep",
                                plain=functools.partial(_per_sweep, c.run))
            for c in check_list if "jacobi_slab_sweeps" in c.kernels]


def _ceil8(x: int) -> int:
    return -(-x // 8) * 8


class _SlabInputs(_Inputs):
    """Random global fields at grid ``side`` cut into slabs of ``m`` rows,
    with velocities that move the backtrace up to 2 cells (``u``, ``v``)
    and up to 6 (``uf``, ``vf``: over the 4-cell window)."""

    def __init__(self, side: int, m: int, device, seed: int):
        super().__init__(side, device, seed)
        self.side, self.m, self.slabs = side, m, side // m

    def positions(self) -> dict[str, int]:
        return {"top": 0, "interior": self.slabs // 2,
                "bottom": self.slabs - 1}

    def flags(self, i: int) -> tuple[int, int, int]:
        return (int(i == 0), int(i == self.slabs - 1), i * self.m)

    def slab(self, g: torch.Tensor, i: int) -> torch.Tensor:
        return g[i * self.m:(i + 1) * self.m]

    def ext(self, g: torch.Tensor, i: int, K: int) -> torch.Tensor:
        """Rows [i*m - K, (i+1)*m + K) of g, zeros outside the grid."""
        out = g.new_zeros((self.m + 2 * K, self.side))
        lo, hi = i * self.m - K, (i + 1) * self.m + K
        a, b = max(lo, 0), min(hi, self.side)
        out[a - lo:b - lo] = g[a:b]
        return out

    def halo(self, g: torch.Tensor, i: int, k: int = 8):
        """JAX's (8, side) neighbour blocks above and below slab i."""
        e = self.ext(g, i, k)
        return e[:k], e[-k:]

    def split(self, g: torch.Tensor, i: int, k: int):
        """(slab, top halo, bottom halo) of slab i: the operands of
        ``fused_jacobi_slab_split``, each contiguous."""
        top, bot = self.halo(g, i, k)
        return self.slab(g, i), top.contiguous(), bot.contiguous()

    def slab_list(self, g: torch.Tensor) -> list[torch.Tensor]:
        """Every slab of g, each an array of its own (as the sharded step
        holds them)."""
        return [self.slab(g, i).clone() for i in range(self.slabs)]

    def flag_list(self) -> list[tuple[int, int, int]]:
        return [self.flags(i) for i in range(self.slabs)]


def kernel_checks_slab(side: int, m: int, device, seed: int = 0) -> list[Check]:
    """Every slab wrapper of the multi-device step in every mode it uses,
    for a top, an interior and a bottom slab of ``m`` rows at grid
    ``side``, with the margins the step gives them: parity (20 sweeps),
    the compensated point (rho, k_d, k_p) = (0.9, 10, 14), fast math, and
    gathers under and over the 4-cell window; K12's exact form from the
    assembled fields at the reaches of ``EXACT_REACH``."""
    t = _SlabInputs(side, m, device, seed)
    n, av, ad = t.n, t.a_visc, t.a_diff
    iters, (rho, k_d, k_p) = 20, PERF_POINTS_2D[2048]
    cmax, out = SLAB_CMAX, []
    for pos, i in t.positions().items():
        fl, ext, slab = t.flags(i), t.ext, t.slab
        jac = {
            "jacobi": (iters, dict()),
            "zero_init": (iters, dict(zero_init=True)),
            "fast": (iters, dict(fast=True)),
            "chebyshev": (k_d, dict(cheby_rho=rho)),
            "chebyshev+fast": (k_d, dict(cheby_rho=rho, fast=True)),
            "chebyshev pressure": (k_p, dict(zero_init=True, cheby_rho=rho)),
        }
        for mode, (k, kw) in jac.items():
            K = _ceil8(k + 1)
            out.append(_check(
                f"fused_jacobi_slab {pos} {mode} {k}it", JAC_SLAB,
                cs.fused_jacobi_slab, cs.fused_jacobi_slab_plain, 1,
                ext(t.x, i, K), ext(t.x0, i, K), fl, m=m, K=K, alpha=av,
                beta=1 + 4 * av, sweeps=k, **kw))
        for k, r in ((iters, None), (k_p, rho)):
            K = _ceil8(k + 3)
            out.append(_check(
                f"fused_project_slab {pos} {k}it"
                + (" chebyshev" if r else ""), PROJ_SLAB,
                cs.fused_project_slab, cs.fused_project_slab_plain,
                ext(t.u, i, K), ext(t.v, i, K), fl, n=n, iters=k, m=m, K=K,
                cheby_rho=r))
        K = _ceil8(iters + 1 + cmax)
        for fast in (False, True):
            out.append(_check(
                f"fused_dens_slab {pos} {iters}it" + (" fast" if fast else ""),
                DENS_SLAB, cs.fused_dens_slab, cs.fused_dens_slab_plain, 0,
                ext(t.src, i, K), ext(t.x0, i, K), slab(t.u, i),
                slab(t.v, i), fl, alpha=ad, beta=1 + 4 * ad, iters=iters,
                dt=DT, n=n, cmax=cmax, m=m, K=K, fast=fast))
        C = cmax + 1
        for window, (u, v) in (("under", (t.u, t.v)), ("over", (t.uf, t.vf))):
            out.append(_check(
                f"advect_slab {pos} b=0, {window} the window", ("advect_slab",),
                cs.advect_slab, cs.advect_slab_plain, (0,),
                (ext(t.x, i, C),), slab(u, i), slab(v, i), fl, dt=DT, n=n,
                cmax=cmax, m=m, self_adv=False))
            out.append(_check(
                f"advect_slab {pos} u/v pair, {window} the window",
                ("advect_slab",), cs.advect_slab, cs.advect_slab_plain,
                (1, 2), (ext(u, i, C), ext(v, i, C)), None, None, fl, dt=DT,
                n=n, cmax=cmax, m=m, self_adv=True))
        out.extend(_exact_cases(t, i, pos))
        out.append(_check(f"divergence_slab {pos}", ("divergence_slab",),
                          cs.divergence_slab, cs.divergence_slab_plain,
                          slab(t.u, i), slab(t.v, i), *t.halo(t.v, i), fl, n))
        out.append(_check(f"gradient_slab {pos}", ("gradient_slab",),
                          cs.gradient_slab, cs.gradient_slab_plain,
                          slab(t.u, i), slab(t.v, i), slab(t.p, i),
                          *t.halo(t.p, i), fl, n))
        out.extend(_split_cases(t, i, pos, cs.fused_jacobi_slab_split_plain))
    return out


# Velocity scales of the exact gathers' checks: up to 2 cells, up to 6 (over
# the 4-cell window) and up to 24 (as far as the 2048² impulse moves it).
EXACT_REACH = {"2 cells": 1.0, "6 cells": 3.0, "24 cells": 12.0}


def _exact_cases(t: "_SlabInputs", i: int, pos: str) -> list[Check]:
    """K12's exact form on slab ``i`` against its plain version, from the
    assembled fields: one field and the u/v pair at each reach of
    ``EXACT_REACH``."""
    out, kw = [], dict(dt=DT, n=t.n, m=t.m)
    for reach, scale in EXACT_REACH.items():
        u, v = scale * t.u, scale * t.v
        out.append(_check(
            f"advect_slab_exact {pos} b=0, up to {reach}",
            ("advect_slab_exact",), cs.advect_slab_exact,
            cs.advect_slab_exact_plain, (0,), (t.x,),
            t.slab(u, i).contiguous(), t.slab(v, i).contiguous(),
            t.flags(i), self_adv=False, **kw))
        out.append(_check(
            f"advect_slab_exact {pos} u/v pair, up to {reach}",
            ("advect_slab_exact",), cs.advect_slab_exact,
            cs.advect_slab_exact_plain, (1, 2), (u, v), None, None,
            t.flags(i), self_adv=True, **kw))
    return out


SPLIT_MODES = {"jacobi": dict(), "zero_init": dict(zero_init=True),
               "fast": dict(fast=True)}


def _split_cases(t: "_SlabInputs", i: int, pos: str, against) -> list[Check]:
    """B13 (the split-source tiled K9, then the tiled K9) on slab i at the
    step's 20-sweep margin (K = 24), each mode, against ``against`` on the
    same operands."""
    K, sweeps, av = _ceil8(21), 20, t.a_visc
    x, rhs = t.split(t.x, i, K), t.split(t.x0, i, K)
    return [_check(f"fused_jacobi_slab_split {pos} {mode} {sweeps}it", SPLIT,
                   cs.fused_jacobi_slab_split, against, 1, *x, *rhs,
                   t.flags(i), m=t.m, K=K, alpha=av, beta=1 + 4 * av,
                   sweeps=sweeps, **kw)
            for mode, kw in SPLIT_MODES.items()]


def timing_checks_split(side: int, m: int, device,
                        seed: int = 0) -> list[Check]:
    """What ``chip_smoke.py`` times of B13 on an interior slab of ``m``
    rows at grid ``side``, with the step's 20-sweep margin (K = 24), each
    beside the composition it replaces (two ``torch.cat``, then the tiled
    K9): the split-source tiled K9's one launch (a solve of the T sweeps
    ``slab_tiling`` gives a launch, labelled by the kernel's name), the
    20-sweep solve, and the route before it (K18's one sweep, then the
    tiled K9: ``cuda_sharded._split_k18``), K18's one launch (a 1-sweep
    solve) among it."""
    t = _SlabInputs(side, m, device, seed)
    i, K, av = t.slabs // 2, _ceil8(21), t.a_visc
    x, rhs, fl = t.split(t.x, i, K), t.split(t.x0, i, K), t.flags(i)
    rows = m + 2 * K
    per_launch = co.slab_tiling(rows, side, 20)[0]
    out = []
    for label, kernels, fn, sweeps in (
            ("jacobi_slab_sweeps_split", SPLIT[:1],
             cs.fused_jacobi_slab_split, per_launch),
            ("fused_jacobi_slab_split 20it", SPLIT,
             cs.fused_jacobi_slab_split, 20),
            ("jacobi_slab_split", SPLIT_K18[:1], cs._split_k18, 1),
            ("fused_jacobi_slab_split 20it, K18 then K9 (before)", SPLIT_K18,
             cs._split_k18, 20)):
        kw = dict(m=m, K=K, alpha=av, beta=1 + 4 * av, sweeps=sweeps)
        check = _timed(_slab_sweeps_cost(sweeps, rows, side), 1, label,
                       kernels, fn, cs.fused_jacobi_slab_split_plain, 1, *x,
                       *rhs, fl, **kw)
        check.composed = (lambda kw=kw: cs.fused_jacobi_slab(
            1, torch.cat([x[1], x[0], x[2]]),
            torch.cat([rhs[1], rhs[0], rhs[2]]), fl, **kw))
        out.append(check)
    return out


def split_against_concat(side: int, m: int, device,
                         seed: int = 0) -> list[Check]:
    """B13 against K9 on the ``torch.cat`` of the same operands (JAX's
    contract for B13: equal bit for bit), for a top, an interior and a
    bottom slab of ``m`` rows at grid ``side``."""
    t = _SlabInputs(side, m, device, seed)

    def concat(b, x, x_top, x_bot, rhs, rhs_top, rhs_bot, flags, *,
               zero_init=False, **kw):
        r = torch.cat([rhs_top, rhs, rhs_bot])
        xe = r if zero_init else torch.cat([x_top, x, x_bot])
        return cs.fused_jacobi_slab(b, xe, r, flags, zero_init=zero_init,
                                    **kw)

    return [c for pos, i in t.positions().items()
            for c in _split_cases(t, i, pos, concat)]


def split_against_k18(side: int, m: int, device,
                      seed: int = 0) -> list[Check]:
    """B13's split-source tiled K9 against the route before it, K18's one
    sweep then the tiled K9 (``cuda_sharded._split_k18``), on the same
    operands, for a top, an interior and a bottom slab: equal bit for
    bit."""
    t = _SlabInputs(side, m, device, seed)
    return [dataclasses.replace(c, label=f"{c.label} vs K18 + K9")
            for pos, i in t.positions().items()
            for c in _split_cases(t, i, pos, cs._split_k18)]


def _exact_timed(t: "_SlabInputs", i: int, label: str, cost, bs,
                 fields) -> Check:
    """K12's exact form on slab ``i`` from the assembled ``fields`` (the
    u/v pair self-advected, or one field by (u, v)), its cost counted over
    the slab's cells as K12's, and its library gather: ``grid_sample`` of
    the assembled fields at the slab's exact departure points."""
    m, side = t.m, t.side
    rows = slice(i * m, (i + 1) * m)
    pair = bs == (1, 2)
    check = _timed(_scaled(cost, m * side), 1, label, ("advect_slab_exact",),
                   cs.advect_slab_exact, cs.advect_slab_exact_plain, bs,
                   fields, None if pair else t.u[rows].contiguous(),
                   None if pair else t.v[rows].contiguous(), t.flags(i),
                   dt=DT, n=t.n, m=m, self_adv=pair)

    def gather():
        cols = torch.arange(side, dtype=torch.float32, device=t.u.device)
        grows = torch.arange(i * m, (i + 1) * m, dtype=torch.float32,
                             device=t.u.device)[:, None]
        return list(fields), departure(t.u[rows], t.v[rows], cols, grows,
                                       DT, t.n)

    check.gather = gather
    return check


def timing_checks_slab(side: int, m: int, device,
                       seed: int = 0) -> list[Check]:
    """What ``chip_smoke.py`` times for the slab kernels, on an interior
    slab of ``m`` rows at grid ``side`` with the margins the step gives:
    first one launch of each CUDA kernel (labelled by the kernel's name;
    the tiled K9's runs T sweeps (``cuda_ops.slab_tiling``), the per-sweep
    K9's one) beside its plain twin, then each wrapper at the main path's
    iteration counts, each whose solve takes the tiled K9 beside the same
    call on the per-sweep K9 (``chain``), and K12's exact form
    (``advect_slab_exact``, the u/v pair) from the assembled fields.
    Costs are counted over the rows each launch computes; the exact
    form's, as K12's, over the slab's velocities and outputs (its reads of
    the assembled fields are gathers, mostly L1/L2 hits)."""
    t = _SlabInputs(side, m, device, seed)
    n, av, ad = t.n, t.a_visc, t.a_diff
    bv, bd = 1 + 4 * av, 1 + 4 * ad
    rho, k_d, k_p = PERF_POINTS_2D[2048]
    i = t.slabs // 2
    fl, ext, slab, cmax = t.flags(i), t.ext, t.slab, SLAB_CMAX
    cells = m * side

    def sweeps(k, K, **kw):
        return _slab_sweeps_cost(k, m + 2 * K, side, **kw)

    def solve(cost, label, kernels, *args, **kw):
        return _k1_timed(cost, 1, label, kernels, *args, **kw)

    def project(k, K, **kw):
        # u and v read over the buffer, the slab's written.
        return _function(2 * (m + 2 * K) * side + 2 * cells,
                         _scaled(DIV2, (m + 2 * K - 2) * side),
                         sweeps(k, K, zero_init=True, **kw),
                         _scaled(GRAD2, cells))

    K20, Kc, Kp, Kd = (_ceil8(21), _ceil8(k_d + 1), _ceil8(20 + 3),
                       _ceil8(20 + 1 + cmax))
    Kpc, C = _ceil8(k_p + 3), cmax + 1
    advect = _timed(_scaled(ADVECT2_PAIR, cells), 1, "advect_slab",
                    ("advect_slab",), cs.advect_slab, cs.advect_slab_plain,
                    (1, 2), (ext(t.u, i, C), ext(t.v, i, C)), None, None, fl,
                    dt=DT, n=n, cmax=cmax, m=m, self_adv=True)

    def slab_gather(fields):
        # The slab's cells, at global coordinates, into the extended
        # buffer, whose row 0 is global row i*m - C.
        def gather():
            cols = torch.arange(side, dtype=torch.float32, device=t.u.device)
            rows = torch.arange(i * m, (i + 1) * m, dtype=torch.float32,
                                device=t.u.device)[:, None]
            x, y = departure(slab(t.u, i), slab(t.v, i), cols, rows, DT, n,
                             cmax)
            return [ext(f, i, C) for f in fields], (x, y - (i * m - C))
        return gather

    advect.gather = slab_gather((t.u, t.v))
    one = _timed(_scaled(ADVECT2_ONE, cells), 1, "advect_slab one field",
                 ("advect_slab",), cs.advect_slab, cs.advect_slab_plain, (0,),
                 (ext(t.x, i, C),), slab(t.u, i), slab(t.v, i), fl, dt=DT,
                 n=n, cmax=cmax, m=m, self_adv=False)
    one.gather = slab_gather((t.x,))
    exact = [_exact_timed(t, i, label, cost, bs, fields)
             for label, cost, bs, fields in (
                 ("advect_slab_exact", ADVECT2_PAIR, (1, 2), (t.u, t.v)),
                 ("advect_slab_exact one field", ADVECT2_ONE, (0,), (t.x,)))]
    per_launch = co.slab_tiling(m + 2 * K20, side, 20)[0]
    return [
        _k1_timed(sweeps(per_launch, K20), 1, "jacobi_slab_sweeps",
                  ("jacobi_slab_sweeps",), cs.fused_jacobi_slab,
                  cs.fused_jacobi_slab_plain, 1, ext(t.x, i, K20),
                  ext(t.x0, i, K20), fl, m=m, K=K20, alpha=av, beta=bv,
                  sweeps=per_launch),
        _timed(sweeps(1, K20), 1, "jacobi_slab", ("jacobi_slab",),
               functools.partial(_per_sweep, cs.fused_jacobi_slab),
               cs.fused_jacobi_slab_plain, 1, ext(t.x, i, K20),
               ext(t.x0, i, K20), fl, m=m, K=K20, alpha=av, beta=bv,
               sweeps=1),
        _timed(_scaled(DIV2, cells), 1, "divergence_slab",
               ("divergence_slab",), cs.divergence_slab,
               cs.divergence_slab_plain, slab(t.u, i), slab(t.v, i),
               *t.halo(t.v, i), fl, n),
        _timed(_scaled(GRAD2, cells), 1, "gradient_slab", ("gradient_slab",),
               cs.gradient_slab, cs.gradient_slab_plain, slab(t.u, i),
               slab(t.v, i), slab(t.p, i), *t.halo(t.p, i), fl, n),
        advect,
        one,
        *exact,
        solve(sweeps(20, K20), "fused_jacobi_slab 20it (u diffusion)",
              JAC_SLAB, cs.fused_jacobi_slab,
              cs.fused_jacobi_slab_plain, 1, ext(t.src, i, K20),
              ext(t.x0, i, K20), fl, m=m, K=K20, alpha=av, beta=bv,
              sweeps=20),
        solve(sweeps(k_d, Kc, fast=True, cheby=True),
              f"fused_jacobi_slab {k_d}it chebyshev+fast",
              JAC_SLAB, cs.fused_jacobi_slab,
              cs.fused_jacobi_slab_plain, 1, ext(t.src, i, Kc),
              ext(t.x0, i, Kc), fl, m=m, K=Kc, alpha=av, beta=bv,
              sweeps=k_d, fast=True, cheby_rho=rho),
        solve(project(20, Kp), "fused_project_slab 20it",
              PROJ_SLAB, cs.fused_project_slab,
              cs.fused_project_slab_plain, ext(t.u, i, Kp), ext(t.v, i, Kp),
              fl, n=n, iters=20, m=m, K=Kp),
        solve(project(k_p, Kpc, cheby=True),
              f"fused_project_slab {k_p}it chebyshev",
              PROJ_SLAB, cs.fused_project_slab,
              cs.fused_project_slab_plain, ext(t.u, i, Kpc),
              ext(t.v, i, Kpc), fl, n=n, iters=k_p, m=m, K=Kpc,
              cheby_rho=rho),
        # src and base read over the buffer, u and v over the slab, the
        # slab's density written.
        solve(_function(2 * (m + 2 * Kd) * side + 3 * cells,
                        sweeps(20, Kd, src=True),
                        _scaled(ADVECT2_ONE, cells)),
              "fused_dens_slab 20it", DENS_SLAB,
              cs.fused_dens_slab, cs.fused_dens_slab_plain, 0,
              ext(t.src, i, Kd), ext(t.x0, i, Kd), slab(t.u, i),
              slab(t.v, i), fl, alpha=ad, beta=bd, iters=20, dt=DT, n=n,
              cmax=cmax, m=m, K=Kd),
    ]


DAMP_GROUP = ("jacobi_slab_sweeps_damp_group",)
# (sweeps, zero_init) of the grouped smooths the checks run: the slab
# multigrid's 2-sweep smooths from a guess and from zero, a 7-sweep chunk
# and the 40 sweeps of a cycle with no coarser level (several launches).
GROUP_SMOOTHS = ((2, False), (2, True), (7, False), (40, True))


def _group_cost(sweeps: int, cells: int, zero_init: bool) -> tuple[int, int]:
    """A grouped smooth's cost over ``cells`` cells (use with
    ``cells=1``): every slab's guess (none from zero) and rhs read once
    and its result written once, 9 operations a cell a sweep."""
    return ((3 - zero_init) * cells,
            sum(_sweep_ops(sweeps, 2, damp=True)) * cells)


def _group_smooth_cases(t: "_SlabInputs", label: str,
                        smooths=GROUP_SMOOTHS) -> list[Check]:
    """K9-damp (``smooth_slabs``) over every slab of ``t`` at once, each
    smooth of ``smooths`` against its plain twin."""
    p, d, fl = t.slab_list(t.p), t.slab_list(t.x0), t.flag_list()
    return [_timed(_group_cost(k, t.side * t.side, z), 1,
                   f"{label}{k} sweeps{' zero_init' if z else ''}",
                   DAMP_GROUP, cs.smooth_slabs, cs.smooth_slabs_plain, p, d,
                   fl, sweeps=k, zero_init=z)
            for k, z in smooths]


def kernel_checks_group_smooth(side: int, m: int, device,
                               seed: int = 0) -> list[Check]:
    """K9-damp over every slab of ``m`` rows at grid ``side`` against its
    plain twin ``smooth_slabs_plain`` (bit for bit, ``--fmad=false``): the
    smooths of ``GROUP_SMOOTHS``."""
    t = _SlabInputs(side, m, device, seed)
    return _group_smooth_cases(t, f"smooth_slabs {t.slabs} slabs ")


def timing_checks_group_smooth(side: int, m: int, device,
                               seed: int = 0) -> list[Check]:
    """What ``chip_smoke.py`` times of K9-damp over every slab of ``m``
    rows at grid ``side``: the path's 2-sweep smooth from a guess
    (labelled by the kernel's name, on the 8-slab 2048² mesh the kernels
    line reads) and from zero, each beside its plain twin and its
    bound."""
    t = _SlabInputs(side, m, device, seed)
    label = f"smooth_slabs {t.slabs} slabs "
    path, zero = _group_smooth_cases(t, label, GROUP_SMOOTHS[:2])
    if (side, m) == (2048, 256):
        path.label = "jacobi_slab_sweeps_damp_group"
    return [path, zero]


JAC_BLOCK = ("jacobi_block_sweeps",)
# The block solve's chunk at 2048² on (2, 4) blocks: min(8, iters, ...).
BLOCK_CHUNK = 8


class _BlockInputs(_Inputs):
    """Random global fields at grid ``side`` and (m, k) blocks of them at
    global origins: the extended block (zeros beyond the grid), the block
    and its one-cell halos (None beyond a wall), as the block route's
    exchanges build them.  ``bf16``: the fields rounded to bf16, the
    operands of the bf16 forms, whose kernels count as ``name`` says."""

    def __init__(self, side: int, m: int, k: int, device, seed: int,
                 bf16: bool = False):
        super().__init__(side, device, seed)
        self.side, self.m, self.k, self.bf16 = side, m, k, bf16
        self.tag = " bf16" if bf16 else ""
        if bf16:
            for name in ("x", "x0", "src", "p", "u", "v", "uf", "vf"):
                setattr(self, name, getattr(self, name).to(torch.bfloat16))

    def name(self, kernel: str) -> str:
        """The launch count of ``kernel``'s form for these fields."""
        return f"{kernel}_bf16" if self.bf16 else kernel

    def positions(self) -> dict[str, tuple[int, int]]:
        """A top-left corner block, a top-edge block, one off every wall
        (r0 > 0 and c0 > 0, where the blocks leave room) and a bottom-right
        corner block."""
        s, m, k = self.side, self.m, self.k
        return {"corner": (0, 0), "top edge": (0, min(k, s - k)),
                "interior": (min(m // 2, s - m), min(k // 2, s - k)),
                "far corner": (s - m, s - k)}

    def ext(self, g: torch.Tensor, origin, K: int) -> torch.Tensor:
        r0, c0 = origin
        out = g.new_zeros((self.m + 2 * K, self.k + 2 * K))
        rlo, clo = r0 - K, c0 - K
        a, b = max(rlo, 0), min(r0 + self.m + K, self.side)
        c, d = max(clo, 0), min(c0 + self.k + K, self.side)
        out[a - rlo:b - rlo, c - clo:d - clo] = g[a:b, c:d]
        return out

    def block(self, g: torch.Tensor, origin) -> torch.Tensor:
        r0, c0 = origin
        return g[r0:r0 + self.m, c0:c0 + self.k].contiguous()

    def halos(self, g: torch.Tensor, origin) -> tuple:
        r0, c0 = origin
        m, k, s = self.m, self.k, self.side
        cols, rows = slice(c0, c0 + k), slice(r0, r0 + m)
        return (g[r0 - 1:r0, cols].contiguous() if r0 > 0 else None,
                g[r0 + m:r0 + m + 1, cols].contiguous() if r0 + m < s
                else None,
                g[rows, c0 - 1].contiguous() if c0 > 0 else None,
                g[rows, c0 + k].contiguous() if c0 + k < s else None)


def _block_cases(t: "_BlockInputs", pos: str, origin) -> list[Check]:
    """Every block form at ``origin`` in every mode the block route gives
    it: K9-block's Jacobi chunk (whole and shorter than its halo), zero
    guess, fast, Chebyshev first and chained chunks (plain and fast, and
    the zero-guess pressure), damped smooths; K12-block's two forms (one
    field and the u/v pair, under and over the window; exact at the
    reaches of ``EXACT_REACH``); K10-block and K11-block.  In bf16
    (``t.bf16``) the same calls on bf16 fields, each form's bf16 form."""
    n, av, m, k = t.n, t.a_visc, t.m, t.k
    tag, jac_k = t.tag, (t.name("jacobi_block_sweeps"),)
    adv_k, exact_k = (t.name("advect_block"),), (t.name("advect_block_exact"),)
    K, ext, blk = BLOCK_CHUNK, t.ext, t.block
    rho, k_d, k_p = PERF_POINTS_2D[2048]
    geo = dict(n=n, m=m, k=k)
    vel = dict(alpha=av, beta=1 + 4 * av)
    press = dict(alpha=1.0, beta=4.0)
    ws, wp = cheby_omegas(rho, k_d), cheby_omegas(rho, k_p)
    jac = {
        f"jacobi {K}it": (1, K, vel, {}),
        f"jacobi {K // 2}it under a {K}-cell halo": (1, K // 2, vel, {}),
        "zero_init": (0, K, press, dict(zero_init=True)),
        "fast": (2, K, vel, dict(fast=True)),
        "chebyshev first chunk": (1, K, vel, dict(omegas=ws)),
        "chebyshev chained chunk": (1, k_d - K, vel,
                                    dict(omegas=ws, first=K)),
        "chebyshev+fast chained chunk": (2, k_d - K, vel,
                                         dict(omegas=ws, first=K,
                                              fast=True)),
        "chebyshev pressure first chunk": (0, K, press,
                                           dict(omegas=wp, zero_init=True)),
    }
    out = []
    for mode, (b, sweeps, coef, kw) in jac.items():
        if kw.get("first"):
            kw = dict(kw, xm_ext=ext(t.p, origin, K))
        out.append(_check(f"fused_jacobi_block{tag} {pos} {mode}", jac_k,
                          cs.fused_jacobi_block, cs.fused_jacobi_block_plain,
                          b, ext(t.x, origin, K), ext(t.x0, origin, K),
                          origin, K=K, sweeps=sweeps, **geo, **coef, **kw))
    for sweeps, zero in ((2, False), (2, True), (K, False)):
        out.append(_check(
            f"smooth_block{tag} {pos} {sweeps} sweeps"
            + (" zero_init" if zero else ""), jac_k, cs.smooth_block,
            cs.smooth_block_plain, ext(t.p, origin, sweeps),
            ext(t.x0, origin, sweeps), origin, K=sweeps, sweeps=sweeps,
            zero_init=zero, **geo))
    C, cmax = SLAB_CMAX + 1, SLAB_CMAX
    for window, (u, v) in (("under", (t.u, t.v)), ("over", (t.uf, t.vf))):
        out.append(_check(
            f"advect_block{tag} {pos} b=0, {window} the window", adv_k,
            cs.advect_block, cs.advect_block_plain, (0,),
            (ext(t.x, origin, C),), blk(u, origin), blk(v, origin), origin,
            dt=DT, cmax=cmax, self_adv=False, **geo))
        out.append(_check(
            f"advect_block{tag} {pos} u/v pair, {window} the window",
            adv_k, cs.advect_block, cs.advect_block_plain,
            (1, 2), (ext(u, origin, C), ext(v, origin, C)), None, None,
            origin, dt=DT, cmax=cmax, self_adv=True, **geo))
    for reach, scale in EXACT_REACH.items():
        u, v = scale * t.u, scale * t.v
        out.append(_check(
            f"advect_block_exact{tag} {pos} b=0, up to {reach}",
            exact_k, cs.advect_block_exact,
            cs.advect_block_exact_plain, (0,), (t.x,), blk(u, origin),
            blk(v, origin), origin, dt=DT, self_adv=False, **geo))
        out.append(_check(
            f"advect_block_exact{tag} {pos} u/v pair, up to {reach}",
            exact_k, cs.advect_block_exact,
            cs.advect_block_exact_plain, (1, 2), (u, v), None, None, origin,
            dt=DT, self_adv=True, **geo))
    out.append(_check(f"divergence_block{tag} {pos}",
                      (t.name("divergence_block"),),
                      cs.divergence_block, cs.divergence_block_plain,
                      blk(t.u, origin), blk(t.v, origin),
                      t.halos(t.u, origin), t.halos(t.v, origin), origin, n))
    out.append(_check(f"gradient_block{tag} {pos}",
                      (t.name("gradient_block"),),
                      cs.gradient_block, cs.gradient_block_plain,
                      blk(t.u, origin), blk(t.v, origin), blk(t.p, origin),
                      t.halos(t.p, origin), origin, n))
    return out


def kernel_checks_block(side: int, m: int, k: int, device, seed: int = 0,
                        origins: dict | None = None,
                        bf16: bool = False) -> list[Check]:
    """Every block form against its plain twin (``_block_cases``) on (m,
    k) blocks of grid ``side`` at the ``origins`` given by name (a corner,
    an edge, an interior and the far corner block by default): bit for
    bit, ``--fmad=false``; the fast forms round as ``fmaf`` in both.
    ``bf16``: the bf16 forms on bf16 fields, against their twins, which
    round where the kernels store."""
    t = _BlockInputs(side, m, k, device, seed, bf16)
    return [c for pos, o in (origins or t.positions()).items()
            for c in _block_cases(t, pos, o)]


def _block_sweeps_cost(iters: int, rows: int, cols: int, m: int, k: int, *,
                       zero_init=False, **kw) -> tuple[int, int]:
    """Cost of one block chunk on a (rows, cols) buffer, in field-cells
    (use with ``cells=1``): the buffer's guess (none for the zero guess)
    and rhs read once, the (m, k) block written once; sweep j computes
    the buffer's cells j or more from its rim."""
    ops = sum(o * (rows - 2 * j) * (cols - 2 * j) for j, o in
              enumerate(_sweep_ops(iters, 2, **kw), start=1))
    return (2 - zero_init) * rows * cols + m * k, ops


def timing_checks_block(side: int, px: int, py: int, device,
                        seed: int = 0, bf16: bool = False) -> list[Check]:
    """What ``chip_smoke.py`` times of the block forms, on the top-edge
    block (origin (0, k)) of a (px, py) mesh at grid ``side``, each
    labelled by its kernel's name, beside its plain twin, its bound and
    its slab counterpart on as many cells (the slab kernel on an interior
    slab of m·k/side rows; K9-block's chunk of ``BLOCK_CHUNK`` sweeps
    against the tiled K9 on a halo as deep); the gathers also beside
    ``grid_sample``.  Then K9-block's Chebyshev chained chunk, fast, and
    its damped 2-sweep smooth.  ``bf16``: the bf16 forms on the same draw
    rounded to bf16, each bound in 2-byte storage and each beside its
    float32 form (in place of the slab counterpart)."""
    m, k = side // px, side // py
    f32 = _block_timings(_BlockInputs(side, m, k, device, seed), device,
                         seed)
    if not bf16:
        return f32
    out = _block_timings(_BlockInputs(side, m, k, device, seed, True),
                         device, seed)
    for c16, c32 in zip(out, f32):
        c16.counterpart, c16.counterpart_label = c32.run, "float32 form"
        # A bf16 pass counts half a float32 one (as _sweeps_cost's bf16).
        c16.cost = (c16.cost[0] / 2, c16.cost[1])
    return out


def _block_timings(t: "_BlockInputs", device, seed: int) -> list[Check]:
    """``timing_checks_block``'s checks on the fields of ``t`` (float32 or
    bf16), each labelled by its form's launch count."""
    side, m, k = t.side, t.m, t.k
    slab = _SlabInputs(side, m * k // side, device, seed)
    o, K, n, av = (0, k), BLOCK_CHUNK, t.n, t.a_visc
    i, fl, sm = slab.slabs // 2, slab.flags(slab.slabs // 2), slab.m
    ext, blk = t.ext, t.block
    bv, cells = 1 + 4 * av, m * k
    rho, k_d, _ = PERF_POINTS_2D[2048]
    rows, cols = m + 2 * K, k + 2 * K
    C, cmax = SLAB_CMAX + 1, SLAB_CMAX
    geo = dict(n=n, m=m, k=k)

    def chunk(label, sweeps, fn, plain, b, x, rhs, K, **kw):
        check = _timed(_block_sweeps_cost(
            sweeps, m + 2 * K, k + 2 * K, m, k,
            zero_init=kw.get("zero_init", False),
            fast=kw.get("fast", False),
            cheby="omegas" in kw and kw.get("first", 0) > 0,
            damp=fn is cs.smooth_block), 1, label,
            (t.name("jacobi_block_sweeps"),), fn, plain,
            *((b,) if b is not None else ()), x, rhs, o, K=K, sweeps=sweeps,
            **geo, **kw)
        return check

    jac = chunk(t.name("jacobi_block_sweeps"), K, cs.fused_jacobi_block,
                cs.fused_jacobi_block_plain, 1, ext(t.x, o, K),
                ext(t.x0, o, K), K, alpha=av, beta=bv)
    jac.counterpart = functools.partial(
        cs.fused_jacobi_slab, 1, slab.ext(slab.x, i, K),
        slab.ext(slab.x0, i, K), fl, m=sm, K=K, alpha=av, beta=bv, sweeps=K)
    ws = cheby_omegas(rho, k_d)
    cheb = chunk(f"fused_jacobi_block{t.tag} chebyshev+fast chained chunk "
                 f"({k_d - K} of {k_d}it)", k_d - K, cs.fused_jacobi_block,
                 cs.fused_jacobi_block_plain, 1, ext(t.x, o, K),
                 ext(t.x0, o, K), K, alpha=av, beta=bv, fast=True,
                 omegas=ws, first=K, xm_ext=ext(t.p, o, K))
    smooth = chunk(f"smooth_block{t.tag} 2 sweeps", 2, cs.smooth_block,
                   cs.smooth_block_plain, None, ext(t.p, o, 2),
                   ext(t.x0, o, 2), 2)

    def gather(bufs, buf_origin, window):
        """The block's departure points (in the window or exact) in the
        cells of ``bufs``, whose cell (0, 0) is global ``buf_origin``."""
        def run():
            cols_ = torch.arange(o[1], o[1] + k, dtype=torch.float32,
                                 device=t.u.device)[None, :]
            rows_ = torch.arange(o[0], o[0] + m, dtype=torch.float32,
                                 device=t.u.device)[:, None]
            x, y = departure(blk(t.u, o), blk(t.v, o), cols_, rows_, DT, n,
                             window)
            return list(bufs), (x - buf_origin[1], y - buf_origin[0])
        return run

    win = _timed(_scaled(ADVECT2_PAIR, cells), 1, t.name("advect_block"),
                 (t.name("advect_block"),), cs.advect_block,
                 cs.advect_block_plain,
                 (1, 2), (ext(t.u, o, C), ext(t.v, o, C)), None, None, o,
                 dt=DT, cmax=cmax, self_adv=True, **geo)
    win.gather = gather((ext(t.u, o, C), ext(t.v, o, C)), (-C, k - C),
                        cmax)
    win.counterpart = functools.partial(
        cs.advect_slab, (1, 2), (slab.ext(slab.u, i, C),
                                 slab.ext(slab.v, i, C)), None, None, fl,
        dt=DT, n=n, cmax=cmax, m=sm, self_adv=True)
    exact = _timed(_scaled(ADVECT2_PAIR, cells), 1,
                   t.name("advect_block_exact"),
                   (t.name("advect_block_exact"),), cs.advect_block_exact,
                   cs.advect_block_exact_plain, (1, 2), (t.u, t.v), None,
                   None, o, dt=DT, self_adv=True, **geo)
    exact.gather = gather((t.u, t.v), (0, 0), None)
    exact.counterpart = functools.partial(
        cs.advect_slab_exact, (1, 2), (slab.u, slab.v), None, None, fl,
        dt=DT, n=n, m=sm, self_adv=True)
    dens = _timed(_scaled(ADVECT2_ONE, cells), 1,
                  f"{t.name('advect_block')} density",
                  (t.name("advect_block"),), cs.advect_block,
                  cs.advect_block_plain, (0,), (ext(t.p, o, C),),
                  blk(t.u, o), blk(t.v, o), o, dt=DT, cmax=cmax,
                  self_adv=False, **geo)
    dens.counterpart = functools.partial(
        cs.advect_slab, (0,), (slab.ext(slab.p, i, C),),
        slab.slab(slab.u, i), slab.slab(slab.v, i), fl, dt=DT, n=n,
        cmax=cmax, m=sm, self_adv=False)
    dens_exact = _timed(_scaled(ADVECT2_ONE, cells), 1,
                        f"{t.name('advect_block_exact')} density",
                        (t.name("advect_block_exact"),),
                        cs.advect_block_exact, cs.advect_block_exact_plain,
                        (0,), (t.p,), blk(t.u, o), blk(t.v, o), o, dt=DT,
                        self_adv=False, **geo)
    dens_exact.counterpart = functools.partial(
        cs.advect_slab_exact, (0,), (slab.p,), slab.slab(slab.u, i),
        slab.slab(slab.v, i), fl, dt=DT, n=n, m=sm, self_adv=False)
    div = _timed(_scaled(DIV2, cells), 1, t.name("divergence_block"),
                 (t.name("divergence_block"),), cs.divergence_block,
                 cs.divergence_block_plain, blk(t.u, o), blk(t.v, o),
                 t.halos(t.u, o), t.halos(t.v, o), o, n)
    div.counterpart = functools.partial(
        cs.divergence_slab, slab.slab(slab.u, i), slab.slab(slab.v, i),
        *slab.halo(slab.v, i), fl, n)
    grad = _timed(_scaled(GRAD2, cells), 1, t.name("gradient_block"),
                  (t.name("gradient_block"),), cs.gradient_block,
                  cs.gradient_block_plain, blk(t.u, o), blk(t.v, o),
                  blk(t.p, o), t.halos(t.p, o), o, n)
    grad.counterpart = functools.partial(
        cs.gradient_slab, slab.slab(slab.u, i), slab.slab(slab.v, i),
        slab.slab(slab.p, i), *slab.halo(slab.p, i), fl, n)
    return [jac, win, exact, div, grad, cheb, smooth, dens, dens_exact]


def block_chunk_forms(K: int, av: float, rho: float = 0.9,
                      iters: int | None = None) -> dict[str, tuple]:
    """Every form of a block chunk the block route runs, by name: (op, b,
    sweeps, coefficients, keywords), ``op`` "jacobi" (Jacobi as deep as
    the halo ``K`` and shorter, the zero guess, the reciprocal form,
    Chebyshev first and chained chunks, fast and the zero-guess pressure)
    or "smooth" (the damped 2-sweep smooths and one as deep as the halo).
    The Chebyshev chunks take the weights of an ``iters``-sweep solve
    (3K by default)."""
    vel = dict(alpha=av, beta=1 + 4 * av)
    press = dict(alpha=1.0, beta=4.0)
    ws = cheby_omegas(rho, iters or 3 * K)
    half = max(K // 2, 1)
    return {
        "jacobi": ("jacobi", 1, K, vel, {}),
        "jacobi under the halo": ("jacobi", 1, half, vel, {}),
        "zero_init": ("jacobi", 0, K, press, dict(zero_init=True)),
        "fast": ("jacobi", 2, K, vel, dict(fast=True)),
        "chebyshev first": ("jacobi", 1, K, vel, dict(omegas=ws)),
        "chebyshev chained": ("jacobi", 1, K, vel, dict(omegas=ws, first=K)),
        "chebyshev+fast chained": ("jacobi", 2, half, vel,
                                   dict(omegas=ws, first=2 * K, fast=True)),
        "chebyshev pressure first": ("jacobi", 0, K, press,
                                     dict(omegas=ws, zero_init=True)),
        "damped 2": ("smooth", 0, 2, {}, {}),
        "damped 2 zero_init": ("smooth", 0, 2, {}, dict(zero_init=True)),
        "damped halo": ("smooth", 0, K, {}, {}),
    }


def block_chunk(how: str, form: tuple, blocks, xs, rhs, xms, n: int,
                K: int) -> tuple:
    """One chunk of ``form`` (``block_chunk_forms``) on every block of
    ``blocks`` (the lists ``xs``, ``rhs``, ``xms`` of (m, k) blocks) as
    ``how`` says: "group", the grouped K9-block (``fused_jacobi_blocks``,
    ``smooth_blocks``); "plain", its plain twin; "per-block", JAX's
    composition on the per-block K9-block (``Blocks.ext``, then one launch
    a block).  Returns every output block in one tuple (x_k, then x_{k-1}
    for Chebyshev)."""
    op, b, sweeps, coef, kw = form
    m, k = blocks.m, blocks.k
    if op == "smooth":
        if how == "per-block":
            out = [cs.smooth_block(pe, de, o, n=n, m=m, k=k, K=sweeps,
                                   sweeps=sweeps, **kw)
                   for pe, de, o in zip(blocks.ext(xs, sweeps),
                                        blocks.ext(rhs, sweeps),
                                        blocks.origins)]
        else:
            fn = cs.smooth_blocks if how == "group" else cs.smooth_blocks_plain
            out = fn(blocks, xs, rhs, n=n, K=sweeps, sweeps=sweeps, **kw)
        return tuple(out)
    if how == "per-block":
        xm_ext = (blocks.ext(xms, K) if kw.get("first", 0) > 0
                  else [None] * len(rhs))
        pairs = [cs.fused_jacobi_block(b, xe, re, o, n=n, m=m, k=k, K=K,
                                       sweeps=sweeps, xm_ext=xme, **coef,
                                       **kw)
                 for xe, re, xme, o in zip(blocks.ext(xs, K),
                                           blocks.ext(rhs, K), xm_ext,
                                           blocks.origins)]
        out = (pairs if "omegas" not in kw
               else ([q[0] for q in pairs], [q[1] for q in pairs]))
    else:
        fn = (cs.fused_jacobi_blocks if how == "group"
              else cs.fused_jacobi_blocks_plain)
        out = fn(blocks, b, xs, rhs, n=n, K=K, sweeps=sweeps, xms=xms,
                 **coef, **kw)
    return (tuple(out[0]) + tuple(out[1]) if isinstance(out, tuple)
            else tuple(out))


def _group_inputs(side: int, px: int, py: int, device, seed: int,
                  bf16: bool):
    """(inputs, blocks, x, rhs, x_{k-1}): the random fields of
    ``_BlockInputs`` cut into the (px, py) blocks of ``side``."""
    from ..parallel.mesh import Blocks

    blocks = Blocks(px, py, side)
    t = _BlockInputs(side, side // px, side // py, device, seed, bf16)
    xs, rhs, xms = (list(blocks.cut(f)) for f in (t.x, t.x0, t.p))
    return t, blocks, xs, rhs, xms


def kernel_checks_block_group(side: int, px: int, py: int, device,
                              seed: int = 0, bf16: bool = False
                              ) -> list[Check]:
    """The grouped K9-block over every (px, py) block of grid ``side`` in
    each form of ``block_chunk_forms`` (the halo of the block route's
    chunk, ``BLOCK_CHUNK`` or less on small blocks): against its plain
    twin (bit for bit; the fast forms within ``TOL``, the twin taking
    ``fmaf``'s sum in float64), and against the per-block K9-block on
    ``Blocks.ext``'s buffers, labelled "vs per-block" (bit for bit).
    ``bf16``: the bf16 forms on the fields rounded to bf16."""
    t, blocks, xs, rhs, xms = _group_inputs(side, px, py, device, seed, bf16)
    K = min(BLOCK_CHUNK, blocks.m, blocks.k)
    name = (t.name("jacobi_block_group"),)
    out = []
    for mode, form in block_chunk_forms(K, t.a_visc).items():
        args = (form, blocks, xs, rhs, xms, t.n, K)
        label = f"jacobi_block_group{t.tag} ({px}, {py}) {mode}"
        out.append(_check(label, name, block_chunk, block_chunk, "group",
                          *args))
        out[-1].plain = functools.partial(block_chunk, "plain", *args)
        out.append(_check(f"{label} vs per-block", name, block_chunk,
                          block_chunk, "group", *args))
        out[-1].plain = functools.partial(block_chunk, "per-block", *args)
    return out


def _block_group_cost(form: tuple, blocks, K: int) -> tuple[int, int]:
    """The grouped chunk's cost in field-cells of the whole grid (use with
    ``cells=1``): x (none for the zero guess), the rhs and a chained
    Chebyshev chunk's x_{k-1} read once, x_k (and x_{k-1}) written once;
    the operations of every block's chunk on its extended buffer
    (``_block_sweeps_cost``)."""
    op, _, sweeps, _, kw = form
    halo = sweeps if op == "smooth" else K
    zero = kw.get("zero_init", False)
    cheby = "omegas" in kw
    chained = cheby and kw.get("first", 0) > 0
    cells = blocks.side * blocks.side
    ops = blocks.px * blocks.py * _block_sweeps_cost(
        sweeps, blocks.m + 2 * halo, blocks.k + 2 * halo, blocks.m,
        blocks.k, zero_init=zero, fast=kw.get("fast", False),
        cheby=chained, damp=op == "smooth")[1]
    return ((3 - zero + chained + cheby) * cells, ops)


def timing_checks_block_group(side: int, px: int, py: int, device,
                              seed: int = 0,
                              bf16: bool = False) -> list[Check]:
    """What ``chip_smoke.py`` times of the grouped K9-block over every
    (px, py) block of grid ``side``: the path's Jacobi chunk of the halo
    (``BLOCK_CHUNK`` sweeps; labelled by the kernel's name), the fast
    chained Chebyshev chunk and the damped 2-sweep smooth, each beside its
    plain twin, its bound and the route it replaces (``composed``:
    ``Blocks.ext`` of its operands, then one per-block K9-block launch a
    block).  ``bf16``: the bf16 forms, each bound in 2-byte storage."""
    t, blocks, xs, rhs, xms = _group_inputs(side, px, py, device, seed, bf16)
    K = min(BLOCK_CHUNK, blocks.m, blocks.k)
    forms = block_chunk_forms(K, t.a_visc)
    rho, k_d, _ = PERF_POINTS_2D[2048]
    # The velocity solve's second chunk at the perf point, as the path runs
    # it: sweeps K .. k_d - 1, fast.
    forms["chained"] = ("jacobi", 1, k_d - K,
                        dict(alpha=t.a_visc, beta=1 + 4 * t.a_visc),
                        dict(omegas=cheby_omegas(rho, k_d), first=K,
                             fast=True))
    out = []
    for mode, label in (("jacobi", t.name("jacobi_block_group")),
                        ("chained", f"jacobi_block_group{t.tag} "
                                    f"chebyshev+fast chained ({k_d - K} of "
                                    f"{k_d}it)"),
                        ("damped 2", f"jacobi_block_group{t.tag} damped 2")):
        form = forms[mode]
        args = (form, blocks, xs, rhs, xms, t.n, K)
        fields, ops = _block_group_cost(form, blocks, K)
        check = _timed((fields / 2 if bf16 else fields, ops), 1, label,
                       (t.name("jacobi_block_group"),), block_chunk,
                       block_chunk, "group", *args)
        check.plain = functools.partial(block_chunk, "plain", *args)
        check.composed = functools.partial(block_chunk, "per-block", *args)
        out.append(check)
    return out


# The grouped K11-block's and K12-block's forms: (what, bs, cmax, reach)
# with what "gradient", "pair" (the u/v pair's self-advection) or
# "density" (one field by the velocity blocks), cmax the window (None:
# exact), reach the velocities' scale (1: up to 2 cells; 3: up to 6, past
# a 4-cell window; 12: up to 24, across blocks of 22).
BLOCK_STENCIL_FORMS = {
    "gradient": ("gradient", None, None, 1.0),
    "pair": ("pair", (1, 2), SLAB_CMAX, 1.0),
    "pair over the window": ("pair", (1, 2), SLAB_CMAX, 3.0),
    "density": ("density", (0,), SLAB_CMAX, 1.0),
    "pair cmax 1": ("pair", (1, 2), 1, 1.0),
    "exact pair": ("pair", (1, 2), None, 1.0),
    "exact pair up to 24 cells": ("pair", (1, 2), None, 12.0),
    "exact density": ("density", (0,), None, 3.0),
}


def block_stencil(how: str, form: tuple, blocks, us, vs, ps, n: int,
                  dt: float = DT) -> tuple:
    """One grouped K11-block or K12-block call of ``form``
    (``BLOCK_STENCIL_FORMS``) on every block of ``blocks`` (the lists
    ``us``, ``vs``, ``ps`` of (m, k) blocks; the density gathers ``ps``)
    as ``how`` says: "group", the grouped kernel (``gradient_blocks``,
    ``advect_blocks``); "plain", its plain twin; "per-block", JAX's
    composition on the per-block kernels (``Blocks.halos``, ``ext`` or
    ``gather``, then one launch a block).  Every output block in one
    tuple."""
    what, bs, cmax, reach = form
    if what == "gradient":
        fn = {"group": cs.gradient_blocks, "plain": cs.gradient_blocks_plain,
              "per-block": functools.partial(cs.gradient_blocks_composed,
                                             cs.gradient_block)}[how]
        uo, vo = fn(blocks, us, vs, ps, n)
        return tuple(uo) + tuple(vo)
    if reach != 1.0:
        us, vs = [reach * u for u in us], [reach * v for v in vs]
    self_adv = what == "pair"
    fields = (us, vs) if self_adv else (ps,)
    kw = dict(dt=dt, n=n, cmax=cmax, self_adv=self_adv)
    if how == "per-block":
        none = [None] * len(us)
        out = cs.advect_blocks_composed(
            cs.advect_block, cs.advect_block_exact, blocks, bs, fields,
            none if self_adv else us, none if self_adv else vs, **kw)
    else:
        fn = cs.advect_blocks if how == "group" else cs.advect_blocks_plain
        out = fn(blocks, bs, fields, us, vs, **kw)
    return tuple(t for r in out for t in r)


def _stencil_name(form: tuple, tag: str) -> str:
    what, _, cmax, _ = form
    if what == "gradient":
        return f"gradient_block_group{tag}"
    return ("advect_block_group" + ("_exact" if cmax is None else "") + tag)


def kernel_checks_block_stencil_group(side: int, px: int, py: int, device,
                                      seed: int = 0, bf16: bool = False
                                      ) -> list[Check]:
    """The grouped K11-block and K12-block over every (px, py) block of
    grid ``side`` in each form of ``BLOCK_STENCIL_FORMS`` (windowed forms
    only where the blocks hold the window): against the plain twin and
    against the per-block kernels on ``Blocks.halos``', ``ext``'s or
    ``gather``'s buffers, labelled "vs per-block", both bit for bit.
    ``bf16``: the bf16 forms on the fields rounded to bf16."""
    t, blocks, us, vs, ps = _group_inputs(side, px, py, device, seed, bf16)
    us, vs = (list(blocks.cut(f)) for f in (t.u, t.v))
    tag = "_bf16" if bf16 else ""
    out = []
    for mode, form in BLOCK_STENCIL_FORMS.items():
        cmax = form[2]
        if cmax is not None and cmax + 1 > min(blocks.m, blocks.k):
            continue
        args = (form, blocks, us, vs, ps, t.n)
        name = _stencil_name(form, tag)
        label = f"{name} ({px}, {py}) {mode}"
        out.append(_check(label, (name,), block_stencil, block_stencil,
                          "group", *args))
        out[-1].plain = functools.partial(block_stencil, "plain", *args)
        out.append(_check(f"{label} vs per-block", (name,), block_stencil,
                          block_stencil, "group", *args))
        out[-1].plain = functools.partial(block_stencil, "per-block", *args)
    return out


def timing_checks_block_stencil_group(side: int, px: int, py: int, device,
                                      seed: int = 0,
                                      bf16: bool = False) -> list[Check]:
    """What ``chip_smoke.py`` times of the grouped K11-block and K12-block
    over every (px, py) block of grid ``side``: the gradient, the windowed
    pair (labelled by the kernels' names) and density, the exact pair and
    density, each beside its plain twin, its bound over the grid, the route
    it replaces (``composed``: ``Blocks.halos``, ``ext`` or ``gather``,
    then one per-block launch a block) and, for the gathers,
    ``grid_sample`` at the grid's departure points.  ``bf16``: the bf16
    forms, each bound in 2-byte storage."""
    t, blocks, us, vs, ps = _group_inputs(side, px, py, device, seed, bf16)
    us, vs = (list(blocks.cut(f)) for f in (t.u, t.v))
    tag = "_bf16" if bf16 else ""
    cells = side * side
    out = []
    for mode, label in (("gradient", f"gradient_block_group{tag}"),
                        ("pair", f"advect_block_group{tag}"),
                        ("density", f"advect_block_group{tag} density"),
                        ("exact pair", f"advect_block_group_exact{tag}"),
                        ("exact density",
                         f"advect_block_group_exact{tag} density")):
        # Every timed form at the same reach (up to 2 cells).
        form = BLOCK_STENCIL_FORMS[mode][:3] + (1.0,)
        what, _, cmax, reach = form
        cost = {"gradient": GRAD2, "pair": ADVECT2_PAIR,
                "density": ADVECT2_ONE}[what]
        args = (form, blocks, us, vs, ps, t.n)
        check = _timed(_scaled((cost[0] / 2 if bf16 else cost[0], cost[1]),
                               cells), 1, label,
                       (_stencil_name(form, tag),), block_stencil,
                       block_stencil, "group", *args)
        check.plain = functools.partial(block_stencil, "plain", *args)
        check.composed = functools.partial(block_stencil, "per-block", *args)
        if what != "gradient":
            fields = [t.u, t.v] if what == "pair" else [t.p]
            check.gather = functools.partial(_grid_departures, fields,
                                             reach * t.u, reach * t.v, t.n,
                                             cmax)
        out.append(check)
    return out


def _grid_departures(fields, u, v, n: int, cmax):
    """(fields, (x, y)): every cell's departure point on the whole grid,
    for ``grid_sample`` beside a grouped gather."""
    side = n + 2
    ax = torch.arange(side, dtype=torch.float32, device=u.device)
    return list(fields), departure(u, v, ax[None, :], ax[:, None], DT, n,
                                   cmax)


JAC3_SLAB = ("jacobi3_slab_sweeps",)
JAC3_SLAB_SWEEP = ("jacobi3_slab",)
SLAB3_CMAX = 4  # SimConfig.max_courant's default: the main path's window


class _Slab3Inputs(_Inputs):
    """Random global volumes at ``side`` cut into z-slabs of ``mz`` planes,
    with velocities that move the backtrace up to 2 cells (``u``, ``v``,
    ``w``) and up to 6 (``uf``, ``vf``, ``wf``: over the 4-cell window)."""

    def __init__(self, side: int, mz: int, device, seed: int):
        super().__init__(side, device, seed, ndim=3)
        rng = np.random.default_rng(seed + 1)
        vfast = 6.0 / (DT * self.n)
        self.uf, self.vf, self.wf = (torch.from_numpy(
            rng.uniform(-vfast, vfast, (side,) * 3).astype(np.float32)
        ).to(device) for _ in range(3))
        self.side, self.mz, self.slabs = side, mz, side // mz

    positions = _SlabInputs.positions

    def flags(self, i: int) -> tuple[int, int, int]:
        return (int(i == 0), int(i == self.slabs - 1), i * self.mz)

    def slab(self, g: torch.Tensor, i: int) -> torch.Tensor:
        return g[i * self.mz:(i + 1) * self.mz]

    def ext(self, g: torch.Tensor, i: int, H: int) -> torch.Tensor:
        """Planes [i*mz - H, (i+1)*mz + H) of g, zeros outside the
        volume."""
        out = g.new_zeros((self.mz + 2 * H, self.side, self.side))
        lo, hi = i * self.mz - H, (i + 1) * self.mz + H
        a, b = max(lo, 0), min(hi, self.side)
        out[a - lo:b - lo] = g[a:b]
        return out

    def halo(self, g: torch.Tensor, i: int):
        """The planes next to slab i, above and below (zeros past a wall)."""
        e = self.ext(g, i, 1)
        return e[:1], e[-1:]


def _slab3_sweeps_cost(iters: int, planes: int, side: int, *,
                       zero_init=False, bf16=False, **kw) -> tuple[int, int]:
    """Cost of one z-slab solve segment on a buffer of ``planes`` planes,
    in field-cells (use with ``cells=1``), as ``_slab_sweeps_cost``: sweep
    k computes planes [k, planes-k); in bf16 storage (a guess, rhs and
    result in bf16) a field-cell counts half."""
    plane = side * side
    ops = sum(o * (planes - 2 * k) * plane for k, o in
              enumerate(_sweep_ops(iters, 3, **kw), start=1))
    store = 0.5 if bf16 else 1
    return (store * ((1 - zero_init + 1) * planes + planes - 2 * iters)
            * plane, ops)


def kernel_checks_slab3(side: int, mz: int, device,
                        seed: int = 0) -> list[Check]:
    """Every z-slab wrapper of the 3-D multi-device step in every mode it
    uses, for a top, an interior and a bottom slab of ``mz`` planes at
    volume ``side``, with the step's margins (K = min(20, iters, mz-1), H =
    K+1): 20 Jacobi sweeps, the zero guess, fast math, the compensated
    point's Chebyshev chain as a first segment and as a chained segment
    (x_{k-1} carried in and out), the gathers under and over the 4-cell
    window, K14's exact form from the assembled volumes at the reaches of
    ``EXACT_REACH``, and the two stencils."""
    t = _Slab3Inputs(side, mz, device, seed)
    n, av = t.n, t.a_visc
    rho, k_d, k_p = PERF_POINT_3D
    cmax, out = SLAB3_CMAX, []
    for pos, i in t.positions().items():
        fl, ext, slab = t.flags(i), t.ext, t.slab

        def plan(iters):
            K = min(20, iters, mz - 1)
            return K, K + 1

        K, H = plan(20)
        jac = {"jacobi": dict(), "zero_init": dict(zero_init=True),
               "fast": dict(fast=True)}
        for mode, kw in jac.items():
            out.append(_check(
                f"fused_jacobi3_slab {pos} {mode} {K}it",
                _jac3(kw, side, mz + 2 * H),
                cs3.fused_jacobi3_slab, cs3.fused_jacobi3_slab_plain, 1,
                ext(t.x, i, H), ext(t.x0, i, H), fl, mz=mz, H=H, alpha=av,
                beta=1 + 6 * av, sweeps=K, **kw))
        # The compensated point's velocity chain (k_d sweeps) as its first
        # segment, and a segment that resumes it at sweep s with x_{k-1}
        # carried in; each hands both iterates on.
        K, H = plan(k_d)
        s = max(1, K // 2)
        xm = ext(t.p, i, H)
        for what, start, sweeps, carried, fast in (
                ("first segment", 0, s, None, False),
                ("chained segment", s, min(K, k_d - s), xm, False),
                ("chained segment fast", s, min(K, k_d - s), xm, True)):
            kw = dict(cheby_rho=rho, fast=fast)
            out.append(_solve3(_check(
                f"fused_cheby3_slab {pos} {what} {start}+{sweeps}it",
                _jac3(kw, side, mz + 2 * H), cs3.fused_cheby3_slab,
                cs3.fused_cheby3_slab_plain, 3, ext(t.x, i, H), carried,
                ext(t.x0, i, H), fl, mz=mz, H=H, alpha=av, beta=1 + 6 * av,
                start=start, sweeps=sweeps, carry_in=carried is not None,
                carry_out=True, **kw), kw))
        K, H = plan(k_p)
        kw = dict(cheby_rho=rho, fast=True)
        out.append(_solve3(_check(
            f"fused_cheby3_slab {pos} pressure fast 0+{K}it",
            _jac3(kw, side, mz + 2 * H), cs3.fused_cheby3_slab,
            cs3.fused_cheby3_slab_plain, 0, ext(t.p, i, H), None,
            ext(t.p, i, H), fl, mz=mz, H=H, alpha=1.0, beta=6.0, start=0,
            sweeps=K, zero_init=True, carry_out=K < k_p, **kw), kw))
        C = cmax + 1
        for window, (u, v, w) in (("under", (t.u, t.v, t.w)),
                                  ("over", (t.uf, t.vf, t.wf))):
            uvw = tuple(slab(f, i) for f in (u, v, w))
            out.append(_check(
                f"advect3_flat_slab {pos} b=0, {window} the window",
                ("advect3_slab",), cs3.advect3_flat_slab,
                cs3.advect3_flat_slab_plain, (0,), (ext(t.x, i, C),), *uvw,
                fl, dt=DT, n=n, cmax=cmax, mz=mz))
            out.append(_check(
                f"advect3_flat_slab {pos} u/v/w triple, {window} the window",
                ("advect3_slab",), cs3.advect3_flat_slab,
                cs3.advect3_flat_slab_plain, (1, 2, 3),
                tuple(ext(f, i, C) for f in (u, v, w)), *uvw, fl, dt=DT, n=n,
                cmax=cmax, mz=mz))
        for reach, scale in EXACT_REACH.items():
            vel = tuple(scale * f for f in (t.u, t.v, t.w))
            uvw = tuple(slab(f, i).contiguous() for f in vel)
            for what, bs, fields in (("b=0", (0,), (t.x,)),
                                     ("u/v/w triple", (1, 2, 3), vel)):
                out.append(_check(
                    f"advect3_flat_slab_exact {pos} {what}, up to {reach}",
                    ("advect3_slab_exact",), cs3.advect3_flat_slab_exact,
                    cs3.advect3_flat_slab_exact_plain, bs, fields, *uvw, fl,
                    dt=DT, n=n, mz=mz))
        uvw = tuple(slab(f, i) for f in (t.u, t.v, t.w))
        out.append(_check(f"divergence3_slab {pos}", ("divergence3_slab",),
                          cs3.divergence3_slab, cs3.divergence3_slab_plain,
                          *uvw, *t.halo(t.w, i), fl, n))
        out.append(_check(f"gradient3_slab {pos}", ("gradient3_slab",),
                          cs3.gradient3_slab, cs3.gradient3_slab_plain,
                          *uvw, slab(t.p, i), *t.halo(t.p, i), fl, n))
    return out


def kernel_checks_slab3_flows(side: int, mz: int, device,
                              seed: int = 0) -> list[Check]:
    """K14 (``advect3_flat_slab``) on a top, an interior and a bottom slab
    of ``mz`` planes (odd or even) at volume ``side``, on each velocity set
    of ``gather_velocities`` (smooth, random up to 6 cells, a shear layer),
    in windows of 1 and 2 cells: one field and the self-advected (u, v, w)
    triple against the plain version, which K14 equals bit for bit."""
    t = _Slab3Inputs(side, mz, device, seed)
    out = []
    for name, vel in gather_velocities(t).items():
        for pos, i in t.positions().items():
            uvw = tuple(t.slab(f, i) for f in vel)
            for cmax in (1, 2):
                C = cmax + 1
                for what, bs, fields in (("b=0", (0,), (t.x,)),
                                         ("u/v/w triple", (1, 2, 3), vel)):
                    out.append(_check(
                        f"{side}³ mz={mz} advect3_flat_slab {pos} {what} "
                        f"cmax={cmax}, {name} velocities", ("advect3_slab",),
                        cs3.advect3_flat_slab, cs3.advect3_flat_slab_plain,
                        bs, tuple(t.ext(f, i, C) for f in fields), *uvw,
                        t.flags(i), dt=DT, n=t.n, cmax=cmax, mz=mz))
    return out


def timing_checks_slab3(side: int, mz: int, device,
                        seed: int = 0) -> list[Check]:
    """What ``chip_smoke.py`` times for the z-slab kernels, on an interior
    slab of ``mz`` planes at volume ``side`` with the step's margins: one
    launch of each CUDA kernel (labelled by the kernel's name; the tiled
    K13 runs the first T3 sweeps of a fast Chebyshev segment, the
    per-sweep K13 the first sweep of a Jacobi one, over the whole extended
    buffer; ``advect3_slab`` is the (u, v, w) triple) beside its plain
    twin, then each wrapper at the main path's iteration counts on the
    kernel the path takes, as ``timing_checks3`` times the solves; K14
    also on one field and on smooth and shear velocities, as K6, and its
    exact form (``advect3_slab_exact``, the triple) from the assembled
    volumes.  Costs count the planes each launch computes; the exact
    form's, as K14's, the slab's velocities and outputs (its reads of the
    assembled volumes are gathers, mostly L1/L2 hits)."""
    t = _Slab3Inputs(side, mz, device, seed)
    n, av = t.n, t.a_visc
    bv = 1 + 6 * av
    rho, k_d, k_p = PERF_POINT_3D
    i = t.slabs // 2
    fl, ext, slab, cmax = t.flags(i), t.ext, t.slab, SLAB3_CMAX
    cells = mz * side * side
    uvw = tuple(slab(f, i) for f in (t.u, t.v, t.w))
    K20 = min(20, mz - 1)
    Kd, Kp = min(k_d, mz - 1), min(k_p, mz - 1)
    C = cmax + 1

    def sweeps(k, H, **kw):
        return _slab3_sweeps_cost(k, mz + 2 * H, side, **kw)

    def k14(label, cost, bs, fields, vel):
        vel = tuple(slab(f, i) for f in vel)
        exts = tuple(ext(f, i, C) for f in fields)
        check = _timed(_scaled(cost, cells), 1, label, ("advect3_slab",),
                       cs3.advect3_flat_slab, cs3.advect3_flat_slab_plain,
                       bs, exts, *vel, fl, dt=DT, n=n, cmax=cmax, mz=mz)

        def slab_gather():
            # The slab's cells, at global coordinates, into the extended
            # buffer, whose plane 0 is global plane i*mz - C.
            ax = torch.arange(side, dtype=torch.float32, device=t.u.device)
            zs = torch.arange(i * mz, (i + 1) * mz, dtype=torch.float32,
                              device=t.u.device)[:, None, None]
            x, y, z = departure3(*vel, ax, ax[:, None], zs, DT, n, cmax)
            return list(exts), (x, y, z - (i * mz - C))

        check.gather = slab_gather
        return check

    def k14_exact(label, cost, bs, fields, vel):
        vel_slab = tuple(slab(f, i).contiguous() for f in vel)
        check = _timed(_scaled(cost, cells), 1, label,
                       ("advect3_slab_exact",), cs3.advect3_flat_slab_exact,
                       cs3.advect3_flat_slab_exact_plain, bs, fields,
                       *vel_slab, fl, dt=DT, n=n, mz=mz)

        def full_gather():
            # The slab's cells, at global coordinates, into the assembled
            # volumes.
            ax = torch.arange(side, dtype=torch.float32, device=t.u.device)
            zs = torch.arange(i * mz, (i + 1) * mz, dtype=torch.float32,
                              device=t.u.device)[:, None, None]
            return list(fields), departure3(*vel_slab, ax, ax[:, None], zs,
                                            DT, n)

        check.gather = full_gather
        return check

    rand = (t.u, t.v, t.w)
    per_launch = co.SWEEPS_PER_LAUNCH_3D
    H20 = K20 + 1
    return [
        _tiled_timed(sweeps(per_launch, H20, fast=True, cheby=True), 1,
                     "jacobi3_slab_sweeps", JAC3_SLAB, cs3.fused_cheby3_slab,
                     cs3.fused_cheby3_slab_plain, 1, ext(t.x, i, H20), None,
                     ext(t.x0, i, H20), fl, mz=mz, H=H20, alpha=av, beta=bv,
                     cheby_rho=rho, start=0, sweeps=per_launch, fast=True),
        _timed(sweeps(1, H20), 1, "jacobi3_slab", JAC3_SLAB_SWEEP,
               cs3.fused_jacobi3_slab, cs3.fused_jacobi3_slab_plain, 1,
               ext(t.x, i, H20), ext(t.x0, i, H20), fl, mz=mz, H=H20,
               alpha=av, beta=bv, sweeps=1),
        _timed(_scaled(DIV3, cells), 1, "divergence3_slab",
               ("divergence3_slab",), cs3.divergence3_slab,
               cs3.divergence3_slab_plain, *uvw, *t.halo(t.w, i), fl, n),
        _timed(_scaled(GRAD3, cells), 1, "gradient3_slab",
               ("gradient3_slab",), cs3.gradient3_slab,
               cs3.gradient3_slab_plain, *uvw, slab(t.p, i),
               *t.halo(t.p, i), fl, n),
        k14("advect3_slab", ADVECT3_TRIPLE, (1, 2, 3), rand, rand),
        k14("advect3_slab one field", ADVECT3_ONE, (0,), (t.x,), rand),
        k14("advect3_slab smooth velocities", ADVECT3_TRIPLE, (1, 2, 3),
            t.smooth, t.smooth),
        k14("advect3_slab one field, smooth velocities", ADVECT3_ONE, (0,),
            (t.x,), t.smooth),
        k14("advect3_slab shear velocities", ADVECT3_TRIPLE, (1, 2, 3),
            t.shear, t.shear),
        k14("advect3_slab one field, shear velocities", ADVECT3_ONE, (0,),
            (t.x,), t.shear),
        k14_exact("advect3_slab_exact", ADVECT3_TRIPLE, (1, 2, 3), rand,
                  rand),
        k14_exact("advect3_slab_exact one field", ADVECT3_ONE, (0,), (t.x,),
                  rand),
        k14_exact("advect3_slab_exact smooth velocities", ADVECT3_TRIPLE,
                  (1, 2, 3), t.smooth, t.smooth),
        _timed(sweeps(K20, H20), 1,
               f"fused_jacobi3_slab {K20}it (u diffusion)", JAC3_SLAB_SWEEP,
               cs3.fused_jacobi3_slab, cs3.fused_jacobi3_slab_plain, 1,
               ext(t.src, i, H20), ext(t.x0, i, H20), fl, mz=mz, H=H20,
               alpha=av, beta=bv, sweeps=K20),
        _timed(sweeps(K20, H20, zero_init=True), 1,
               f"fused_jacobi3_slab {K20}it pressure", JAC3_SLAB_SWEEP,
               cs3.fused_jacobi3_slab, cs3.fused_jacobi3_slab_plain, 0,
               ext(t.p, i, H20), ext(t.p, i, H20), fl, mz=mz, H=H20,
               alpha=1.0, beta=6.0, sweeps=K20, zero_init=True),
        _tiled_timed(sweeps(Kd, Kd + 1, fast=True, cheby=True), 1,
                     f"fused_cheby3_slab {Kd}it fast (u diffusion)", JAC3_SLAB,
                     cs3.fused_cheby3_slab, cs3.fused_cheby3_slab_plain, 1,
                     ext(t.src, i, Kd + 1), None, ext(t.x0, i, Kd + 1), fl,
                     mz=mz, H=Kd + 1, alpha=av, beta=bv, cheby_rho=rho,
                     start=0, sweeps=Kd, fast=True),
        _tiled_timed(sweeps(Kp, Kp + 1, zero_init=True, fast=True, cheby=True),
                     1, f"fused_cheby3_slab {Kp}it fast pressure", JAC3_SLAB,
                     cs3.fused_cheby3_slab, cs3.fused_cheby3_slab_plain, 0,
                     ext(t.p, i, Kp + 1), None, ext(t.p, i, Kp + 1), fl, mz=mz,
                     H=Kp + 1, alpha=1.0, beta=6.0, cheby_rho=rho, start=0,
                     sweeps=Kp, zero_init=True, fast=True),
    ]


# The bf16 forms of K13-K16 (cuda_sharded_3d: each counts under its own
# name).
JAC3_SLAB_16 = ("jacobi3_slab_sweeps_bf16",)
JAC3_SLAB_SWEEP_16 = ("jacobi3_slab_bf16",)
ADV3_SLAB_16 = ("advect3_slab_bf16",)
ADV3_SLAB_EXACT_16 = ("advect3_slab_exact_bf16",)


def _jac3_slab_16(kw: dict, side: int, planes: int) -> tuple[str, ...]:
    """The bf16 form a z-slab segment of ``side`` of keyword arguments
    ``kw`` on a buffer of ``planes`` planes takes on the path
    (``cuda_ops.tiled3``)."""
    tiled = co.tiled3(kw.get("cheby_rho") is not None, kw.get("fast", False),
                      planes, side)
    return JAC3_SLAB_16 if tiled else JAC3_SLAB_SWEEP_16


class _Bf16Slab3Inputs(_Slab3Inputs):
    """``_Slab3Inputs``' fields and velocities rounded to bf16 (``x``,
    ``x0``, ``src``, ``u``, ``v``, ``w``, ``uf``, ``vf``, ``wf``), the
    float32 fields widened back from them (``f32``), a float32 pressure
    ``p`` (K16's bf16 form reads float32; also a chained segment's float32
    iterate), and the rhs of a velocity diffusion as the bf16 step builds
    it (``rhs``; ``rhs_fast`` prescaled by 1/beta, ``solve_rhs3``)."""

    def __init__(self, side: int, mz: int, device, seed: int):
        super().__init__(side, mz, device, seed)
        names = ("x", "x0", "src", "u", "v", "w", "uf", "vf", "wf")
        for name in names:
            setattr(self, name, getattr(self, name).to(torch.bfloat16))
        self.f32 = {name: getattr(self, name).float() for name in names}
        beta = 1 + 6 * self.a_visc
        self.rhs, self.rhs_fast = (cs3.solve_rhs3(self.x0, self.src, DT, beta,
                                                  fast) for fast in (False,
                                                                     True))


# ---------------------------------------------------------------------------
# K14 grouped (advect3_group) and K6 on the gather body
# ---------------------------------------------------------------------------


def advect3_group_route(route: str, bs, fields, u, v, w, flags, *, dt, n,
                        cmax, mz) -> tuple[torch.Tensor, ...]:
    """The gather of every z-slab by ``route``: ``"group"``, the grouped
    K14 (``advect3_group``); ``"plain"``, its twin; ``"per-slab"``, JAX's
    composition on the per-slab K14 (``mesh._ext`` of each field, or
    ``mesh._gather`` for the exact gather, then one launch a slab,
    ``cuda_sharded_3d.advect3_composed``).  Every slab's results in one
    tuple, slab by slab."""
    kw = dict(dt=dt, n=n, cmax=cmax, mz=mz)
    if route == "group":
        out = cs3.advect3_group(bs, fields, u, v, w, flags, **kw)
    elif route == "plain":
        out = cs3.advect3_group_plain(bs, fields, u, v, w, flags, **kw)
    else:
        out = cs3.advect3_composed(cs3.advect3_flat_slab,
                                   cs3.advect3_flat_slab_exact, bs, fields,
                                   u, v, w, flags, **kw)
    return tuple(r for slab in out for r in slab)


class _Group3Inputs(_Slab3Inputs):
    """``_Slab3Inputs``' volumes in the storage dtype (bf16: rounded), cut
    into every z-slab (``cut``)."""

    def __init__(self, side: int, mz: int, device, seed: int, bf16: bool):
        super().__init__(side, mz, device, seed)
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        self.tag = "_bf16" if bf16 else ""
        self.all_flags = [self.flags(i) for i in range(self.slabs)]
        self._cuts: dict[int, tuple] = {}

    def cut(self, g: torch.Tensor) -> list[torch.Tensor]:
        """g's slabs in the storage dtype, cut once per volume."""
        if id(g) not in self._cuts:
            self._cuts[id(g)] = (g, [s.contiguous() for s in
                                     g.to(self.dtype).split(self.mz)])
        return self._cuts[id(g)][1]


def _group_check(label, kernel, route, t, bs, fields, vel, cmax):
    args = (bs, [t.cut(f) for f in fields], *(t.cut(f) for f in vel),
            t.all_flags)
    kw = dict(dt=DT, n=t.n, cmax=cmax, mz=t.mz)
    check = _check(label, (kernel,), advect3_group_route,
                   advect3_group_route, "group", *args, **kw)
    check.plain = functools.partial(advect3_group_route, route, *args, **kw)
    return check


def kernel_checks_advect3_group(side: int, mz: int, device, seed: int = 0,
                                bf16: bool = False) -> list[Check]:
    """The grouped K14 over every z-slab of ``mz`` planes at volume
    ``side``: windowed in windows of 1, 2 and ``SLAB3_CMAX`` cells (those
    the slabs hold) on velocities under and over the window, and exact at
    the reaches of ``EXACT_REACH``, one field and the (u, v, w) triple,
    each against its plain twin and against the per-slab K14 on
    ``mesh._ext``'s or ``mesh._gather``'s buffers (labelled "vs
    per-slab"), both bit for bit.  ``bf16``: the bf16 forms on the
    volumes rounded to bf16."""
    t = _Group3Inputs(side, mz, device, seed, bf16)
    out = []
    cases = [(cmax, name, vel)
             for cmax in (1, 2, SLAB3_CMAX) if cmax <= mz - 1
             for name, vel in (("under", (t.u, t.v, t.w)),
                               ("over", (t.uf, t.vf, t.wf)))]
    cases += [(None, f"up to {reach}", tuple(scale * f for f in
                                              (t.u, t.v, t.w)))
              for reach, scale in EXACT_REACH.items()]
    for cmax, name, vel in cases:
        kernel = "advect3_group" + ("_exact" if cmax is None else "") + t.tag
        how = "exact" if cmax is None else f"cmax={cmax}"
        for what, bs, fields in (("b=0", (0,), (t.x,)),
                                 ("u/v/w triple", (1, 2, 3), vel)):
            label = (f"{kernel} {t.slabs} slabs of {mz} {what} {how}, "
                     f"{name}")
            out.append(_group_check(label, kernel, "plain", t, bs, fields,
                                    vel, cmax))
            out.append(_group_check(f"{label} vs per-slab", kernel,
                                    "per-slab", t, bs, fields, vel, cmax))
    return out


def timing_checks_advect3_group(side: int, mz: int, device, seed: int = 0,
                                bf16: bool = False) -> list[Check]:
    """What ``chip_smoke.py`` times of the grouped K14 over every z-slab of
    ``mz`` planes at volume ``side`` (the step's gathers, labelled by the
    kernel's name): the windowed (u, v, w) triple in the
    ``SLAB3_CMAX``-cell window, its density (one field) and the exact
    triple, each beside its plain twin, its bound over the whole volume (as
    K6's: the velocities, each field read once, each output written once;
    a bf16 field-cell half), ``grid_sample`` on the same departures and
    the route it replaces (``composed``: ``mesh._ext`` or ``mesh._gather``,
    then one per-slab K14 launch a slab)."""
    t = _Group3Inputs(side, mz, device, seed, bf16)
    triple, one = ((ADVECT3_TRIPLE_BF16, ADVECT3_ONE_BF16) if bf16
                   else (ADVECT3_TRIPLE, ADVECT3_ONE))
    vel = (t.u, t.v, t.w)
    out = []
    for label, cost, bs, fields, cmax in (
            (f"advect3_group{t.tag}", triple, (1, 2, 3), vel, SLAB3_CMAX),
            (f"advect3_group{t.tag} one field (density)", one, (0,), (t.x,),
             SLAB3_CMAX),
            (f"advect3_group_exact{t.tag}", triple, (1, 2, 3), vel, None)):
        kernel = "advect3_group" + ("_exact" if cmax is None else "") + t.tag
        check = _group_check(label, kernel, "plain", t, bs, fields, vel,
                             cmax)
        check.cost, check.cells = _scaled(cost, side ** 3), 1
        check.composed = functools.partial(
            advect3_group_route, "per-slab", bs,
            [t.cut(f) for f in fields], *(t.cut(f) for f in vel),
            t.all_flags, dt=DT, n=t.n, cmax=cmax, mz=mz)

        def gather(fields=fields, cmax=cmax):
            ax = torch.arange(side, dtype=torch.float32, device=t.u.device)
            v16 = tuple(f.to(t.dtype) for f in vel)
            return ([f.to(t.dtype) for f in fields],
                    departure3(*v16, ax, ax[:, None], ax[:, None, None], DT,
                               t.n, cmax))

        check.gather = gather
        out.append(check)
    return out


def kernel_checks_k6_body(side: int, device, seed: int = 0,
                          bf16: bool = False) -> list[Check]:
    """K6 (``advect3_shift_fused``; its bf16 form runs the gather body of
    ``csrc/advect3_body.cuh``) at volume ``side``, exact and in the
    ``SLAB3_CMAX``-cell window, one field and the triple, against two
    other kernels on the same inputs, bit for bit: the grouped K14 over one
    slab of the whole volume ("vs grouped K14") and the one-cell per-slab
    K14 on the whole volume as one slab, the windowed form on the volume
    padded with ``cmax+1`` zero planes ("vs one-cell K14"), the arithmetic
    of K6's one-cell forms."""
    t = _Group3Inputs(side, side, device, seed, bf16)
    vel = tuple(f.to(t.dtype) for f in (t.u, t.v, t.w))
    x = t.x.to(t.dtype)
    flags = (1, 1, 0)
    out = []
    for cmax in (None, SLAB3_CMAX):
        kernel = ("advect3" if cmax is None else "advect3_windowed") + t.tag
        for what, bs, fields in (("b=0", (0,), (x,)),
                                 ("u/v/w triple", (1, 2, 3), vel)):
            label = f"{kernel} {what} at {side}³"
            k6 = (bs, fields, *vel, DT, t.n, cmax)
            check = _check(f"{label} vs grouped K14", (kernel,),
                           co3.advect3_shift_fused, co3.advect3_shift_fused,
                           *k6)
            check.plain = lambda bs=bs, fields=fields, cmax=cmax: (
                cs3.advect3_group(bs, [[f] for f in fields], *([f] for f in
                                                               vel),
                                  [flags], dt=DT, n=t.n, cmax=cmax,
                                  mz=side)[0])
            out.append(check)
            check = _check(f"{label} vs one-cell K14", (kernel,),
                           co3.advect3_shift_fused, co3.advect3_shift_fused,
                           *k6)
            if cmax is None:
                check.plain = functools.partial(
                    cs3.advect3_flat_slab_exact, bs, fields, *vel, flags,
                    dt=DT, n=t.n, mz=side)
            else:
                pad = [torch.nn.functional.pad(f, (0, 0, 0, 0, cmax + 1,
                                                   cmax + 1))
                       for f in fields]
                check.plain = functools.partial(
                    cs3.advect3_flat_slab, bs, pad, *vel, flags, dt=DT,
                    n=t.n, cmax=cmax, mz=side)
            out.append(check)
    return out


def kernel_checks_slab3_bf16(side: int, mz: int, device,
                             seed: int = 0) -> list[Check]:
    """Every bf16 form of K13-K16 against its plain twin, for a top, an
    interior and a bottom slab of ``mz`` planes at volume ``side``, with
    the step's margins: K13's Jacobi segment from the caller's bf16 guess
    ending the solve (bf16 out) or handing its float32 iterate on, from a
    float32 iterate (a chained segment), from zero, one sweep, fast on a
    prescaled rhs; its Chebyshev segments: a first one from the bf16 guess
    (both iterates handed on in float32, also after one sweep, whose
    x_{k-1} is the guess), a chained one ending the chain, in fast mode
    too (the tiled K13's bf16 form on buffers of at least 5*T3 planes) and
    handing on; K14's bf16 form under and over the 4-cell window and its
    exact form at the reaches of ``EXACT_REACH``; K15 into float32; K16
    from a float32 pressure.  Expected bit for bit: kernel and twin do the
    same float32 arithmetic and round where the kernel stores."""
    t = _Bf16Slab3Inputs(side, mz, device, seed)
    n, av = t.n, t.a_visc
    bv = 1 + 6 * av
    rho, k_d, _ = PERF_POINT_3D
    cmax, out = SLAB3_CMAX, []
    for pos, i in t.positions().items():
        fl, ext, slab = t.flags(i), t.ext, t.slab
        K = min(20, mz - 1)
        H = K + 1
        planes = mz + 2 * H
        jac = {
            "bf16 guess, ends the solve": (t.src, t.rhs, K, dict()),
            "bf16 guess, hands on float32": (t.src, t.rhs, K,
                                             dict(ends_solve=False)),
            "float32 iterate, ends the solve": (t.p, t.rhs, K, dict()),
            "zero_init": (t.rhs, t.rhs, K, dict(zero_init=True)),
            "1 sweep": (t.src, t.rhs, 1, dict()),
            "fast, prescaled": (t.src, t.rhs_fast, K, dict(fast=True)),
        }
        for what, (x, rhs, sweeps, kw) in jac.items():
            out.append(_check(
                f"bf16 fused_jacobi3_slab {pos} {what} {sweeps}it",
                _jac3_slab_16(kw, side, planes), cs3.fused_jacobi3_slab,
                cs3.fused_jacobi3_slab_plain, 1, ext(x, i, H), ext(rhs, i, H),
                fl, mz=mz, H=H, alpha=av, beta=bv, sweeps=sweeps, **kw))
        Kd = min(20, k_d, mz - 1)
        H = Kd + 1
        planes = mz + 2 * H
        s = max(1, Kd // 2)
        xm = ext(t.p, i, H)
        fast = dict(fast=True)
        for what, x, carried, start, sweeps, rhs, kw in (
                ("first segment", t.src, None, 0, s, t.rhs,
                 dict(carry_out=True)),
                ("first segment, 1 sweep", t.src, None, 0, 1, t.rhs,
                 dict(carry_out=True)),
                ("chained segment, ends the chain", t.p, xm, s, Kd - s,
                 t.rhs, dict()),
                ("first segment fast", t.src, None, 0, Kd, t.rhs_fast,
                 dict(carry_out=True, **fast)),
                ("chained segment fast, ends the chain", t.p, xm, s, Kd - s,
                 t.rhs_fast, fast),
                ("chained segment fast, hands on", t.p, xm, s, Kd - s,
                 t.rhs_fast, dict(carry_out=True, **fast))):
            mode = dict(cheby_rho=rho, **kw)
            out.append(_solve3(_check(
                f"bf16 fused_cheby3_slab {pos} {what} {start}+{sweeps}it",
                _jac3_slab_16(mode, side, planes), cs3.fused_cheby3_slab,
                cs3.fused_cheby3_slab_plain, 3, ext(x, i, H), carried,
                ext(rhs, i, H), fl, mz=mz, H=H, alpha=av, beta=bv,
                cheby_rho=rho, start=start, sweeps=sweeps,
                carry_in=carried is not None, **kw), mode))
        C = cmax + 1
        for window, (u, v, w) in (("under", (t.u, t.v, t.w)),
                                  ("over", (t.uf, t.vf, t.wf))):
            uvw = tuple(slab(f, i) for f in (u, v, w))
            for what, bs, fields in (("b=0", (0,), (t.x,)),
                                     ("u/v/w triple", (1, 2, 3),
                                      (u, v, w))):
                out.append(_check(
                    f"bf16 advect3_flat_slab {pos} {what}, {window} the "
                    f"window", ADV3_SLAB_16, cs3.advect3_flat_slab,
                    cs3.advect3_flat_slab_plain, bs,
                    tuple(ext(f, i, C) for f in fields), *uvw, fl, dt=DT, n=n,
                    cmax=cmax, mz=mz))
        for reach, scale in EXACT_REACH.items():
            vel = tuple((scale * f.float()).to(torch.bfloat16)
                        for f in (t.u, t.v, t.w))
            uvw = tuple(slab(f, i).contiguous() for f in vel)
            for what, bs, fields in (("b=0", (0,), (t.x,)),
                                     ("u/v/w triple", (1, 2, 3), vel)):
                out.append(_check(
                    f"bf16 advect3_flat_slab_exact {pos} {what}, up to "
                    f"{reach}", ADV3_SLAB_EXACT_16,
                    cs3.advect3_flat_slab_exact,
                    cs3.advect3_flat_slab_exact_plain, bs, fields, *uvw, fl,
                    dt=DT, n=n, mz=mz))
        uvw = tuple(slab(f, i) for f in (t.u, t.v, t.w))
        out.append(_check(f"bf16 divergence3_slab {pos} (into float32)",
                          ("divergence3_slab_bf16",), cs3.divergence3_slab,
                          cs3.divergence3_slab_plain, *uvw, *t.halo(t.w, i),
                          fl, n))
        out.append(_check(f"bf16 gradient3_slab {pos} (float32 p)",
                          ("gradient3_slab_bf16",), cs3.gradient3_slab,
                          cs3.gradient3_slab_plain, *uvw, slab(t.p, i),
                          *t.halo(t.p, i), fl, n))
    return out


def timing_checks_slab3_bf16(side: int, mz: int, device,
                             seed: int = 0) -> list[Check]:
    """What ``chip_smoke.py`` times of the bf16 forms of K13-K16 on an
    interior slab of ``mz`` planes at volume ``side``, each beside its
    float32 form on the same values (``counterpart``) and its plain twin,
    its bound counting a bf16 field-cell half: one launch of each form
    (labelled by its count's name: the tiled K13's first T3 sweeps of a
    fast Chebyshev segment and the per-sweep K13's one Jacobi sweep over
    the extended buffer, K15 into float32, K16 from a float32 pressure,
    K14's (u, v, w) triple windowed and exact, beside ``grid_sample`` on
    bf16), then the segments at the main path's counts."""
    t = _Bf16Slab3Inputs(side, mz, device, seed)
    f = t.f32
    n, av = t.n, t.a_visc
    bv = 1 + 6 * av
    rho, k_d, _ = PERF_POINT_3D
    i = t.slabs // 2
    fl, ext, slab, cmax = t.flags(i), t.ext, t.slab, SLAB3_CMAX
    cells = mz * side * side
    K20 = min(20, mz - 1)
    Kd = min(k_d, mz - 1)
    H20, C = K20 + 1, cmax + 1
    per_launch = co.SWEEPS_PER_LAUNCH_3D
    uvw = tuple(slab(x, i) for x in (t.u, t.v, t.w))
    uvw32 = tuple(slab(f[k], i) for k in ("u", "v", "w"))
    rhs32, fast32 = t.rhs.float(), t.rhs_fast.float()
    fast = dict(fast=True)

    def sweeps(k, H, **kw):
        return _slab3_sweeps_cost(k, mz + 2 * H, side, bf16=True, **kw)

    def form(make, cost, label, kernels, fn, plain, args16, args32, **kw):
        check = make(cost, 1, label, kernels, fn, plain, *args16, **kw)
        counterpart = functools.partial(fn, *args32, **kw)
        check.counterpart = (functools.partial(_tiled, counterpart)
                             if check.tiled_mode else counterpart)
        check.counterpart_label = "float32 form on the same values"
        return check

    def k14(label, kernels, fn, plain, fields16, fields32, vel16, vel32,
            exact):
        bs = (1, 2, 3)
        if exact:
            args16 = (bs, fields16, *vel16, fl)
            args32 = (bs, fields32, *vel32, fl)
            kw = dict(dt=DT, n=n, mz=mz)
        else:
            args16 = (bs, tuple(ext(x, i, C) for x in fields16), *vel16, fl)
            args32 = (bs, tuple(ext(x, i, C) for x in fields32), *vel32, fl)
            kw = dict(dt=DT, n=n, cmax=cmax, mz=mz)
        check = form(_timed, _scaled(ADVECT3_TRIPLE_BF16, cells), label,
                     kernels, fn, plain, args16, args32, **kw)

        def lib_gather():
            ax = torch.arange(side, dtype=torch.float32, device=t.u.device)
            zs = torch.arange(i * mz, (i + 1) * mz, dtype=torch.float32,
                              device=t.u.device)[:, None, None]
            x, y, z = departure3(*vel16, ax, ax[:, None], zs, DT, n,
                                 None if exact else cmax)
            src = list(args16[1])
            return src, (x, y, z - (0 if exact else i * mz - C))

        check.gather = lib_gather
        return check

    rand16 = (t.u, t.v, t.w)
    rand32 = tuple(f[k] for k in ("u", "v", "w"))
    return [
        form(_tiled_timed, sweeps(per_launch, H20, fast=True, cheby=True),
             "jacobi3_slab_sweeps_bf16", JAC3_SLAB_16, cs3.fused_cheby3_slab,
             cs3.fused_cheby3_slab_plain,
             (1, ext(t.x, i, H20), None, ext(t.rhs_fast, i, H20), fl),
             (1, ext(f["x"], i, H20), None, ext(fast32, i, H20), fl),
             mz=mz, H=H20, alpha=av, beta=bv, cheby_rho=rho, start=0,
             sweeps=per_launch, **fast),
        form(_timed, sweeps(1, H20), "jacobi3_slab_bf16", JAC3_SLAB_SWEEP_16,
             cs3.fused_jacobi3_slab, cs3.fused_jacobi3_slab_plain,
             (1, ext(t.x, i, H20), ext(t.rhs, i, H20), fl),
             (1, ext(f["x"], i, H20), ext(rhs32, i, H20), fl), mz=mz,
             H=H20, alpha=av, beta=bv, sweeps=1),
        form(_timed, _scaled(DIV3_BF16, cells), "divergence3_slab_bf16",
             ("divergence3_slab_bf16",), cs3.divergence3_slab,
             cs3.divergence3_slab_plain, (*uvw, *t.halo(t.w, i), fl, n),
             (*uvw32, *t.halo(f["w"], i), fl, n)),
        form(_timed, _scaled(GRAD3_BF16, cells), "gradient3_slab_bf16",
             ("gradient3_slab_bf16",), cs3.gradient3_slab,
             cs3.gradient3_slab_plain,
             (*uvw, slab(t.p, i), *t.halo(t.p, i), fl, n),
             (*uvw32, slab(t.p, i), *t.halo(t.p, i), fl, n)),
        k14("advect3_slab_bf16", ADV3_SLAB_16, cs3.advect3_flat_slab,
            cs3.advect3_flat_slab_plain, rand16, rand32, uvw, uvw32, False),
        k14("advect3_slab_exact_bf16", ADV3_SLAB_EXACT_16,
            cs3.advect3_flat_slab_exact, cs3.advect3_flat_slab_exact_plain,
            rand16, rand32, tuple(u.contiguous() for u in uvw),
            tuple(u.contiguous() for u in uvw32), True),
        form(_timed, sweeps(K20, H20),
             f"fused_jacobi3_slab {K20}it bf16 (u diffusion)",
             JAC3_SLAB_SWEEP_16, cs3.fused_jacobi3_slab,
             cs3.fused_jacobi3_slab_plain,
             (1, ext(t.src, i, H20), ext(t.rhs, i, H20), fl),
             (1, ext(f["src"], i, H20), ext(rhs32, i, H20), fl), mz=mz,
             H=H20, alpha=av, beta=bv, sweeps=K20),
        form(_tiled_timed, sweeps(Kd, Kd + 1, fast=True, cheby=True),
             f"fused_cheby3_slab {Kd}it fast bf16 (u diffusion)",
             JAC3_SLAB_16, cs3.fused_cheby3_slab, cs3.fused_cheby3_slab_plain,
             (1, ext(t.src, i, Kd + 1), None, ext(t.rhs_fast, i, Kd + 1), fl),
             (1, ext(f["src"], i, Kd + 1), None, ext(fast32, i, Kd + 1), fl),
             mz=mz, H=Kd + 1, alpha=av, beta=bv, cheby_rho=rho, start=0,
             sweeps=Kd, **fast),
    ]


def _as_tuple(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


# ---------------------------------------------------------------------------
# K4's footprint staging, and the flows K4 and K6 are held on
# ---------------------------------------------------------------------------

# K4's tile (rows, columns) and the most cells of a footprint box it
# stages (csrc/dens_advect.cu kRows, kBoxCap).
K4_TILE, K4_BOX_CAP = (8, 32), 4 * 8 * 32


def footprint_boxes(vel: tuple[torch.Tensor, torch.Tensor], n: int,
                    cmax: int | None = None) -> torch.Tensor:
    """Cells of the footprint box of each block of K4 on the velocities
    ``vel`` = (u, v) of a grid, or of a batch on leading axes, found as the
    kernel finds it: every cell's departure (a ghost cell takes its
    interior neighbour's) truncated to its lower gather corner, the
    corners' range over the block plus one on each axis.  Shape: the batch,
    then blocks per axis.  A block stages its box if it holds at most
    ``K4_BOX_CAP`` cells."""
    idx = torch.arange(n + 2, device=vel[0].device).clamp(1, n) - 1
    cells = None
    # backtrace gives (x, y): the last axis first.
    for dim, c in zip((-1, -2), backtrace(*vel, DT, n, cmax)):
        corner = c.to(torch.int32).to(torch.float64)
        corner = corner.index_select(-1, idx).index_select(-2, idx)
        pads = [0, -corner.shape[-1] % K4_TILE[1],
                0, -corner.shape[-2] % K4_TILE[0]]
        lo = torch.nn.functional.pad(corner, pads, value=float(2 ** 30))
        hi = torch.nn.functional.pad(corner, pads, value=-float(2 ** 30))
        split = lo.shape[:-2] + (lo.shape[-2] // K4_TILE[0], K4_TILE[0],
                                 lo.shape[-1] // K4_TILE[1], K4_TILE[1])
        extent = (hi.reshape(split).amax((-3, -1))
                  - lo.reshape(split).amin((-3, -1)) + 2)
        cells = extent if cells is None else cells * extent
    return cells.to(torch.int64)


def gather_velocities(t: "_Inputs") -> dict[str, tuple[torch.Tensor, ...]]:
    """The velocities K4 and K6 are held on: smooth (a few sine modes, up
    to 2 cells); random over the 4-cell window (up to 6 cells); a shear
    layer whose jump puts K4's blocks astride it past the box cap."""
    fast = ((t.uf, t.vf) if t.w is None
            else tuple(3.0 * f for f in (t.u, t.v, t.w)))
    return {"smooth": t.smooth, "random": fast, "shear": t.shear}


def kernel_checks_flows(side: int, device, seed: int = 0, ndim: int = 2,
                        batch: int = 0) -> list[Check]:
    """K4 (2-D: a grid at ``side``, or a batch of ``batch`` grids; 20
    Jacobi sweeps, 10 Chebyshev, 10 Chebyshev+fast) or K6 (3-D: a volume
    at ``side``;
    one field and the self-advected triple) on each velocity set of
    ``gather_velocities``, exact and in windows of 1 and 4 cells, against
    the plain version.  K4's checks carry their blocks' footprint boxes
    (``Check.boxes``): a block stages its box, or past the cap gathers
    directly, with the same result bit for bit (the fast mode's sweep
    takes the direct kernel throughout)."""
    t = _Inputs(side, device, seed, ndim=ndim, batch=batch)
    n, ad = t.n, t.a_diff
    rho, k_d, _ = PERF_POINTS_2D[2048]
    tag = (f"{batch}x{side}²" if batch else
           f"{side}{'³' if ndim == 3 else '²'}")
    out = []
    for name, vel in gather_velocities(t).items():
        for cmax in (None, 1, CMAX):
            win = "exact" if cmax is None else f"cmax={cmax}"
            if ndim == 3:
                kernels = ADV3_WIN if cmax else ("advect3",)
                out += [
                    _check(f"{tag} advect3_shift b=0 {win}, {name} "
                           f"velocities", kernels, co3.advect3_shift,
                           co3.advect3_shift_plain, 0, t.x, *vel, DT, n,
                           cmax),
                    _check(f"{tag} advect3_shift_fused u/v/w triple {win}, "
                           f"{name} velocities", kernels,
                           co3.advect3_shift_fused,
                           co3.advect3_shift_fused_plain, (1, 2, 3), vel,
                           *vel, DT, n, cmax)]
                continue
            for mode, iters, kw in (("jacobi 20it", 20, {}),
                                    (f"chebyshev {k_d}it", k_d,
                                     dict(cheby_rho=rho)),
                                    (f"chebyshev+fast {k_d}it", k_d,
                                     dict(fast=True, cheby_rho=rho))):
                c = _check(f"{tag} fused_dens_advect {mode} {win}, {name} "
                           f"velocities", DENS, co.fused_dens_advect,
                           co.fused_dens_advect_plain, 0, t.src, t.x0, *vel,
                           ad, 1 + 4 * ad, iters, DT, n, cmax=cmax, **kw)
                c.boxes = functools.partial(footprint_boxes, vel, n, cmax)
                out.append(c)
    return out


def staged_share(check: Check) -> float:
    """The share of the blocks of the check's K4 launch whose footprint box
    fits the cap, so that they stage it."""
    return float((check.boxes() <= K4_BOX_CAP).double().mean())


def max_abs_diff(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(_as_tuple(a), _as_tuple(b)))


def device_ms(fn: Callable[[], object], reps: int = 20) -> float:
    """Device milliseconds of one ``fn()`` call: ``reps`` calls captured in
    a CUDA graph, replayed between CUDA events, so Python and launch
    overhead are not in the number.  ``fn`` must launch on the current
    stream and not synchronise."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up: builds the library, fills the allocator
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()  # warm-up replay
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps
