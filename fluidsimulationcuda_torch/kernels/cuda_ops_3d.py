"""The CUDA backend of the 3-D solver: one wrapper per 3-D TPU kernel
function, each beside its plain PyTorch version (twin of
``fluidsimulationcuda_tpu.kernels.pallas_ops_3d``).

Wrappers keep the names and signatures of ``pallas_ops_3d`` minus the TPU
knobs (``max_fused``, ``self_advect``); the gathers take JAX's ``cmax``
(the gather window in cells; None gathers exactly).  Each checks dtype
(float32), shape ``(side, side, side)``, contiguity and device, and raises
if ``side**3`` does not fit a 32-bit index.  On CPU tensors it returns its
plain version, built from ``ops/three_d.py``; on CUDA tensors it launches
the hand-written kernels of ``csrc/`` or raises.  Nothing falls back.
Unlike the TPU functions, every output carries its full ghost layer: no
``set_bnd3`` pass follows a kernel.

Four CUDA kernels carry the three 3-D TPU kernel families:

- K5, the 7-point sweeps of ``fused_jacobi3`` (TPU ``pallas_ops_3d.py:458``,
  and ``:522`` for Chebyshev), the solves of the step and the pressure
  solve between K7 and K8, in two forms that compute the same bits: the
  per-sweep ``jacobi3_sweep`` (``csrc/jacobi3.cu``, one launch a sweep)
  and the tiled ``jacobi3_sweeps`` (``csrc/jacobi3_tiles.cu``: up to T3
  sweeps of a solve a launch, each block walking a (y, x) tile along z in
  shared memory; ``cuda_ops.sweep_plan``, ``SWEEPS_PER_LAUNCH_3D``).  A
  Chebyshev solve in fast mode takes the tiled form, the others the
  per-sweep one, as measured (``cuda_ops.tiled3``);
  ``cuda_ops.launch_sweeps`` forces either.
- ``advect3`` (K6, ``csrc/advect3.cu``): ``advect3_shift`` (``:971``) and
  ``advect3_shift_fused`` (``:728``), a trilinear gather of one to three
  fields with one backtrace, exact or in the window of ``cmax`` cells
  (launches in the window count as ``advect3_windowed``).
- ``divergence3`` (K7) and ``gradient3`` (K8), ``csrc/project3.cu``:
  ``divergence3_p`` (``:1085``) and ``gradient3_p`` (``:1101``).

Launches count in ``cuda_ops.launch_counts()``.
"""
from __future__ import annotations

import torch

from ..ops.chebyshev import cheby_diffuse3
from ..ops.project import grid_h
from ..ops.source import add_source
from ..ops.three_d import (advect3, advect3_windowed,
                           apply_pressure_gradient3, diffuse3, divergence3)
from . import build
from .cuda_ops import _Sweeps, _cmax_arg, _dt0, _launch, _on_card, _stream

__all__ = [
    "fused_jacobi3", "fused_jacobi3_plain", "advect3_shift",
    "advect3_shift_plain", "advect3_shift_fused", "advect3_shift_fused_plain",
    "divergence3_p", "divergence3_p_plain", "gradient3_p", "gradient3_p_plain",
]


# ---------------------------------------------------------------------------
# B6 / B6c fused_jacobi3 (K5)
# ---------------------------------------------------------------------------


def fused_jacobi3_plain(b, x_init, x0, alpha, beta, iters, *, zero_init=False,
                        src_dt=None, fast=False, cheby_rho=None):
    """Plain form of ``fused_jacobi3``: ``ops.three_d.diffuse3`` or
    ``ops.chebyshev.cheby_diffuse3`` on the rhs ``x0 + dt*x_init``."""
    if zero_init:
        x_init = torch.zeros_like(x0)
    rhs = x0 if src_dt is None else add_source(x0, x_init, src_dt)
    if fast:
        # The reciprocal form rhs/beta + (alpha/beta)*neigh is the Jacobi
        # update with alpha' = alpha/beta and beta' = 1 on a pre-scaled rhs
        # (division by 1 is exact).
        rhs = rhs * (1.0 / beta)
        alpha, beta = alpha / beta, 1.0
    if cheby_rho is not None:
        return cheby_diffuse3(b, x_init, rhs, alpha, beta, iters, cheby_rho)
    return diffuse3(b, x_init, rhs, alpha, beta, iters)


def fused_jacobi3(b, x_init, x0, alpha, beta, iters, *, zero_init=False,
                  src_dt=None, fast=False, cheby_rho=None):
    """``iters`` 7-point Jacobi sweeps (semantics of ``ops.three_d.diffuse3``)
    from guess ``x_init`` with rhs ``x0``.  ``zero_init`` starts from zero
    (pressure solve); ``src_dt`` folds the source ``x_init`` into the rhs as
    ``x0 + src_dt*x_init`` (the step's ``add_source``); ``fast`` uses the
    reciprocal form (``pallas_ops_3d.py:239-302``); ``cheby_rho`` switches
    to Chebyshev sweeps (``ops/chebyshev.py``), with x_{k-1} carried from
    launch to launch.  ceil(iters / T3) launches of the tiled K5 for a
    Chebyshev solve in fast mode, one launch of the per-sweep K5 a sweep
    otherwise (``cuda_ops.tiled3``)."""
    if iters < 1:
        raise ValueError("iters must be >= 1")
    if not _on_card(x0.shape[-1], x_init, x0, ndim=3):
        return fused_jacobi3_plain(b, x_init, x0, alpha, beta, iters,
                                   zero_init=zero_init, src_dt=src_dt,
                                   fast=fast, cheby_rho=cheby_rho)
    with torch.cuda.device(x0.device):
        lib = build.load()
        sweeps = _Sweeps(b, x_init, x0, alpha, beta, iters,
                         zero_init=zero_init, src_dt=src_dt, fast=fast,
                         cheby_rho=cheby_rho, kernel="jacobi3_sweep")
        sweeps.run3(lib)
        return sweeps.x


# ---------------------------------------------------------------------------
# B7 / B7f advect3_shift, advect3_shift_fused (K6)
# ---------------------------------------------------------------------------


def advect3_shift_plain(b, d0, u, v, w, dt, n, cmax=None):
    if cmax is None:
        return advect3(b, d0, u, v, w, dt, n)
    return advect3_windowed(b, d0, u, v, w, dt, n, cmax)


def advect3_shift_fused_plain(bs, d0s, u, v, w, dt, n, cmax=None):
    return tuple(advect3_shift_plain(b, d0, u, v, w, dt, n, cmax)
                 for b, d0 in zip(bs, d0s))


def advect3_shift_fused(bs, d0s, u, v, w, dt, n, cmax=None):
    """Advect one to three fields by the same velocity with one shared
    backtrace (the (u, v, w) self-advection triple).  Exact at any
    displacement, or with ``cmax`` each departure coordinate clamped to
    ``cmax`` cells around its cell (``ops.three_d.advect3_windowed``, the
    TPU kernel's window); outputs are fresh tensors, so advecting the
    velocities by themselves reads the pre-advection velocity."""
    bs, d0s = tuple(bs), tuple(d0s)
    if len(bs) != len(d0s) or len(d0s) not in (1, 2, 3):
        raise ValueError("advect3_shift_fused takes one to three fields")
    window = _cmax_arg(cmax)
    if not _on_card(n + 2, u, v, w, *d0s, ndim=3):
        return advect3_shift_fused_plain(bs, d0s, u, v, w, dt, n, cmax)
    with torch.cuda.device(u.device):
        lib = build.load()
        outs = tuple(torch.empty_like(d) for d in d0s)
        pad = 3 - len(d0s)  # null pointers for the fields not given
        fields = [d.data_ptr() for d in d0s] + [None] * pad
        results = [o.data_ptr() for o in outs] + [None] * pad
        modes = list(bs) + [0] * pad
        _launch("advect3_windowed" if window else "advect3",
                lib.fsc_advect3, *fields, u.data_ptr(), v.data_ptr(),
                w.data_ptr(), *results, n + 2, *modes, _dt0(dt, n), window,
                _stream(u))
        return outs


def advect3_shift(b, d0, u, v, w, dt, n, cmax=None):
    """Semi-Lagrangian advection of one field (``ops.three_d.advect3``, or
    ``advect3_windowed`` with ``cmax``)."""
    return advect3_shift_fused((b,), (d0,), u, v, w, dt, n, cmax)[0]


# ---------------------------------------------------------------------------
# B8a divergence3_p (K7), B8b gradient3_p (K8)
# ---------------------------------------------------------------------------


def divergence3_p_plain(u, v, w, n):
    return divergence3(u, v, w, n)


def divergence3_p(u, v, w, n):
    """Divergence with the b=0 ghost layer (``ops.three_d.divergence3``)."""
    if not _on_card(n + 2, u, v, w, ndim=3):
        return divergence3_p_plain(u, v, w, n)
    with torch.cuda.device(u.device):
        lib = build.load()
        out = torch.empty_like(u)
        _launch("divergence3", lib.fsc_divergence3, u.data_ptr(),
                v.data_ptr(), w.data_ptr(), out.data_ptr(), n + 2,
                -0.5 * grid_h(n), _stream(u))
        return out


def gradient3_p_plain(u, v, w, p, n):
    return apply_pressure_gradient3(u, v, w, p, n)


def gradient3_p(u, v, w, p, n):
    """Pressure-gradient subtraction with the b=1 (u), b=2 (v) and b=3 (w)
    ghost layers (``ops.three_d.apply_pressure_gradient3``)."""
    if not _on_card(n + 2, u, v, w, p, ndim=3):
        return gradient3_p_plain(u, v, w, p, n)
    with torch.cuda.device(u.device):
        lib = build.load()
        outs = tuple(torch.empty_like(t) for t in (u, v, w))
        _launch("gradient3", lib.fsc_gradient3, u.data_ptr(), v.data_ptr(),
                w.data_ptr(), p.data_ptr(), *(o.data_ptr() for o in outs),
                n + 2, grid_h(n), _stream(u))
        return outs
