"""Geometric multigrid pressure solver (plain torch; twin of
``fluidsimulationcuda_tpu.ops.multigrid``).

A V-cycle for the discrete Poisson problem the projection solves,

    A p = div,   A p := 4 p - (pL + pR + pU + pD)    (unit index spacing),

with the copy (mode 0) border on every level: damped-Jacobi smoothing
(w = 0.8), restriction with the rhs scaled for the coarse operator, bilinear
prolongation, 40 sweeps on the coarsest level.  An optional alternative to
the parity Jacobi solve (``SimConfig.pressure_solver = "multigrid"``), with
non-parity numerics.  Two cycles, as in the JAX package:

- ``v_cycle`` / ``mg_pressure_solve``: full-weighting 2x restriction and the
  9/3/3/1 prolongation; n must stay even down to the coarsest level.
- ``mg_pressure_solve_fast`` (the step's solver): separable transfer
  matrices (``_transfer_1d``), two matrix products per transfer, on a graded
  hierarchy whose every padded side is a multiple of 8 (``_coarse_side``).
  The matrices are built once per (nf, nc, device) and kept
  (``_transfer_mats``): rebuilding them eagerly would put a host build and
  a copy to the card on every level of every cycle.  The products run in
  full float32 (PyTorch's default; TF32 is off): the JAX package found that
  a one-pass bf16 transfer fails its divergence bar
  (``ops/multigrid.py:195-204`` there).  A bf16 residual is promoted to
  float32 before the products, as JAX's matmul promotes it, so on a bf16
  divergence the coarse levels, the corrected iterate and the returned
  pressure are float32; only the first pre-smooth of the first cycle runs
  in bf16 (from a bf16 zero), every later fine smooth in float32 against
  the bf16 rhs.

Every cycle takes its smoother as an argument, ``smooth(p, div, sweeps,
zero_init=False)``: ``_smooth`` here (the ``reference`` backend), or K1's
damped form K1-damp on the card (the ``cuda`` OpSet, ``kernels/cuda_ops.py``),
which equals it bit for bit.  The JAX package's ``pallas_smoother`` switch
and its TPU gate (side >= 128, side % 8) have no counterpart: K1-damp
smooths every level.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .boundary import embed_copy, embed_interior
from .diffuse import damped_diffuse

__all__ = ["OMEGA", "v_cycle", "mg_pressure_solve", "mg_pressure_solve_fast",
           "mg_levels", "residual"]

OMEGA = 0.8  # damped Jacobi: plain Jacobi leaves the checkerboard mode
#              undamped (amplification -1) and is not a smoother.


def _apply_A(p: torch.Tensor) -> torch.Tensor:
    """Interior application of A = 4I - N."""
    return 4.0 * p[..., 1:-1, 1:-1] - (
        ((p[..., 1:-1, :-2] + p[..., 1:-1, 2:]) + p[..., :-2, 1:-1])
        + p[..., 2:, 1:-1])


def residual(p: torch.Tensor, div: torch.Tensor) -> torch.Tensor:
    """r = div - A p on the interior, ghost ring by the copy rule."""
    return embed_copy(div[..., 1:-1, 1:-1] - _apply_A(p))


def _smooth(p: torch.Tensor, div: torch.Tensor, sweeps: int,
            zero_init: bool = False) -> torch.Tensor:
    """Damped-Jacobi smoothing p <- (1-w) p + w (div + N p) / 4 from ``p``
    (from zero with ``zero_init``, a zero of div's dtype).  JAX writes the
    sweep ``(rhs + neigh) * 0.25``; ``damped_diffuse``'s ``(rhs + 1*neigh)
    / 4`` is the same to the bit (a multiplication by 1 and a division by a
    power of two round nothing).  w and 1-w are taken in p's dtype, as
    JAX's ``_smooth`` takes them: on a bf16 divergence the first smooth
    runs in bf16 from a bf16 zero (w 0.80078125), every later one in
    float32 against the bf16 rhs."""
    if zero_init:
        p = torch.zeros_like(div)
    return damped_diffuse(0, p, div, 1.0, 4.0, sweeps, OMEGA)


def _restrict(r: torch.Tensor) -> torch.Tensor:
    """Full-weighting 2x restriction of a padded field (interior n -> n/2),
    scaled by 4 so the same unit-spacing stencil discretizes the coarse
    operator ((h_H/h_h)^2 = 4)."""
    rin = r[..., 1:-1, 1:-1]
    n = rin.shape[-1]
    coarse = rin.reshape(rin.shape[:-2] + (n // 2, 2, n // 2, 2)).mean(
        dim=(-3, -1))
    return embed_interior(0, 4.0 * coarse)


def _interleave(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    """Alternate a and b along ``axis`` (a first; a negative axis)."""
    shape = list(a.shape)
    shape[axis] *= 2
    return torch.stack([a, b], dim=axis).reshape(shape)


def _prolong(e: torch.Tensor) -> torch.Tensor:
    """Bilinear prolongation of a padded coarse correction to the fine grid
    (cell-centred 2x refinement: weights 9/3/3/1 over the padded coarse
    field, which the copy rule makes well defined at the walls); the four
    fine parities are whole coarse-grid arrays, interleaved."""
    c = e[..., 1:-1, 1:-1]
    up, down = e[..., 0:-2, 1:-1], e[..., 2:, 1:-1]
    left, right = e[..., 1:-1, 0:-2], e[..., 1:-1, 2:]
    ul, ur = e[..., 0:-2, 0:-2], e[..., 0:-2, 2:]
    dl, dr = e[..., 2:, 0:-2], e[..., 2:, 2:]
    f00 = 9.0 * c + 3.0 * up + 3.0 * left + ul
    f01 = 9.0 * c + 3.0 * up + 3.0 * right + ur
    f10 = 9.0 * c + 3.0 * down + 3.0 * left + dl
    f11 = 9.0 * c + 3.0 * down + 3.0 * right + dr
    top = _interleave(f00, f01, axis=-1)
    bot = _interleave(f10, f11, axis=-1)
    return embed_interior(0, _interleave(top, bot, axis=-2) * (1.0 / 16.0))


def mg_levels(n: int, min_n: int = 8) -> int:
    """How many times the interior can be halved (while even and >= min_n
    after halving)."""
    lv = 0
    while n % 2 == 0 and n // 2 >= min_n:
        n //= 2
        lv += 1
    return lv


def v_cycle(p, div, level: int, pre: int = 2, post: int = 2,
            coarse_sweeps: int = 40, smooth=_smooth):
    p = smooth(p, div, pre)
    if level == 0:
        return smooth(p, div, coarse_sweeps)
    r_c = _restrict(residual(p, div))
    e_c = v_cycle(torch.zeros_like(r_c), r_c, level - 1, pre, post,
                  coarse_sweeps, smooth)
    p = embed_copy(p[..., 1:-1, 1:-1] + _prolong(e_c)[..., 1:-1, 1:-1])
    return smooth(p, div, post)


def mg_pressure_solve(div: torch.Tensor, cycles: int = 2, *, pre: int = 2,
                      post: int = 2, smooth=_smooth) -> torch.Tensor:
    """Multigrid Poisson solve from a zero initial guess (drop-in for
    ``ops.project.pressure_solve``)."""
    levels = mg_levels(div.shape[-1] - 2)
    p = torch.zeros_like(div)
    for _ in range(cycles):
        p = v_cycle(p, div, levels, pre, post, smooth=smooth)
    return p


# ---------------------------------------------------------------------------
# The fast cycle: separable transfer matrices on a graded hierarchy
# ---------------------------------------------------------------------------


def _coarse_side(side: int) -> int:
    """Next level's padded side: halve, round down to a multiple of 8,
    floor at 16."""
    half = side // 2
    return max(16, half - half % 8)


@functools.lru_cache(maxsize=None)
def _transfer_1d(nf: int, nc: int):
    """1-D cell-centred transfer pair for interior sizes ``nf -> nc``:
    ``P`` (nf, nc) linear prolongation (each fine centre interpolates its
    two bracketing coarse centres, constant extrapolation at the walls, the
    copy-rule-compatible choice), ``R`` (nc, nf) the row-normalised ``P^T``
    (full-weighting restriction).  NumPy float32, as the JAX package builds
    them."""
    t = (np.arange(nf) + 0.5) * (nc / nf) - 0.5  # fine centres, coarse units
    j0 = np.clip(np.floor(t).astype(np.int64), 0, nc - 1)
    j1 = np.minimum(j0 + 1, nc - 1)
    w1 = np.clip(t - j0, 0.0, 1.0)
    P = np.zeros((nf, nc), np.float32)
    np.add.at(P, (np.arange(nf), j0), 1.0 - w1)
    np.add.at(P, (np.arange(nf), j1), w1)
    R = np.ascontiguousarray(P.T)
    R /= R.sum(axis=1, keepdims=True)
    return P, R


@functools.lru_cache(maxsize=None)
def _transfer_mats(nf: int, nc: int, device: torch.device):
    """``_transfer_1d(nf, nc)`` as float32 tensors on ``device``, built and
    copied once per process (a CUDA graph can then replay a cycle)."""
    return tuple(torch.from_numpy(m).to(device)
                 for m in _transfer_1d(nf, nc))


def _restrict_mat(r: torch.Tensor, nc: int) -> torch.Tensor:
    """Restriction r (padded, interior nf) -> coarse rhs (padded, interior
    nc) by the separable matrices, the rhs scaled by the coarsening ratio
    squared (the (h_H/h_h)^2 that keeps the unit-spacing stencil)."""
    rin = r[..., 1:-1, 1:-1]
    nf = rin.shape[-1]
    _, R = _transfer_mats(nf, nc, r.device)
    rin = rin.to(torch.promote_types(rin.dtype, R.dtype))
    rc = torch.matmul(torch.matmul(R, rin), R.T)
    return embed_copy(((nf / nc) ** 2) * rc)


def _prolong_mat(e: torch.Tensor, nf: int) -> torch.Tensor:
    """Bilinear prolongation of a padded coarse correction to interior size
    ``nf`` by the separable matrices."""
    ein = e[..., 1:-1, 1:-1]
    P, _ = _transfer_mats(nf, ein.shape[-1], e.device)
    ein = ein.to(torch.promote_types(ein.dtype, P.dtype))
    return embed_copy(torch.matmul(torch.matmul(P, ein), P.T))


def mg_pressure_solve_fast(div: torch.Tensor, cycles: int = 2, *,
                           pre: int = 2, post: int = 2, smooth=_smooth,
                           min_n: int = 16) -> torch.Tensor:
    """V-cycles with the matrix transfers on the graded hierarchy of
    ``_coarse_side`` (at 2048²: sides 2048 down to 32, and 40 sweeps on
    16²), smoothing with ``smooth`` on every level.  The same damped-Jacobi
    components as ``v_cycle``; non-parity numerics either way (judged by
    the residual)."""

    def cycle(p, d, zero_init=False):
        n = d.shape[-1] - 2
        if n < min_n:
            return smooth(p, d, 40, zero_init=zero_init)
        nc = _coarse_side(n + 2) - 2
        p = smooth(p, d, pre, zero_init=zero_init)
        r_c = _restrict_mat(residual(p, d), nc)
        e_c = cycle(torch.zeros_like(r_c), r_c, zero_init=True)
        e_f = _prolong_mat(e_c, n)
        p = embed_copy(p[..., 1:-1, 1:-1] + e_f[..., 1:-1, 1:-1])
        return smooth(p, d, post)

    p = torch.zeros_like(div)
    for k in range(cycles):
        p = cycle(p, div, zero_init=(k == 0))
    return p
