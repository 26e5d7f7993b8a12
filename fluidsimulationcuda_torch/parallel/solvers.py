"""The pressure solves of the row-slab step beyond Jacobi and Chebyshev
(PyTorch twin of the sharded solvers of
``fluidsimulationcuda_tpu.parallel.sharded``: ``_cg_local``, ``_mg_local``
and their helpers, on the slab route's (px, 1) mesh).

Each takes the divergence as a list of (m, side) row slabs, slab ``i`` on
its own device with ``flags[i] = (is_top, is_bot, row0)``, and returns the
pressure the same way.  One process drives every slab, as the step does
(``parallel/sharded.py``): a halo row moves between devices with ``.to``,
and JAX's ``psum`` is ``_psum_all``, each slab's partial moved to the first
slab's device and summed there in slab order.  Every scalar stays a 0-dim
tensor on a device, as ``ops/cg.py`` keeps its scalars: nothing waits for
the host, so a step that calls them captures into a CUDA graph.

- ``cg_slabs``: conjugate gradient, each iteration one one-row halo
  exchange for A and two global dot products; the rhs mean deflated over
  every slab first.
- ``mg_slabs``: V-cycles with the fine level on the slabs and the coarse
  levels replicated.  The fine level's smooths (``smooth``, the
  SlabOpSet's: on the card the grouped K9-damp, every slab of a device in
  one launch, its halo rows read from the neighbouring slabs' arrays; the
  plain twin extends each slab by an 8-row halo, a smooth of up to 7
  sweeps per exchange) take and return every slab; its residual takes a
  one-row halo.  Each slab sums its residual's 2x2 cell groups, pair-aligned
  by one leading zero row and column (a slab's first row is even), into a
  block of the coarse grid; the blocks of neighbouring slabs overlap by one
  coarse row, and the first device adds them into one zero coarse grid, in
  slab order.  The coarse grid is solved there by the classic single-grid
  cycle, ``ops.multigrid.v_cycle`` with ``smooth_coarse`` (the OpSet's:
  K1-damp on the card), never by the graded ``mg_pressure_solve_fast`` of
  the single-device step; its bilinear prolongation is cut back into slabs.
  A slab mesh has an even ``(n+2)/px``, so n/2 is odd and the cycle is
  always two-level (the coarse grid takes 2 + 40 sweeps) on more than one
  slab.

The residual, the 2x2 sums, the prolongation and the slicing are plain
torch on both backends: the ``cuda`` and ``reference`` slab steps share
them, and differ only in their smoothers.  Sums are taken in another order
than JAX's, so the port is not bit for bit with JAX's sharded solvers.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..kernels.cuda_sharded import SMOOTH_HALO, _slab_bnd, _wall_rows
from ..ops import multigrid as mg
from ..ops.boundary import embed_interior
from ..ops.diffuse import as_scalar
from .mesh import _halos

__all__ = ["cg_slabs", "mg_slabs", "SMOOTH_HALO"]


def _psum_all(parts: list[torch.Tensor]) -> torch.Tensor:
    """The sum of each slab's 0-dim partial, on the first slab's device:
    the partials stacked there in slab order and summed."""
    first = parts[0].device
    return torch.stack([x.to(first) for x in parts]).sum()


def _masked_dot(a, b, masks) -> torch.Tensor:
    """The global dot product over the interior cells: each slab's masked
    partial sum, then ``_psum_all``."""
    return _psum_all([torch.where(mask, x * y, 0.0).sum()
                      for x, y, mask in zip(a, b, masks)])


def _on_each(scalar: torch.Tensor, xs) -> list[torch.Tensor]:
    """``scalar`` on each slab's device (no copy where it lies there)."""
    return [scalar.to(x.device) for x in xs]


def _interior_masks(slabs, n: int, flags) -> list[torch.Tensor]:
    """Each slab's cells of the global interior, rows and columns 1..n."""
    out = []
    for x, (_, _, row0) in zip(slabs, flags):
        m, side = x.shape
        rows = torch.arange(row0, row0 + m, device=x.device)[:, None]
        cols = torch.arange(side, device=x.device)[None, :]
        out.append((rows >= 1) & (rows <= n) & (cols >= 1) & (cols <= n))
    return out


def _bnd(xs, flags) -> list[torch.Tensor]:
    """The copy border rule (mode 0) on each slab, on a copy: ghost columns,
    the wall rows a slab holds, corners (JAX's ``_apply_bnd_local``)."""
    return [_slab_bnd(0, x.clone(), *_wall_rows(fl, 0, x.shape[0]))
            for x, fl in zip(xs, flags)]


def _apply_A(ps, masks) -> list[torch.Tensor]:
    """``4p - (((pL + pR) + pU) + pD)`` at each slab's interior cells, zero
    elsewhere, the neighbour rows from one-row halos."""
    out = []
    for p, (top, bot), mask in zip(ps, _halos(ps, 1), masks):
        ext = torch.cat([top, p, bot])
        a = torch.zeros_like(p)
        a[:, 1:-1] = 4.0 * p[:, 1:-1] - (
            ((ext[1:-1, :-2] + ext[1:-1, 2:]) + ext[:-2, 1:-1])
            + ext[2:, 1:-1])
        out.append(torch.where(mask, a, 0.0))
    return out


def cg_slabs(div, iters: int, n: int, flags) -> list[torch.Tensor]:
    """``iters`` conjugate-gradient iterations on A p = div from p = 0 over
    the row slabs ``div`` (JAX's ``_cg_local``): A with the copy rule
    folded in (each slab's border re-derived, then a one-row halo and the
    5-point stencil), two global dot products an iteration with eps 1e-30,
    the rhs mean over every slab deflated first; the result's border by the
    copy rule."""
    masks = _interior_masks(div, n, flags)
    b = [torch.where(mask, d, 0.0) for d, mask in zip(div, masks)]
    ncells = as_scalar(float(n) * float(n), div[0])
    mean = _psum_all([x.sum() for x in b]) / ncells
    b = [torch.where(mask, x - mu, 0.0)
         for x, mu, mask in zip(b, _on_each(mean, b), masks)]
    x = [torch.zeros_like(d) for d in b]
    r, p = b, b
    rs = _masked_dot(r, r, masks)
    eps = as_scalar(1e-30, rs)
    for _ in range(iters):
        ap = _apply_A(_bnd(p, flags), masks)
        alpha = _on_each(rs / (_masked_dot(p, ap, masks) + eps), p)
        x = [xi + a * pi for xi, a, pi in zip(x, alpha, p)]
        r = [ri - a * api for ri, a, api in zip(r, alpha, ap)]
        rs_new = _masked_dot(r, r, masks)
        beta = _on_each(rs_new / (rs + eps), p)
        p = [torch.where(mask, ri + bt * pi, 0.0)
             for ri, bt, pi, mask in zip(r, beta, p, masks)]
        rs = rs_new
    return _bnd(x, flags)


def mg_slabs(div, cycles: int, n: int, flags, smooth: Callable,
             smooth_coarse: Callable, *, pre: int = 2,
             post: int = 2) -> list[torch.Tensor]:
    """``cycles`` V-cycles from p = 0 over the row slabs ``div`` (JAX's
    ``_mg_local``): ``pre`` damped sweeps on the slabs (``smooth(p_slabs,
    div_slabs, flags, *, sweeps, zero_init)``, the SlabOpSet's), the
    residual restricted into the replicated coarse grid,
    ``ops.multigrid.v_cycle`` there with ``smooth_coarse`` (the OpSet's),
    its prolongation added on each slab's interior, ``post`` sweeps.  With
    no coarser level (``mg_levels(n) == 0``) a cycle is ``pre`` sweeps and
    40 more.  Every slab has an even row count (the caller checks)."""
    m, side = div[0].shape
    first = div[0].device
    levels = mg.mg_levels(n)
    masks = _interior_masks(div, n, flags)

    def smooth_slabs(p, sweeps, zero_init=False):
        return smooth(p, div, flags, sweeps=sweeps, zero_init=zero_init)

    def cycle(p, zero_init):
        p = smooth_slabs(p, pre, zero_init)
        if levels == 0:
            return smooth_slabs(p, 40)
        r = [torch.where(mask, d - a, 0.0)
             for d, a, mask in zip(div, _apply_A(p, masks), masks)]
        nc = n // 2
        full = torch.zeros((nc + 2, nc + 2), dtype=div[0].dtype,
                           device=first)
        for ri, (_, _, row0) in zip(r, flags):
            rp = torch.nn.functional.pad(ri, (1, 1, 1, 1))
            block = rp.reshape((m + 2) // 2, 2, (side + 2) // 2, 2).sum(
                dim=(1, 3))
            c0 = row0 // 2
            full[c0:c0 + (m + 2) // 2] += block.to(first)
        r_c = embed_interior(0, full[1:-1, 1:-1])
        e_c = mg.v_cycle(torch.zeros_like(r_c), r_c, levels - 1, pre, post,
                         smooth=smooth_coarse)
        e = mg._prolong(e_c)
        p = [torch.where(mask, pi + e[row0:row0 + m].to(pi.device), pi)
             for pi, mask, (_, _, row0) in zip(p, masks, flags)]
        return smooth_slabs(_bnd(p, flags), post)

    p = [torch.zeros_like(d) for d in div]
    for k in range(cycles):
        p = cycle(p, zero_init=k == 0)
    return p
