"""The pressure solves of the multi-device step beyond Jacobi and
Chebyshev (PyTorch twin of the sharded solvers of
``fluidsimulationcuda_tpu.parallel.sharded``: ``_cg_local``, ``_mg_local``
and their helpers), on the slab route's row slabs (``cg_slabs``,
``mg_slabs``) and on the block route's (px, py) blocks (``cg_blocks``,
``mg_blocks``).

Each takes the divergence as a list of parts (row slabs of (m, side), slab
``i`` with ``flags[i] = (is_top, is_bot, row0)``; or the blocks of
``parallel.mesh.Blocks``), each on its own device, and returns the pressure
the same way.  The two layouts share every line but their geometry
(``_Parts``: each part's global origin and interior cells, its copy border
rule, its A-apply with one-cell halos and its smoother).  One process
drives every part, as the step does (``parallel/sharded.py``): a halo
moves between devices with ``.to``, and JAX's ``psum`` is ``_psum_all``,
each part's partial moved to the first part's device and summed there in
mesh order.  Every scalar stays a 0-dim tensor on a device, as
``ops/cg.py`` keeps its scalars: nothing waits for the host, so a step
that calls them captures into a CUDA graph.

- conjugate gradient: each iteration one one-cell halo exchange for A and
  two global dot products; the rhs mean deflated over every part first.
- multigrid: V-cycles with the fine level on the parts and the coarse
  levels replicated.  The fine level's smooths take and return every part
  (slabs: the SlabOpSet's ``smooth``, on the card the grouped K9-damp, the
  plain twin 8-row halo-extended slabs; blocks: the BlockOpSet's
  ``smooth_group`` on the card, the grouped K9-block's damped form over
  every block of a device, else its ``smooth``, the plain twin on blocks
  extended by a halo as deep as the sweeps of an exchange, at most
  ``BLOCK_SMOOTH``); its residual takes a one-cell halo.  Each part sums
  its residual's 2x2 cell groups, pair-aligned by one leading zero row and
  column (a part's first row and column are even), into a block of the
  coarse grid; the blocks of neighbouring parts overlap by one coarse row
  or column, and the first device adds them into one zero float32 coarse
  grid, in mesh order, and rounds the sum to the storage dtype once (a
  bf16 coarse grid, as XLA's ``psum`` of JAX's bf16 grids rounds it).
  The coarse grid is solved there by the classic single-grid
  cycle, ``ops.multigrid.v_cycle`` with ``smooth_coarse`` (the OpSet's:
  K1-damp on the card), never by the graded ``mg_pressure_solve_fast`` of
  the single-device step; its bilinear prolongation is cut back into
  parts.

The residual, the 2x2 sums, the prolongation and the slicing are plain
torch on both backends: the ``cuda`` and ``reference`` steps share them,
and differ only in their smoothers.  Sums are taken in another order than
JAX's, and over another partition on slabs than on blocks, so neither
route is bit for bit with JAX's sharded solvers or with the other.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..kernels.cuda_sharded import (SMOOTH_HALO, _block_bnd, _ext1,
                                    _slab_bnd, _wall_rows)
from ..ops import multigrid as mg
from ..ops.boundary import embed_interior
from ..ops.diffuse import as_scalar
from .mesh import Blocks, _halos

__all__ = ["cg_slabs", "mg_slabs", "cg_blocks", "mg_blocks", "SMOOTH_HALO",
           "BLOCK_SMOOTH"]

# The most damped sweeps a block smooth runs per halo exchange (its halo
# as deep): a 2-sweep smooth is one exchange and one launch a block.
BLOCK_SMOOTH = 8


class _Parts(NamedTuple):
    """The geometry of a field's parts: each part's global origin (r0, c0)
    and global interior cells, the copy border rule (on copies), the
    masked A-apply and the damped smoother ``smooth(p, div, sweeps,
    zero_init)`` over every part."""

    origins: list
    masks: list
    bnd: Callable
    apply_A: Callable
    smooth: Callable


def _psum_all(parts: list[torch.Tensor]) -> torch.Tensor:
    """The sum of each part's 0-dim partial, on the first part's device:
    the partials stacked there in mesh order and summed."""
    first = parts[0].device
    return torch.stack([x.to(first) for x in parts]).sum()


def _masked_dot(a, b, masks) -> torch.Tensor:
    """The global dot product over the interior cells: each part's masked
    partial sum, then ``_psum_all``."""
    return _psum_all([torch.where(mask, x * y, 0.0).sum()
                      for x, y, mask in zip(a, b, masks)])


def _on_each(scalar: torch.Tensor, xs) -> list[torch.Tensor]:
    """``scalar`` on each part's device (no copy where it lies there)."""
    return [scalar.to(x.device) for x in xs]


def _interior_masks(parts, n: int, origins) -> list[torch.Tensor]:
    """Each part's cells of the global interior, rows and columns 1..n."""
    out = []
    for x, (r0, c0) in zip(parts, origins):
        m, k = x.shape
        rows = torch.arange(r0, r0 + m, device=x.device)[:, None]
        cols = torch.arange(c0, c0 + k, device=x.device)[None, :]
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


def _slab_parts(div, n: int, flags, smooth: Callable | None) -> _Parts:
    origins = [(fl[2], 0) for fl in flags]
    masks = _interior_masks(div, n, origins)
    return _Parts(
        origins, masks, lambda xs: _bnd(xs, flags),
        lambda ps: _apply_A(ps, masks),
        None if smooth is None else
        (lambda p, d, sweeps, zero_init: smooth(
            p, d, flags, sweeps=sweeps, zero_init=zero_init)))


def _block_parts(div, n: int, blocks: Blocks, smooth: Callable | None,
                 grouped: Callable | None = None) -> _Parts:
    origins = blocks.origins
    masks = _interior_masks(div, n, origins)

    def bnd(xs):
        return [_block_bnd(0, x.clone(), r0, c0, n)
                for x, (r0, c0) in zip(xs, origins)]

    def apply_A(ps):
        out = []
        for p, halos, mask in zip(ps, blocks.halos(ps), masks):
            ext = _ext1(p, halos)
            a = 4.0 * p - (((ext[1:-1, :-2] + ext[1:-1, 2:])
                            + ext[:-2, 1:-1]) + ext[2:, 1:-1])
            out.append(torch.where(mask, a, 0.0))
        return out

    def smooth_blocks(p, d, sweeps, zero_init):
        """``sweeps`` damped sweeps on every block, in exchanges of up to
        ``BLOCK_SMOOTH`` sweeps (no deeper than a block), each on blocks
        extended by a halo as deep, or with ``grouped`` one grouped launch
        an exchange reading the neighbours' own arrays."""
        done = 0
        while done < sweeps:
            K = min(BLOCK_SMOOTH, sweeps - done, blocks.m, blocks.k)
            zero = zero_init and done == 0
            if grouped is not None:
                p = grouped(blocks, p, d, n=n, K=K, sweeps=K,
                            zero_init=zero)
            else:
                p_ext = [None] * len(d) if zero else blocks.ext(p, K)
                p = [smooth(pe, de, o, n=n, m=blocks.m, k=blocks.k, K=K,
                            sweeps=K, zero_init=zero)
                     for pe, de, o in zip(p_ext, blocks.ext(d, K), origins)]
            done += K
        return p

    return _Parts(origins, masks, bnd, apply_A,
                  None if smooth is None else smooth_blocks)


def _cg(div, iters: int, n: int, g: _Parts) -> list[torch.Tensor]:
    """JAX's ``_cg_local`` on the parts of ``g``."""
    masks = g.masks
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
        ap = g.apply_A(g.bnd(p))
        alpha = _on_each(rs / (_masked_dot(p, ap, masks) + eps), p)
        x = [xi + a * pi for xi, a, pi in zip(x, alpha, p)]
        r = [ri - a * api for ri, a, api in zip(r, alpha, ap)]
        rs_new = _masked_dot(r, r, masks)
        beta = _on_each(rs_new / (rs + eps), p)
        p = [torch.where(mask, ri + bt * pi, 0.0)
             for ri, bt, pi, mask in zip(r, beta, p, masks)]
        rs = rs_new
    return g.bnd(x)


def _mg(div, cycles: int, n: int, g: _Parts, smooth_coarse: Callable,
        pre: int, post: int) -> list[torch.Tensor]:
    """JAX's ``_mg_local`` on the parts of ``g``."""
    first = div[0].device
    levels = mg.mg_levels(n)
    nc = n // 2

    def cycle(p, zero_init):
        p = g.smooth(p, div, pre, zero_init)
        if levels == 0:
            return g.smooth(p, div, 40, False)
        r = [torch.where(mask, d - a, 0.0)
             for d, a, mask in zip(div, g.apply_A(p), g.masks)]
        # The parts' blocks are added in float32 and the sum rounded to
        # the storage dtype once, as XLA's psum of bf16 grids sums them.
        full = torch.zeros((nc + 2, nc + 2), dtype=torch.float32,
                           device=first)
        for ri, (r0, c0) in zip(r, g.origins):
            m, k = ri.shape
            rp = torch.nn.functional.pad(ri, (1, 1, 1, 1))
            block = rp.reshape((m + 2) // 2, 2, (k + 2) // 2, 2).sum(
                dim=(1, 3))
            full[r0 // 2:r0 // 2 + (m + 2) // 2,
                 c0 // 2:c0 // 2 + (k + 2) // 2] += block.to(first).float()
        r_c = embed_interior(0, full[1:-1, 1:-1].to(div[0].dtype))
        e_c = mg.v_cycle(torch.zeros_like(r_c), r_c, levels - 1, pre, post,
                         smooth=smooth_coarse)
        e = mg._prolong(e_c)
        p = [torch.where(mask, pi + e[r0:r0 + pi.shape[0],
                                      c0:c0 + pi.shape[1]].to(pi.device), pi)
             for pi, mask, (r0, c0) in zip(p, g.masks, g.origins)]
        return g.smooth(g.bnd(p), div, post, False)

    p = [torch.zeros_like(d) for d in div]
    for k in range(cycles):
        p = cycle(p, zero_init=k == 0)
    return p


def cg_slabs(div, iters: int, n: int, flags) -> list[torch.Tensor]:
    """``iters`` conjugate-gradient iterations on A p = div from p = 0 over
    the row slabs ``div`` (JAX's ``_cg_local``): A with the copy rule
    folded in (each slab's border re-derived, then a one-row halo and the
    5-point stencil), two global dot products an iteration with eps 1e-30,
    the rhs mean over every slab deflated first; the result's border by the
    copy rule."""
    return _cg(div, iters, n, _slab_parts(div, n, flags, None))


def cg_blocks(div, iters: int, n: int, blocks: Blocks) -> list[torch.Tensor]:
    """``cg_slabs`` on the blocks ``div`` of ``blocks`` (JAX's
    ``_cg_local`` on its (px, py) mesh): A's neighbour cells from one-cell
    2-D halos."""
    return _cg(div, iters, n, _block_parts(div, n, blocks, None))


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
    40 more.  Every slab has an even row count (the caller checks).  A
    slab mesh has an even ``(n+2)/px``, so n/2 is odd and the cycle is
    always two-level (the coarse grid takes 2 + 40 sweeps) on more than one
    slab."""
    return _mg(div, cycles, n, _slab_parts(div, n, flags, smooth),
               smooth_coarse, pre, post)


def mg_blocks(div, cycles: int, n: int, blocks: Blocks, smooth: Callable,
              smooth_coarse: Callable, *, pre: int = 2, post: int = 2,
              grouped: Callable | None = None) -> list[torch.Tensor]:
    """``mg_slabs`` on the blocks ``div`` of ``blocks`` (JAX's
    ``_mg_local`` on its (px, py) mesh): the smooths by the BlockOpSet's
    ``smooth(p_ext, div_ext, origin, *, n, m, k, K, sweeps, zero_init)``
    on extended blocks, or by its ``smooth_group(blocks, p, div, *, n, K,
    sweeps, zero_init)`` on the blocks themselves where ``grouped`` gives
    it, the residual's neighbour cells from one-cell 2-D halos, each
    block's 2x2 sums at coarse origin (r0/2, c0/2).  Every block has even
    sides (the caller checks)."""
    return _mg(div, cycles, n, _block_parts(div, n, blocks, smooth, grouped),
               smooth_coarse, pre, post)
