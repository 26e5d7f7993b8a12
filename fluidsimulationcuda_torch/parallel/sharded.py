"""The multi-device 2-D step (PyTorch twin of
``fluidsimulationcuda_tpu.parallel.sharded``), on either of JAX's two
per-shard programs: the slab route (``shard_backend="pallas"`` there,
``_step_local_pallas``) on row slabs, and the block route (its jnp
``_step_local``) on the (px, py) blocks of a 2-D mesh.

One process drives every part: before each kernel call it builds the
part's halo from its neighbours' edge cells (``.to(device)`` where the
devices differ; zeros beyond a wall) and calls the slab function of
``kernels/cuda_sharded.py`` with the slab's ``(is_top, is_bot, row0)``
flags, or the block function with the block's global origin ``(r0,
c0)``.  Torch has no global sharded array: ``shard_state`` splits a state
into row slabs, ``shard_blocks`` into the blocks of a mesh, and
``unshard`` stitches either back.

The slab route.  The padded (side, side) grid is cut into ``px`` slabs of
``m = side/px`` full-width rows, slab ``i`` on mesh device ``i``.  The
composition, margins and route gates are JAX's, so a given ``(m, iters,
cmax)`` takes the same route in both packages:

- sources folded as ``state + dt*src``, then u and v diffused in Jacobi
  chunks of ``fuse = cfg.fuse_sweeps or 20`` sweeps (halo
  ``ceil8(s+1)`` per chunk, the rhs built once and exchanged per chunk), or
  as one-call Chebyshev solves (halo ``ceil8(iters+1)``; where that halo
  is deeper than a slab, JAX's jnp fallback: the block route's chunked
  Chebyshev on the (px, 1) blocks, which are the slabs);
- the projection fused (one ``ceil8(iters+3)``-row u/v exchange) for a
  Jacobi or Chebyshev pressure solve whose halo fits a slab, else
  composed: divergence, the pressure solve (Jacobi chunks from zero, one
  Chebyshev call or its block fallback, or the slab multigrid or CG of
  ``parallel/solvers.py``) and gradient, each stencil with a one-row halo;
- the u/v self-advection pair (one shared backtrace, ``cmax+1``-row halo),
  then the second projection;
- the density fused (diffusion and gather, halo ``ceil8(it+1+cmax)``) for
  Jacobi density when ``it <= fuse``, ``1 <= cmax <= 7`` and the halo fits,
  else diffused as the velocities and gathered on its own.

Left out are JAX's VMEM strip gates (``_slab_tm``, ``_proj_slab_tm``,
``_dens_slab_tm``, ``advect_slab_tm``) and its TPU tiling gates
(``side >= 128``, ``m % 8``), which choose strip heights, not what is
computed.  The windowed gathers (``advect_mode="windowed"``, and
``"auto"``) are exact while the backtrace moves at most
``cfg.max_courant`` cells and clamped above (``ops.advect_windowed``);
``audited=True`` returns the displacement to check it.
``advect_mode="exact"`` gathers as JAX's block route does
(``_advect_local``: the all-gather, then the gather at global
coordinates), on the slab route: each gathered field is assembled once per
device (``mesh._gather``) and every slab gathers from it with K12's exact
form (``advect_slab_exact``), so the step equals the single-device step at
any displacement.  The density step is then composed, diffusion and gather,
as JAX's ``_step_local`` composes it (the fused density step gathers in the
window).  JAX runs its exact mode only on its jnp block route; the port's
slab route is not JAX's Pallas code, which refuses it.
``pressure_solver="multigrid"`` needs an even slab height, as JAX's slab
route does (the coarse grid's 2x2 groups must not straddle two slabs), and
raises ``ValueError`` otherwise.

The block route (``_BlockStep``): JAX's ``_step_local`` on the (px, py)
blocks of ``m = side/px`` rows and ``k = side/py`` columns, each solve in
chunks of ``K = min(8, iters, (m-2)//2, (k-2)//2)`` sweeps (1 for blocks of
4 or fewer), each chunk one halo exchange and its sweeps: on ``cuda`` one
grouped K9-block launch a device over every block, each block's halo read
from its neighbours' own arrays; elsewhere JAX's two-phase 2-D exchange
(``mesh.Blocks.ext``, the rhs's once a solve) and a chunk a block.  A
Chebyshev chain carries x_{k-1} from chunk to chunk and resumes its
weights where the chunk before stopped.  The divergence and gradient take
one-cell 2-D halos (K10-block, K11-block), the gathers either the assembled
fields (exact, ``Blocks.gather``) or a ``cmax+1``-deep 2-D halo (windowed;
K12-block's two forms); on ``cuda`` the gradient and each gather are one
grouped launch a device over every block, each reading its neighbours'
cells from their own arrays (no ``Blocks.halos`` of p, no ``ext``, no
``gather``).  Multigrid and CG run on blocks
(``solvers.mg_blocks``, ``cg_blocks``).  Every operation is the
BlockOpSet's (``kernels/dispatch.py``): the kernels on ``cuda``, the
``reference`` forms on ``reference`` (in float32 the kernels' plain
twins).  JAX's block route ignores ``fast_math``;
here, as on the slab route, the ``cuda`` backend takes the reciprocal
form for the diffusion solves in fast mode (never for the pressure).

bf16 storage (``cfg.dtype``) runs on the block route alone, as in JAX,
whose slab route is float32.  Every field, halo and exchange is bf16 and
so are the divergence, the pressure of every solver (the multigrid's
coarse levels too) and the audited displacement, as JAX's.  The
``reference`` backend rounds every operation to bf16 as JAX's jnp ops do,
except the gathers, whose coordinates and blend are float32 (JAX's
single-device ``ops.advect``; its block route computes them in bf16,
ROADMAP §C).  The ``cuda`` backend runs the bf16 forms of the four block
kernels, which compute in float32 and round at the store: a solve once a
chunk, where JAX rounds every sweep.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.config import SimConfig
from ..core.state import FluidState, Sources
from ..kernels import cuda_ops
from ..kernels.cuda_sharded import (advect_blocks_composed,
                                    gradient_blocks_composed)
from ..kernels.dispatch import get_block_ops, get_ops, get_slab_ops
from ..ops.chebyshev import cheby_omegas
from ..ops.diffuse import as_scalar
from ..ops.source import add_source
from .mesh import Blocks, Mesh, _ext, _gather, _halos
from .solvers import SMOOTH_HALO, cg_blocks, cg_slabs, mg_blocks, mg_slabs

__all__ = ["make_sharded_step_fn", "shard_state", "shard_blocks", "unshard"]


def _ceil8(x: int) -> int:
    return -(-x // 8) * 8


def _split(tree, mesh: Mesh, ndim: int):
    """Each ``ndim``-D field of ``tree`` cut along its leading axis into
    one slab per device of ``mesh`` (row-major), slab ``i`` a copy on the
    ``i``-th device."""
    devices = mesh.device_list

    def split(t):
        if t is None:
            return None
        if t.dim() != ndim or len(set(t.shape)) != 1:
            raise ValueError(f"expected a {ndim}-D field of shape "
                             f"(side,)*{ndim}, got {tuple(t.shape)}")
        side = t.shape[0]
        if side % len(devices):
            raise ValueError(f"side {side} not divisible by "
                             f"{len(devices)} slabs")
        m = side // len(devices)
        return tuple(t[i * m:(i + 1) * m].to(d, copy=True)
                     for i, d in enumerate(devices))

    return type(tree)(*map(split, tree))


def shard_state(tree, mesh: Mesh):
    """Split each (side, side) field of a ``FluidState`` or ``Sources``
    into the row slabs of ``mesh``: a tuple of ``px·py`` tensors of shape
    (side/(px·py), side), slab ``i`` a copy on the mesh's ``i``-th device
    (row-major).  A 2-D mesh gets the slabs of its row-flattened form, the
    only layout the step runs."""
    return _split(tree, mesh, 2)


def shard_blocks(tree, mesh: Mesh):
    """Cut each (side, side) field of a ``FluidState`` or ``Sources`` into
    the blocks of the (px, py) ``mesh``: a tuple of ``px·py`` tensors of
    shape (side/px, side/py) in row-major mesh order, block ``i`` a copy
    on the mesh's ``i``-th device; the layout of the block route.  A (px,
    1) mesh's blocks are its row slabs."""
    px, py = mesh.shape["x"], mesh.shape["y"]

    def cut(t):
        if t is None:
            return None
        if t.dim() != 2 or t.shape[0] != t.shape[1]:
            raise ValueError(f"expected a (side, side) field, got "
                             f"{tuple(t.shape)}")
        if t.shape[0] % px or t.shape[0] % py:
            raise ValueError(f"side {t.shape[0]} not divisible by mesh "
                             f"shape ({px}, {py})")
        return Blocks(px, py, t.shape[0]).cut(t, mesh.device_list)

    return type(tree)(*map(cut, tree))


def unshard(tree, mesh: Mesh | None = None):
    """Stitch each field's parts back into one tensor on the first part's
    device: row slabs (or z-slabs of a volume) without ``mesh`` or on a
    (px, 1) mesh, the blocks of ``mesh`` otherwise (``shard_blocks``)."""
    def join(parts):
        if parts is None:
            return None
        if mesh is None or mesh.shape["y"] == 1:
            return torch.cat([s.to(parts[0].device) for s in parts])
        px, py = mesh.shape["x"], mesh.shape["y"]
        return Blocks(px, py, parts[0].shape[0] * px).stitch(parts)

    return type(tree)(*map(join, tree))


def _slab_viable(cfg: SimConfig, slabs: int) -> bool:
    side = cfg.n + 2
    return side % slabs == 0 and side // slabs >= cfg.max_courant + 1


def _chunk(iters: int, m: int, k: int, fuse: int = 8) -> int:
    """JAX's sweeps per halo exchange of a block solve (its K): at most
    ``fuse``, ``iters`` and what (m, k) blocks hold, ``(m-2)//2``
    (1 for blocks of 4 rows or fewer)."""
    return max(1, min(fuse, iters, (m - 2) // 2 if m > 4 else 1,
                      (k - 2) // 2 if k > 4 else 1))


def _chunk_runner(ops, blocks: Blocks, n: int, b, rhs, K: int, alpha,
                  beta, fast: bool):
    """One chunk of a block solve on every block: ``run(x, xm, sweeps,
    zero_init, **kw)``.  On the ``cuda`` backend the BlockOpSet's
    ``jacobi_group`` (one grouped K9-block launch a device, each halo read
    from the neighbours' own arrays); elsewhere JAX's composition, x (and
    x_{k-1}) extended by a ``K``-deep halo every chunk, the rhs once a
    solve, and ``jacobi`` on each block."""
    group = getattr(ops, "jacobi_group", None)
    kw = dict(n=n, K=K, alpha=alpha, beta=beta, fast=fast)
    if group is not None:
        def run(x, xm, sweeps, zero_init, **cheby):
            return group(blocks, b, x, rhs, xms=xm, sweeps=sweeps,
                         zero_init=zero_init, **kw, **cheby)
        return run
    rhs_ext = blocks.ext(rhs, K)
    none = [None] * len(rhs)

    def run(x, xm, sweeps, zero_init, **cheby):
        out = [ops.jacobi(b, xe, re, o, m=blocks.m, k=blocks.k,
                          sweeps=sweeps, zero_init=zero_init, xm_ext=xme,
                          **kw, **cheby)
               for xe, re, xme, o in zip(
                   none if zero_init else blocks.ext(x, K), rhs_ext,
                   none if xm is None else blocks.ext(xm, K),
                   blocks.origins)]
        if "omegas" not in cheby:
            return out
        return [q[0] for q in out], [q[1] for q in out]
    return run


def _diffuse_blocks(ops, blocks: Blocks, n: int, b, x_init, rhs, alpha, beta,
                    iters: int, *, zero_init=False, fast=False):
    """JAX's ``_diffuse_local``: Jacobi in chunks of ``_chunk`` sweeps on
    the blocks extended by as deep a halo, the rhs exchanged once
    (``_chunk_runner``); ``x_init`` is ignored with ``zero_init``."""
    K = _chunk(iters, blocks.m, blocks.k)
    run = _chunk_runner(ops, blocks, n, b, rhs, K, alpha, beta, fast)
    x, done = x_init, 0
    while done < iters:
        s = min(K, iters - done)
        x = run(x, None, s, zero_init and done == 0)
        done += s
    return x


def _cheby_blocks(ops, blocks: Blocks, n: int, b, x_init, rhs, alpha, beta,
                  iters: int, rho: float, *, zero_init=False, fast=False):
    """JAX's ``_cheby_diffuse_local``: the Chebyshev solve in chunks as
    ``_diffuse_blocks``'s.  Sweep 0 of the solve is plain (x_0 doubles as
    x_{-1}); each later chunk takes the x_{k-1} the chunk before it
    returned, exchanged as x is, and the weights from where it stopped."""
    K = _chunk(iters, blocks.m, blocks.k)
    omegas = cheby_omegas(float(rho), iters)
    run = _chunk_runner(ops, blocks, n, b, rhs, K, alpha, beta, fast)
    x, xm, done = x_init, None, 0
    while done < iters:
        s = min(K, iters - done)
        x, xm = run(x, xm, s, zero_init and done == 0, omegas=omegas,
                    first=done)
        done += s
    return x


class _SlabStep:
    """One step of ``cfg`` on the row slabs of a (px, 1) mesh, its gathers
    exact (from the assembled fields) or windowed; the routes are chosen,
    and every halo checked against the slab height, here."""

    def __init__(self, cfg: SimConfig, mesh: Mesh, audited: bool,
                 exact: bool):
        n, it, cmax = cfg.n, cfg.jacobi_iters, cfg.max_courant
        self.cfg, self.audited, self.exact = cfg, audited, exact
        self.devices = mesh.device_list
        self.px = px = len(self.devices)
        self.m = m = (n + 2) // px
        self.ops = get_slab_ops(cfg)
        self.flags = [(int(i == 0), int(i == px - 1), i * m)
                      for i in range(px)]
        self.fuse = fuse = cfg.fuse_sweeps or 20
        # Solver selection, as _step_local_pallas (sharded.py:700-714).
        self.vel_cheby = cfg.diffusion_solver == "chebyshev"
        self.dens_cheby = cfg.diffusion_solver in ("chebyshev",
                                                   "chebyshev-dens")
        self.k_dens = (cfg.cheby_iters if cfg.diffusion_solver == "chebyshev"
                       else cfg.cheby_dens_iters)
        self.solver = cfg.pressure_solver
        self.cheby_p = self.solver == "chebyshev"
        self.it_p = cfg.press_cheby_iters if self.cheby_p else it
        self.rho_p = cfg.cheby_rho if self.cheby_p else None
        # Multigrid and CG compose the projection, as in JAX
        # (sharded.py:744-747 there).
        self.fused_proj = (self.solver in ("jacobi", "chebyshev")
                           and _ceil8(self.it_p + 3) <= m)
        # The replicated coarse level of the slab multigrid smooths with
        # the single-device OpSet's smoother.
        self.smooth_coarse = (get_ops(cfg).smooth
                              if self.solver == "multigrid" else None)
        # A one-call Chebyshev solve whose halo is deeper than a slab takes
        # JAX's jnp fallback (sharded.py:697-698, :727-728 there): the
        # block route's chunked solve on the (px, 1) blocks, the slabs.
        self.blocks = Blocks(px, 1, n + 2)
        self.block_ops = get_block_ops(cfg)
        # B9c gathers in the window: the exact step composes the density.
        self.fused_dens = (not exact and not self.dens_cheby and it <= fuse
                           and 1 <= cmax <= 7
                           and _ceil8(it + 1 + cmax) <= m)

        # Every halo the routes exchange must come from the adjacent slab.
        chunked = [it] * ((not self.vel_cheby)
                          + (not self.fused_proj and self.solver == "jacobi")
                          + (not self.fused_dens and not self.dens_cheby))
        for iters in chunked:
            K = _ceil8(min(fuse, iters) + 1)
            if K > m:
                raise ValueError(
                    f"a Jacobi chunk of {min(fuse, iters)} sweeps needs a "
                    f"{K}-row halo, deeper than the {m}-row slabs; lower "
                    f"fuse_sweeps or use fewer slabs")
        if self.solver == "multigrid" and SMOOTH_HALO > m:
            raise ValueError(
                f"the slab multigrid's smooths need a {SMOOTH_HALO}-row "
                f"halo, deeper than the {m}-row slabs; use fewer slabs")

    # -- the operations of _step_local_pallas ----------------------------------

    def _diffuse(self, b, x_init, rhs, alpha, beta, iters, zero_init=False,
                 use_fast=False):
        """Jacobi in chunks of ``fuse`` sweeps, one halo exchange each."""
        x, first, remaining = x_init, True, iters
        while remaining > 0:
            s = min(self.fuse, remaining)
            K = _ceil8(s + 1)
            rhs_ext = _ext(rhs, K)
            zi = zero_init and first
            x_ext = rhs_ext if zi else _ext(x, K)
            x = [self.ops.jacobi(b, xe, re, fl, m=self.m, K=K, alpha=alpha,
                                 beta=beta, sweeps=s, zero_init=zi,
                                 fast=use_fast)
                 for xe, re, fl in zip(x_ext, rhs_ext, self.flags)]
            first = False
            remaining -= s
        return x

    def _cheby(self, b, x_init, rhs, alpha, beta, iters):
        """A Chebyshev solve in one slab call (the recurrence's x_{k-1}
        never crosses a halo exchange), or where its halo is deeper than a
        slab in chunks on the (px, 1) blocks (``_cheby_blocks``)."""
        K = _ceil8(iters + 1)
        if K > self.m:
            return _cheby_blocks(self.block_ops, self.blocks, self.cfg.n, b,
                                 x_init, rhs, alpha, beta, iters,
                                 self.cfg.cheby_rho, fast=self.ops.fast)
        return [self.ops.jacobi(b, xe, re, fl, m=self.m, K=K, alpha=alpha,
                                beta=beta, sweeps=iters, zero_init=False,
                                fast=self.ops.fast,
                                cheby_rho=self.cfg.cheby_rho)
                for xe, re, fl in zip(_ext(x_init, K),
                                      _ext(rhs, K), self.flags)]

    def _pressure(self, div):
        cfg = self.cfg
        if self.solver == "multigrid":
            return mg_slabs(div, cfg.mg_cycles, cfg.n, self.flags,
                            self.ops.smooth, self.smooth_coarse)
        if self.solver == "cg":
            return cg_slabs(div, cfg.cg_iters, cfg.n, self.flags)
        if self.cheby_p:
            K = _ceil8(self.it_p + 1)
            if K > self.m:
                return _cheby_blocks(self.block_ops, self.blocks, cfg.n, 0,
                                     None, div, 1.0, 4.0, self.it_p,
                                     self.rho_p, zero_init=True)
            ext = _ext(div, K)
            return [self.ops.jacobi(0, e, e, fl, m=self.m, K=K, alpha=1.0,
                                    beta=4.0, sweeps=self.it_p,
                                    zero_init=True, cheby_rho=self.rho_p)
                    for e, fl in zip(ext, self.flags)]
        return self._diffuse(0, None, div, 1.0, 4.0, self.cfg.jacobi_iters,
                             zero_init=True)

    def _project(self, u, v):
        n, m = self.cfg.n, self.m
        if self.fused_proj:
            K = _ceil8(self.it_p + 3)
            pairs = [self.ops.project(ue, ve, fl, n=n, iters=self.it_p, m=m,
                                      K=K, cheby_rho=self.rho_p)
                     for ue, ve, fl in zip(_ext(u, K), _ext(v, K),
                                           self.flags)]
            return [p[0] for p in pairs], [p[1] for p in pairs]
        div = [self.ops.divergence(ui, vi, top, bot, fl, n)
               for ui, vi, (top, bot), fl in zip(u, v, _halos(v, 1),
                                                 self.flags)]
        p = self._pressure(div)
        pairs = [self.ops.gradient(ui, vi, pi, top, bot, fl, n)
                 for ui, vi, pi, (top, bot), fl in zip(u, v, p,
                                                       _halos(p, 1),
                                                       self.flags)]
        return [q[0] for q in pairs], [q[1] for q in pairs]

    def _advect(self, bs, fields, u, v, self_adv):
        cfg, C = self.cfg, self.cfg.max_courant + 1
        if self.exact:
            fulls = [_gather(f) for f in fields]
            return [self.ops.advect_exact(bs, fs, ui, vi, fl, dt=cfg.dt,
                                          n=cfg.n, m=self.m,
                                          self_adv=self_adv)
                    for fs, ui, vi, fl in zip(zip(*fulls), u, v, self.flags)]
        exts = [_ext(f, C) for f in fields]
        return [self.ops.advect(bs, es, ui, vi, fl, dt=cfg.dt, n=cfg.n,
                                cmax=cfg.max_courant, m=self.m,
                                self_adv=self_adv)
                for es, ui, vi, fl in zip(zip(*exts), u, v, self.flags)]

    def _disp(self, u, v) -> torch.Tensor:
        """Largest backtrace displacement (cells) over every slab."""
        dev = self.devices[0]
        local = [torch.maximum(a.abs().max(), b.abs().max()).to(dev)
                 for a, b in zip(u, v)]
        return torch.stack(local).max() * (self.cfg.dt * self.cfg.n)

    # -- the step --------------------------------------------------------------

    def _slabs(self, tree, what: str):
        side = self.cfg.n + 2
        for name in ("dens", "u", "v"):
            slabs = getattr(tree, name)
            if (not isinstance(slabs, (tuple, list)) or len(slabs) != self.px
                    or any(tuple(s.shape) != (self.m, side) for s in slabs)):
                raise TypeError(
                    f"{what}.{name}: expected {self.px} slabs of shape "
                    f"({self.m}, {side}) (see shard_state)")
        return tree

    def __call__(self, state: FluidState, src: Sources):
        cfg, ops, it = self.cfg, self.ops, self.cfg.jacobi_iters
        self._slabs(state, "state")
        self._slabs(src, "sources")
        dt, n, m, fast = cfg.dt, cfg.n, self.m, ops.fast
        u = [add_source(a, s, dt) for a, s in zip(state.u, src.u)]
        v = [add_source(a, s, dt) for a, s in zip(state.v, src.v)]
        alpha = cfg.diffusion_alpha_visc
        beta = 1.0 + 4.0 * alpha
        if self.vel_cheby:
            u = self._cheby(1, src.u, u, alpha, beta, cfg.cheby_iters)
            v = self._cheby(2, src.v, v, alpha, beta, cfg.cheby_iters)
        else:
            u = self._diffuse(1, src.u, u, alpha, beta, it, use_fast=fast)
            v = self._diffuse(2, src.v, v, alpha, beta, it, use_fast=fast)
        u, v = self._project(u, v)
        d_vel = self._disp(u, v) if self.audited else None
        pairs = self._advect((1, 2), (u, v), [None] * self.px,
                             [None] * self.px, self_adv=True)
        u, v = self._project([p[0] for p in pairs], [p[1] for p in pairs])
        d_dens = self._disp(u, v) if self.audited else None

        alpha = cfg.diffusion_alpha_diff
        beta = 1.0 + 4.0 * alpha
        if self.fused_dens:
            K = _ceil8(it + 1 + cfg.max_courant)
            dens = [ops.dens(0, se, be, ui, vi, fl, alpha=alpha, beta=beta,
                             iters=it, dt=dt, n=n, cmax=cfg.max_courant,
                             m=m, K=K, fast=fast)
                    for se, be, ui, vi, fl in zip(_ext(src.dens, K),
                                                  _ext(state.dens, K),
                                                  u, v, self.flags)]
        else:
            dens = [add_source(a, s, dt) for a, s in zip(state.dens,
                                                         src.dens)]
            if self.dens_cheby:
                dens = self._cheby(0, src.dens, dens, alpha, beta,
                                   self.k_dens)
            else:
                dens = self._diffuse(0, src.dens, dens, alpha, beta, it,
                                     use_fast=fast)
            dens = [d[0] for d in self._advect((0,), (dens,), u, v,
                                               self_adv=False)]
        out = FluidState(dens=tuple(dens), u=tuple(u), v=tuple(v))
        if self.audited:
            return out, torch.maximum(d_vel, d_dens)
        return out


class _BlockStep:
    """One step of ``cfg`` on the (px, py) blocks of a mesh (JAX's
    ``_step_local``), its gathers exact (from the assembled fields) or
    windowed (from a ``cmax+1``-deep 2-D halo)."""

    def __init__(self, cfg: SimConfig, mesh: Mesh, audited: bool,
                 exact: bool, plain: bool = False):
        self.cfg, self.audited, self.exact = cfg, audited, exact
        self.devices = mesh.device_list
        self.blocks = Blocks(mesh.shape["x"], mesh.shape["y"], cfg.n + 2)
        if self.blocks.m < 2 or self.blocks.k < 2:
            raise ValueError(
                f"the block route needs blocks of at least 2 x 2 cells; got "
                f"{self.blocks.m} x {self.blocks.k} on mesh "
                f"({self.blocks.px}, {self.blocks.py})")
        # plain (a cuda config): the kernels' plain twins and K1-damp's,
        # the step a cuda run is held to bit for bit.
        self.ops = get_block_ops(cfg, plain=plain)
        self.smooth_coarse = None
        if cfg.pressure_solver == "multigrid":
            self.smooth_coarse = (cuda_ops.mg_smooth_plain if plain
                                  else get_ops(cfg).smooth)

    # -- the operations of _step_local ------------------------------------------

    def _diffusion(self, b, src_f, rhs, alpha, beta, dens=False):
        """As JAX's: "chebyshev" accelerates all three solves,
        "chebyshev-dens" only the density one."""
        cfg, mode = self.cfg, self.cfg.diffusion_solver
        if mode == "chebyshev" or (dens and mode == "chebyshev-dens"):
            k = (cfg.cheby_dens_iters if mode == "chebyshev-dens"
                 else cfg.cheby_iters)
            return _cheby_blocks(self.ops, self.blocks, cfg.n, b, src_f, rhs,
                                 alpha, beta, k, cfg.cheby_rho,
                                 fast=self.ops.fast)
        return _diffuse_blocks(self.ops, self.blocks, cfg.n, b, src_f, rhs,
                               alpha, beta, cfg.jacobi_iters,
                               fast=self.ops.fast)

    def _pressure(self, div):
        cfg, blocks = self.cfg, self.blocks
        if cfg.pressure_solver == "multigrid":
            return mg_blocks(div, cfg.mg_cycles, cfg.n, blocks,
                             self.ops.smooth, self.smooth_coarse,
                             grouped=self.ops.smooth_group)
        if cfg.pressure_solver == "cg":
            return cg_blocks(div, cfg.cg_iters, cfg.n, blocks)
        if cfg.pressure_solver == "chebyshev":
            return _cheby_blocks(self.ops, blocks, cfg.n, 0, None, div, 1.0,
                                 4.0, cfg.press_cheby_iters, cfg.cheby_rho,
                                 zero_init=True)
        return _diffuse_blocks(self.ops, blocks, cfg.n, 0, None, div, 1.0,
                               4.0, cfg.jacobi_iters, zero_init=True)

    def _project(self, u, v):
        n, origins = self.cfg.n, self.blocks.origins
        halos = self.blocks.halos
        div = [self.ops.divergence(ui, vi, uh, vh, o, n)
               for ui, vi, uh, vh, o in zip(u, v, halos(u), halos(v),
                                            origins)]
        p = self._pressure(div)
        if self.ops.gradient_group is not None:
            return self.ops.gradient_group(self.blocks, u, v, p, n)
        return gradient_blocks_composed(self.ops.gradient, self.blocks, u, v,
                                        p, n)

    def _advect(self, bs, fields, u, v, self_adv):
        cfg, ops = self.cfg, self.ops
        kw = dict(dt=cfg.dt, n=cfg.n, self_adv=self_adv,
                  cmax=None if self.exact else cfg.max_courant)
        if ops.advect_group is not None:
            return ops.advect_group(self.blocks, bs, fields, u, v, **kw)
        return advect_blocks_composed(ops.advect, ops.advect_exact,
                                      self.blocks, bs, fields, u, v, **kw)

    def _disp(self, u, v) -> torch.Tensor:
        """Largest backtrace displacement (cells) over every block, in the
        storage dtype (JAX's ``_disp_global``: the largest speed times
        ``dt*n`` taken in it)."""
        dev = self.devices[0]
        local = [torch.maximum(a.abs().max(), b.abs().max()).to(dev)
                 for a, b in zip(u, v)]
        fastest = torch.stack(local).max()
        return fastest * as_scalar(self.cfg.dt * self.cfg.n, fastest)

    # -- the step --------------------------------------------------------------

    def _parts(self, tree, what: str):
        shape = (self.blocks.m, self.blocks.k)
        count = self.blocks.px * self.blocks.py
        for name in ("dens", "u", "v"):
            parts = getattr(tree, name)
            if (not isinstance(parts, (tuple, list)) or len(parts) != count
                    or any(tuple(x.shape) != shape for x in parts)):
                raise TypeError(
                    f"{what}.{name}: expected {count} blocks of shape "
                    f"{shape} (see shard_blocks)")
        return tree

    def __call__(self, state: FluidState, src: Sources):
        cfg = self.cfg
        self._parts(state, "state")
        self._parts(src, "sources")
        dt = cfg.dt
        none = [None] * len(state.u)
        u = [add_source(a, s, dt) for a, s in zip(state.u, src.u)]
        v = [add_source(a, s, dt) for a, s in zip(state.v, src.v)]
        alpha = cfg.diffusion_alpha_visc
        beta = 1.0 + 4.0 * alpha
        u = self._diffusion(1, src.u, u, alpha, beta)
        v = self._diffusion(2, src.v, v, alpha, beta)
        u, v = self._project(u, v)
        d_vel = self._disp(u, v) if self.audited else None
        pairs = self._advect((1, 2), (u, v), none, none, self_adv=True)
        u, v = self._project([q[0] for q in pairs], [q[1] for q in pairs])
        d_dens = self._disp(u, v) if self.audited else None

        dens = [add_source(a, s, dt) for a, s in zip(state.dens, src.dens)]
        alpha = cfg.diffusion_alpha_diff
        beta = 1.0 + 4.0 * alpha
        dens = self._diffusion(0, src.dens, dens, alpha, beta, dens=True)
        dens = [d[0] for d in self._advect((0,), (dens,), u, v,
                                           self_adv=False)]
        out = FluidState(dens=tuple(dens), u=tuple(u), v=tuple(v))
        if self.audited:
            return out, torch.maximum(d_vel, d_dens)
        return out


def make_sharded_step_fn(
    cfg: SimConfig, mesh: Mesh, *, advect_mode: str = "auto",
    shard_backend: str = "auto", audited: bool = False,
) -> Callable[[FluidState, Sources], FluidState]:
    """A multi-device step over ``mesh``; ``(n+2)`` must divide by both
    mesh dimensions.  Inputs and outputs are states and sources whose
    fields are tuples of parts: the row slabs of ``shard_state`` on the
    slab route, the blocks of ``shard_blocks`` on the block route (the
    callable's ``.layout``, ``"slabs"`` or ``"blocks"``; a (px, 1) mesh's
    blocks are its slabs).  The wrong layout raises ``TypeError``.

    ``shard_backend``: ``"slab"`` is the row-slab route (JAX's
    ``"pallas"``): a 2-D mesh row-flattens, its devices a (px·py, 1) mesh,
    and every slab must hold ``max_courant+1`` rows.  ``"reference"`` is
    JAX's jnp block route (``_step_local``) on the (px, py) mesh as it
    comes.  ``"auto"`` takes the slab route where the shape qualifies
    (JAX's gate, ``sharded.py:962-981``) and the block route otherwise:
    slabs thinner than ``max_courant+1`` rows, or a mesh that does not
    row-flatten.  Each route's operations are the CUDA kernels or their
    plain twins by ``cfg.resolved_backend``, chosen once.
    ``pressure_solver="multigrid"`` raises ``ValueError`` unless every part
    has even sides, as in JAX.  bfloat16 storage runs on the block route,
    which ``"auto"`` takes for it, as JAX's does (its slab route is
    float32, ``sharded.py:843-847`` there); ``"slab"`` raises
    ``ValueError`` for it.

    ``advect_mode``: ``"windowed"`` gathers in the window of
    ``max_courant`` cells; ``"exact"`` gathers from the assembled fields
    at any displacement (JAX's ``_advect_local``, on either route).
    ``"auto"`` is windowed where every part holds ``max_courant+1`` rows
    and columns and exact otherwise; a windowed request on thinner parts
    raises ``ValueError``.

    ``audited=True`` returns ``(state, max_displacement)``, the largest
    backtrace displacement of the step's advections over every part (a
    0-dim tensor on the first device): the windowed gathers are exact
    while it stays at or below ``cfg.max_courant``.

    The callable carries ``.shard_backend`` (``"slab"``, or
    ``"reference"`` for the block route), ``.advect_mode`` (the mode
    taken), ``.mesh`` (the mesh used, flattened for the slab route),
    ``.layout`` and ``.routes``: whether the projection and the density
    step run ``"fused"`` or ``"composed"``.
    """
    if advect_mode not in ("auto", "exact", "windowed"):
        raise ValueError(f"unknown advect_mode {advect_mode!r}")
    if shard_backend not in ("auto", "reference", "slab"):
        raise ValueError(f"unknown shard_backend {shard_backend!r}")
    if cfg.ndim != 2:
        raise ValueError("make_sharded_step_fn is the 2-D step; the 3-D "
                         "z-slab step is make_sharded_step_fn_3d")
    px, py = mesh.shape["x"], mesh.shape["y"]
    side = cfg.n + 2
    slabs = px * py
    window = cfg.max_courant + 1
    # The slab route is float32, as JAX's (parallel/sharded.py:843-847
    # there); bf16 storage takes the block route, as JAX's "auto" does.
    bf16 = cfg.dtype == torch.bfloat16
    if shard_backend == "slab":
        if bf16:
            raise ValueError(
                "shard_backend='slab' is float32, as the JAX package's slab "
                "route; bf16 storage runs on the block route "
                "(shard_backend='auto' or 'reference')")
        if not _slab_viable(cfg, slabs):
            raise ValueError(
                f"shard_backend='slab' needs row slabs (2-D meshes are "
                f"row-flattened): (n+2) % n_devices == 0 and slabs of >= "
                f"max_courant+1 rows; got mesh ({px}, {py}), n={cfg.n}")
        blocks = False
    else:
        blocks = (bf16 or shard_backend == "reference"
                  or not _slab_viable(cfg, slabs))
    if blocks:
        if side % px or side % py:
            raise ValueError(f"grid side {side} not divisible by mesh "
                             f"shape ({px}, {py})")
        m, k = side // px, side // py
    else:
        mesh = mesh.reshape(slabs, 1)
        m, k = side // slabs, side
    if advect_mode == "auto":
        # JAX's "auto" (sharded.py:986-991): windowed where every part
        # holds the window, as every slab does.
        advect_mode = "windowed" if min(m, k) >= window else "exact"
    if advect_mode == "windowed" and min(m, k) < window:
        raise ValueError(
            f"windowed advection needs >= {window} rows/cols per shard "
            f"(max_courant={cfg.max_courant}); got ({m}, {k}) on mesh "
            f"({px}, {py}). Use advect_mode='exact' or a coarser mesh.")
    if cfg.pressure_solver == "multigrid" and (m % 2 or k % 2):
        # The coarse grid's 2x2 groups stay inside a part (JAX's gate,
        # sharded.py:1029-1038 there).
        raise ValueError(
            f"sharded multigrid needs even local block sizes ((n+2)/px "
            f"and (n+2)/py even); got ({m}, {k}) on mesh ({px}, {py})")

    exact = advect_mode == "exact"
    run = (_BlockStep if blocks else _SlabStep)(cfg, mesh, audited, exact)

    def step_fn(state, src):
        return run(state, src)

    step_fn.shard_backend = "reference" if blocks else "slab"
    step_fn.advect_mode = advect_mode
    step_fn.mesh = mesh
    step_fn.layout = "blocks" if blocks else "slabs"
    step_fn.routes = {
        "projection": ("fused" if not blocks and run.fused_proj
                       else "composed"),
        "density": "fused" if not blocks and run.fused_dens else "composed"}
    return step_fn
