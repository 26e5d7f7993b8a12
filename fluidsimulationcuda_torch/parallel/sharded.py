"""The multi-device step on row slabs (PyTorch twin of the slab route of
``fluidsimulationcuda_tpu.parallel.sharded``: ``make_sharded_step_fn``
with ``shard_backend="pallas"``, whose per-shard program is
``_step_local_pallas``).

The padded (side, side) grid is cut into ``px`` slabs of ``m = side/px``
full-width rows, slab ``i`` on mesh device ``i``.  One process drives every
slab: before each slab kernel call it builds the slab's extended copy from
the neighbouring slabs' edge rows (``.to(device)`` where the devices
differ; zeros beyond a wall) and calls the slab function of
``kernels/cuda_sharded.py`` with the slab's ``(is_top, is_bot, row0)``
flags.  Torch has no global sharded array, so ``shard_state`` splits a
state into slabs and ``unshard`` stitches them back.

The composition, margins and route gates are JAX's, so a given
``(m, iters, cmax)`` takes the same route in both packages:

- sources folded as ``state + dt*src``, then u and v diffused in Jacobi
  chunks of ``fuse = cfg.fuse_sweeps or 20`` sweeps (halo
  ``ceil8(s+1)`` per chunk, the rhs built once and exchanged per chunk), or
  as one-call Chebyshev solves (halo ``ceil8(iters+1)``);
- the projection fused (one ``ceil8(iters+3)``-row u/v exchange) for a
  Jacobi or Chebyshev pressure solve whose halo fits a slab, else
  composed: divergence, the pressure solve (Jacobi chunks from zero, one
  Chebyshev call, or the slab multigrid or CG of ``parallel/solvers.py``)
  and gradient, each stencil with a one-row halo;
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

Not ported (ROADMAP §A 3): the 2-D block route of ``_step_local`` (2-D
halos, its solvers on 2-D blocks, the jnp Chebyshev solves for a halo
deeper than a slab), which JAX takes for ``shard_backend="reference"``, for
meshes that do not row-flatten and for slabs thinner than
``max_courant+1`` rows (where its ``"auto"`` gathers exactly).  Every shape
that would need it raises; none quietly takes another route.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.config import SimConfig
from ..core.state import FluidState, Sources
from ..kernels.dispatch import get_ops, get_slab_ops
from ..ops.source import add_source
from .mesh import Mesh, _ext, _gather, _halos
from .solvers import SMOOTH_HALO, cg_slabs, mg_slabs

__all__ = ["make_sharded_step_fn", "shard_state", "unshard"]

_BLOCK_ROUTE = ("the block route of the JAX package's _step_local (2-D "
                "halos, its solvers on 2-D blocks, the jnp Chebyshev "
                "solves) is not ported (ROADMAP §A 3)")


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


def unshard(tree):
    """Stitch each field's slabs back into one tensor (a (side, side) grid
    or a (side, side, side) volume) on the first slab's device."""
    def join(slabs):
        if slabs is None:
            return None
        return torch.cat([s.to(slabs[0].device) for s in slabs])

    return type(tree)(*map(join, tree))


def _slab_viable(cfg: SimConfig, slabs: int) -> bool:
    side = cfg.n + 2
    return side % slabs == 0 and side // slabs >= cfg.max_courant + 1


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
        one_call = ([cfg.cheby_iters] * self.vel_cheby
                    + [self.k_dens] * (self.dens_cheby and not self.fused_dens)
                    + [self.it_p] * (self.cheby_p and not self.fused_proj))
        for iters in one_call:
            if _ceil8(iters + 1) > m:
                raise NotImplementedError(
                    f"a {iters}-sweep Chebyshev solve needs a "
                    f"{_ceil8(iters + 1)}-row halo, deeper than the {m}-row "
                    f"slabs; {_BLOCK_ROUTE}")

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
        never crosses a halo exchange)."""
        K = _ceil8(iters + 1)
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


def make_sharded_step_fn(
    cfg: SimConfig, mesh: Mesh, *, advect_mode: str = "auto",
    shard_backend: str = "auto", audited: bool = False,
) -> Callable[[FluidState, Sources], FluidState]:
    """A multi-device step over ``mesh``.  Inputs and outputs are states
    and sources whose fields are tuples of row slabs (``shard_state``);
    ``(n+2)`` must divide by the number of slabs.

    ``shard_backend``: ``"slab"`` is the row-slab route (JAX's
    ``"pallas"``); its slab operations are the CUDA kernels or their plain
    twins by ``cfg.resolved_backend``, chosen once.  ``"reference"`` (JAX's
    jnp block route) raises ``NotImplementedError``.  ``"auto"`` takes the
    slab route where the shape qualifies and raises otherwise.  A 2-D mesh
    qualifies by row-flattening: its devices become a (px·py, 1) mesh.
    ``pressure_solver="multigrid"`` raises ``ValueError`` unless every slab
    has an even row count, as JAX's slab route does.

    ``advect_mode``: ``"windowed"`` (or ``"auto"``, as JAX's on slabs that
    hold the window) gathers in the window of ``max_courant`` cells;
    ``"exact"`` gathers from the assembled fields at any displacement
    (JAX's ``_advect_local``, on the slab route).  Every slab must hold
    ``max_courant+1`` rows in both modes: thinner slabs need the block
    route (ROADMAP §A 3).

    ``audited=True`` returns ``(state, max_displacement)``, the largest
    backtrace displacement of the step's advections over every slab (a
    0-dim tensor on the first device): the windowed gathers are exact
    while it stays at or below ``cfg.max_courant``.

    The callable carries ``.shard_backend``, ``.advect_mode`` (the mode
    taken: ``"exact"`` or ``"windowed"``) and ``.mesh`` (the mesh used,
    flattened for a 2-D mesh), and ``.routes``: whether the projection and
    the density step run ``"fused"`` or ``"composed"``.
    """
    if advect_mode not in ("auto", "exact", "windowed"):
        raise ValueError(f"unknown advect_mode {advect_mode!r}")
    if shard_backend not in ("auto", "reference", "slab"):
        raise ValueError(f"unknown shard_backend {shard_backend!r}")
    if cfg.ndim != 2:
        raise ValueError("make_sharded_step_fn is the 2-D step; the 3-D "
                         "z-slab step is make_sharded_step_fn_3d")
    if cfg.dtype != torch.float32:
        # JAX's slab route requires float32 (parallel/sharded.py:847 there)
        # and takes the block route in bf16.
        raise NotImplementedError(
            f"dtype={cfg.dtype} on slabs waits on ROADMAP §A 5: "
            f"{_BLOCK_ROUTE}")
    px, py = mesh.shape["x"], mesh.shape["y"]
    side = cfg.n + 2
    if side % px or side % py:
        raise ValueError(f"grid side {side} not divisible by mesh shape "
                         f"({px}, {py})")
    # The one route ported: JAX's "pallas" slab route on the row-flattened
    # mesh (sharded.py:962-981), with its windowed gathers or JAX's exact
    # all-gather (_advect_local).
    slabs = px * py
    if shard_backend == "slab":
        if not _slab_viable(cfg, slabs):
            raise ValueError(
                f"shard_backend='slab' needs row slabs (2-D meshes are "
                f"row-flattened): (n+2) % n_devices == 0 and slabs of >= "
                f"max_courant+1 rows; got mesh ({px}, {py}), n={cfg.n}")
    elif shard_backend == "reference" or not _slab_viable(cfg, slabs):
        raise NotImplementedError(
            f"mesh ({px}, {py}) with shard_backend={shard_backend!r}, "
            f"advect_mode={advect_mode!r} needs the block route: "
            f"{_BLOCK_ROUTE}")
    if cfg.pressure_solver == "multigrid" and (side // slabs) % 2:
        # The coarse grid's 2x2 groups stay inside a slab (JAX's gate,
        # sharded.py:1029-1038 there; a slab is full width).
        raise ValueError(
            f"sharded multigrid needs even local block sizes ((n+2)/px "
            f"and (n+2)/py even); got ({side // slabs}, {side}) on mesh "
            f"({px}, {py})")
    mesh = mesh.reshape(slabs, 1)

    # JAX's "auto" is windowed on shards that hold the window, as these do.
    mode = "windowed" if advect_mode == "auto" else advect_mode
    run = _SlabStep(cfg, mesh, audited, exact=mode == "exact")

    def step_fn(state, src):
        return run(state, src)

    step_fn.shard_backend = "slab"
    step_fn.advect_mode = mode
    step_fn.mesh = mesh
    step_fn.routes = {
        "projection": "fused" if run.fused_proj else "composed",
        "density": "fused" if run.fused_dens else "composed"}
    return step_fn
