"""The 3-D multi-device step on z-slabs (PyTorch twin of
``fluidsimulationcuda_tpu.parallel.sharded3d``: ``make_sharded_step_fn_3d``,
whose per-shard program is ``_step3_local_pallas`` and, on its jnp ops,
``_step3_local``).

The padded (side, side, side) volume is cut into ``pz`` slabs of ``mz =
side/pz`` whole (y, x) planes, slab ``i`` on mesh device ``i``; every mesh
flattens into z-slabs, as in JAX.  One process drives every slab, as the
row-slab step does (``parallel/sharded.py``): before each slab call it
builds the slab's extended copy from the neighbouring slabs' edge planes
(``.to(device)`` where the devices differ; zeros beyond a wall) and calls
the slab function of ``kernels/cuda_sharded_3d.py`` with the slab's
``(is_top, is_bot, plane0)`` flags.  ``shard_state_3d`` splits a state into
slabs; ``unshard`` (``parallel/sharded.py``) stitches them back.

The composition is JAX's: sources folded as ``state + dt*src``; u, v, w
diffused; projection; the (u, v, w) self-advection (one triple launch
where JAX makes three calls); projection; the density diffused, then
gathered.  Each solve runs in segments of ``K = min(fuse, iters, mz-1)``
sweeps (``fuse = cfg.fuse_sweeps or 20``), one exchange of ``H = K+1``
halo planes each, its rhs halo exchanged once per solve; the pressure
solves start from zero; a Chebyshev chain re-exchanges both iterates per
segment and resumes ω where the last segment stopped.  This is JAX's
interpret-mode plan, without the VMEM planners that size K on the TPU;
the chunking changes no number.  ``fast_math`` reaches every solve,
pressure included (``sharded3d.py:644-646, 679-683``; the row-slab step
keeps it off the pressure solve, as JAX's 2-D route does).

The gathers are windowed (``advect_mode="windowed"``, and ``"auto"`` on
slabs of at least ``max_courant+1`` planes), over a ``cmax+1``-plane halo:
exact while the backtrace moves at most ``cfg.max_courant`` cells per axis,
clamped above; ``audited=True`` returns the displacement to check it.  Or
they are exact (``"exact"``, and ``"auto"`` on thinner slabs, as JAX's
``"auto"`` chooses, ``sharded3d.py:799-800``): JAX's
``_advect3_local_exact``, the volume all-gathered over z and each slab's
cells gathered at global coordinates; here each gathered field is
assembled once per device (``mesh._gather``) and every slab gathers from
it with K14's exact form (``advect3_flat_slab_exact``), so the step equals
the single-device step at any displacement and any slab thickness.  On
the ``cuda`` backend both gathers run grouped instead
(``Slab3OpSet.advect_group``, the grouped K14): one launch a device over
every slab, each corner read from its owner slab's array, no extended
slab and no assembled volume built, bit for bit the same.
Nothing falls back quietly: a windowed request on slabs too thin for the
window raises.

In bf16 storage (``SimConfig(dtype=torch.bfloat16)``) the slabs are bf16
in and out and the step composes the same operations.  The ``reference``
backend is JAX's jnp ``_step3_local`` on bf16 slabs (its bf16 route, which
JAX's Pallas z-slab route leaves to jnp, ``sharded3d.py:814-818``): every
operation rounded to bf16 as JAX rounds it, the sources folded by
``add_source`` in bf16, except the gathers, which widen their inputs,
gather in float32 and round once, as the single-device bf16 step's do.
The ``cuda`` backend is the z-slab kernels' bf16 forms
(``kernels/cuda_sharded_3d.py``), the single-device bf16 kernels' rules:
each diffusion's rhs built in float32 and rounded once (``solve_rhs3``,
times 1/beta in fast mode), each solve's iterate float32 from its first
sweep to its last across its segments and exchanges, a float32 divergence
and pressure between bf16 velocities.  ``_ZSlabStep(..., plain=True)``
composes the kernels' plain twins instead, which equal them bit for bit.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.config import SimConfig
from ..core.state import FluidState, Sources
from ..kernels.cuda_sharded_3d import solve_rhs3
from ..kernels.dispatch import get_slab3_ops
from ..ops.diffuse import as_scalar
from ..ops.source import add_source
from .mesh import Mesh, _gather
from .sharded import _ext, _halos, _split

__all__ = ["make_sharded_step_fn_3d", "shard_state_3d"]

def shard_state_3d(tree, mesh: Mesh):
    """Split each (side, side, side) field of a ``FluidState`` or
    ``Sources`` into the z-slabs of ``mesh``: a tuple of ``px·py`` tensors
    of shape (side/(px·py), side, side), slab ``i`` a copy on the mesh's
    ``i``-th device (row-major)."""
    return _split(tree, mesh, 3)


def _transpose(per_slab):
    """[(a_0, b_0, ...), (a_1, b_1, ...)] -> ([a_0, a_1], [b_0, b_1], ...)"""
    return tuple(list(field) for field in zip(*per_slab))


class _ZSlabStep:
    """One step of ``cfg`` on the z-slabs of a (pz, 1) mesh, its gathers
    exact (from the assembled fields) or windowed; ``plain`` (a ``cuda``
    config) on the kernels' plain twins, on any device."""

    def __init__(self, cfg: SimConfig, mesh: Mesh, audited: bool,
                 exact: bool, plain: bool = False):
        self.cfg, self.audited, self.exact = cfg, audited, exact
        self.ops = get_slab3_ops(cfg, plain)
        # The kernels build a bf16 diffusion's rhs once, in float32
        # (solve_rhs3); JAX's jnp route, the reference backend, adds the
        # source in bf16.
        self.built_rhs = (cfg.dtype == torch.bfloat16
                          and cfg.resolved_backend == "cuda")
        self.devices = mesh.device_list
        self.pz = pz = len(self.devices)
        self.mz = mz = (cfg.n + 2) // pz
        self.flags = [(int(i == 0), int(i == pz - 1), i * mz)
                      for i in range(pz)]
        self.fuse = cfg.fuse_sweeps or 20
        # Solver selection, as _step3_local_pallas (sharded3d.py:655-745).
        self.rho_p = (cfg.cheby_rho if cfg.pressure_solver == "chebyshev"
                      else None)
        self.it_p = (cfg.press_cheby_iters if self.rho_p is not None
                     else cfg.jacobi_iters)
        vel_cheby = cfg.diffusion_solver == "chebyshev"
        self.vel = ((cfg.cheby_iters, cfg.cheby_rho) if vel_cheby
                    else (cfg.jacobi_iters, None))
        k_dens = {"chebyshev": cfg.cheby_iters,
                  "chebyshev-dens": cfg.cheby_dens_iters}.get(
                      cfg.diffusion_solver)
        self.dens = ((k_dens, cfg.cheby_rho) if k_dens is not None
                     else (cfg.jacobi_iters, None))
        self.chunks = {name: self._plan(iters) for name, iters in
                       (("velocity", self.vel[0]), ("pressure", self.it_p),
                        ("density", self.dens[0]))}

    def _plan(self, iters: int) -> tuple[int, int]:
        """(K, H): sweeps per halo exchange and halo planes of a solve of
        ``iters`` sweeps; H <= mz, so every halo comes from the adjacent
        slab."""
        K = min(self.fuse, iters, self.mz - 1)
        return K, K + 1

    # -- the operations of _step3_local_pallas ---------------------------------

    def _solve(self, b, x_init, rhs, alpha, beta, iters, rho=None,
               zero_init=False):
        """``iters`` Jacobi (or, with ``rho``, Chebyshev) sweeps in
        segments of K, one H-plane exchange of the iterate (and of x_{k-1}
        for Chebyshev) per segment, the rhs exchanged once.  On the
        kernels a bf16 solve's segments hand on its float32 iterate; the
        last rounds it."""
        K, H = self._plan(iters)
        ops, mz = self.ops, self.mz
        rhs_ext = _ext(rhs, H)
        x, xm, done = x_init, None, 0
        while done < iters:
            s = min(K, iters - done)
            zi = zero_init and done == 0
            x_ext = rhs_ext if zi else _ext(x, H)
            kw = dict(mz=mz, H=H, alpha=alpha, beta=beta, sweeps=s,
                      zero_init=zi, fast=ops.fast)
            if rho is None:
                ends = done + s == iters
                x = [ops.jacobi(b, xe, re, fl, ends_solve=ends, **kw)
                     for xe, re, fl in zip(x_ext, rhs_ext, self.flags)]
            else:
                carry_out = done + s < iters
                xm_ext = [None] * self.pz if xm is None else _ext(xm, H)
                out = [ops.cheby(b, xe, me, re, fl, cheby_rho=rho, start=done,
                                 carry_in=xm is not None, carry_out=carry_out,
                                 **kw)
                       for xe, me, re, fl in zip(x_ext, xm_ext, rhs_ext,
                                                 self.flags)]
                x, xm = _transpose(out) if carry_out else (out, None)
            done += s
        return x

    def _project(self, u, v, w):
        n = self.cfg.n
        div = [self.ops.divergence(ui, vi, wi, top, bot, fl, n)
               for ui, vi, wi, (top, bot), fl in zip(u, v, w, _halos(w, 1),
                                                     self.flags)]
        p = self._solve(0, None, div, 1.0, 6.0, self.it_p, self.rho_p,
                        zero_init=True)
        return _transpose(
            self.ops.gradient(ui, vi, wi, pi, top, bot, fl, n)
            for ui, vi, wi, pi, (top, bot), fl in zip(u, v, w, p,
                                                      _halos(p, 1),
                                                      self.flags))

    def _advect(self, bs, fields, u, v, w):
        """The gather of each field of ``fields`` by (u, v, w): on the
        ``cuda`` backend one grouped launch a device for all of them
        (``Slab3OpSet.advect_group``), elsewhere one launch per slab on
        each slab's extended or assembled fields."""
        cfg = self.cfg
        if self.ops.advect_group is not None:
            return _transpose(self.ops.advect_group(
                bs, fields, u, v, w, self.flags, dt=cfg.dt, n=cfg.n,
                cmax=None if self.exact else cfg.max_courant, mz=self.mz))
        if self.exact:
            fulls = [_gather(f) for f in fields]
            return _transpose(
                self.ops.advect_exact(bs, fs, ui, vi, wi, fl, dt=cfg.dt,
                                      n=cfg.n, mz=self.mz)
                for fs, ui, vi, wi, fl in zip(zip(*fulls), u, v, w,
                                              self.flags))
        exts = [_ext(f, cfg.max_courant + 1) for f in fields]
        return _transpose(
            self.ops.advect(bs, es, ui, vi, wi, fl, dt=cfg.dt, n=cfg.n,
                            cmax=cfg.max_courant, mz=self.mz)
            for es, ui, vi, wi, fl in zip(zip(*exts), u, v, w, self.flags))

    def _disp(self, u, v, w) -> torch.Tensor:
        """Largest backtrace displacement (cells) over every slab, in the
        fields' dtype, dt*n rounded to it first as JAX's weakly typed
        scalar is (``_disp3_global``)."""
        dev = self.devices[0]
        local = [torch.maximum(torch.maximum(a.abs().max(), b.abs().max()),
                               c.abs().max()).to(dev)
                 for a, b, c in zip(u, v, w)]
        m = torch.stack(local).max()
        return m * as_scalar(self.cfg.dt * self.cfg.n, m)

    def _rhs(self, x0, src, beta) -> list:
        """The rhs slabs of a diffusion from ``x0`` with the source
        ``src`` folded in: ``solve_rhs3`` for a bf16 solve on the kernels
        (times 1/beta in fast mode), ``add_source`` otherwise."""
        dt = self.cfg.dt
        if self.built_rhs:
            return [solve_rhs3(a, s, dt, beta, self.ops.fast)
                    for a, s in zip(x0, src)]
        return [add_source(a, s, dt) for a, s in zip(x0, src)]

    # -- the step --------------------------------------------------------------

    def _slabs(self, tree, what: str):
        side = self.cfg.n + 2
        for name in ("dens", "u", "v", "w"):
            slabs = getattr(tree, name)
            if (not isinstance(slabs, (tuple, list)) or len(slabs) != self.pz
                    or any(tuple(s.shape) != (self.mz, side, side)
                           for s in slabs)):
                raise TypeError(
                    f"{what}.{name}: expected {self.pz} slabs of shape "
                    f"({self.mz}, {side}, {side}) (see shard_state_3d)")
        return tree

    def __call__(self, state: FluidState, src: Sources):
        cfg = self.cfg
        self._slabs(state, "state")
        self._slabs(src, "sources")
        alpha = cfg.diffusion_alpha_visc
        beta = 1.0 + 6.0 * alpha
        vel = []
        for b, guess, x0 in zip((1, 2, 3), (src.u, src.v, src.w),
                                (state.u, state.v, state.w)):
            vel.append(self._solve(b, guess, self._rhs(x0, guess, beta),
                                   alpha, beta, *self.vel))
        u, v, w = vel
        u, v, w = self._project(u, v, w)
        d_vel = self._disp(u, v, w) if self.audited else None
        u, v, w = self._project(*self._advect((1, 2, 3), (u, v, w), u, v, w))
        d_dens = self._disp(u, v, w) if self.audited else None

        alpha = cfg.diffusion_alpha_diff
        beta = 1.0 + 6.0 * alpha
        dens = self._solve(0, src.dens, self._rhs(state.dens, src.dens, beta),
                           alpha, beta, *self.dens)
        (dens,) = self._advect((0,), (dens,), u, v, w)
        out = FluidState(dens=tuple(dens), u=tuple(u), v=tuple(v),
                         w=tuple(w))
        if self.audited:
            return out, torch.maximum(d_vel, d_dens)
        return out


def make_sharded_step_fn_3d(
    cfg: SimConfig, mesh: Mesh, *, advect_mode: str = "auto",
    shard_backend: str = "auto", audited: bool = False,
) -> Callable[[FluidState, Sources], FluidState]:
    """A 3-D multi-device step over the z-slabs of ``mesh`` (any mesh,
    flattened to its ``px·py`` devices).  Inputs and outputs are states and
    sources whose fields are tuples of z-slabs (``shard_state_3d``);
    ``(n+2)`` must divide by the number of slabs, with at least 2 planes a
    slab and ``max_courant+1`` for the windowed gather.

    ``shard_backend``: ``"slab"`` (or ``"auto"``), the z-slab route, whose
    slab operations are the CUDA kernels or their plain twins by
    ``cfg.resolved_backend``, chosen once.  JAX's ``"reference"`` (its jnp
    z-slab route) is the same route on the plain twins: pass
    ``cfg.replace(backend="reference")``.

    ``advect_mode``: ``"windowed"`` gathers in the window of
    ``max_courant`` cells (``ValueError`` on slabs thinner than
    ``max_courant+1`` planes); ``"exact"`` from the assembled fields at
    any displacement; ``"auto"`` windowed where the slabs hold the window
    and exact on thinner ones, as JAX's.

    ``audited=True`` returns ``(state, max_displacement)``, the largest
    backtrace displacement of the step's advections over every slab (a
    0-dim tensor on the first device): the windowed gathers are exact
    while it stays at or below ``cfg.max_courant``.

    The callable carries ``.shard_backend`` (``"slab"``), ``.advect_mode``
    (the mode taken: ``"exact"`` or ``"windowed"``), ``.mesh`` (the (pz, 1)
    mesh used) and ``.chunks``:
    per solve (velocity, pressure, density) the sweeps per exchange K and
    the halo planes H.

    A bf16 ``cfg`` runs the same route on bf16 slabs (the module note):
    the state and the sources are bf16 slabs, and so are the results.
    """
    if cfg.ndim != 3:
        raise ValueError("make_sharded_step_fn_3d requires cfg.ndim == 3")
    if cfg.pressure_solver not in ("jacobi", "chebyshev"):
        raise ValueError("sharded 3-D supports pressure_solver='jacobi' or "
                         "'chebyshev' (mg/cg are 2-D solvers)")
    if advect_mode not in ("auto", "exact", "windowed"):
        raise ValueError(f"unknown advect_mode {advect_mode!r}")
    if shard_backend == "reference":
        raise ValueError("shard_backend='reference' is the z-slab route on "
                         "the plain twins: pass cfg.replace("
                         "backend='reference')")
    if shard_backend not in ("auto", "slab"):
        raise ValueError(f"unknown shard_backend {shard_backend!r}")
    pz = len(mesh.device_list)
    side = cfg.n + 2
    if side % pz:
        raise ValueError(f"volume side {side} not divisible by device count "
                         f"{pz}")
    mz = side // pz
    if mz < 2:
        raise ValueError(f"z-slab decomposition needs >= 2 planes per shard; "
                         f"got {mz}")
    if advect_mode == "auto":
        advect_mode = "windowed" if mz >= cfg.max_courant + 1 else "exact"
    if advect_mode == "windowed" and mz < cfg.max_courant + 1:
        raise ValueError(
            f"windowed advection needs >= {cfg.max_courant + 1} planes per "
            f"shard (max_courant={cfg.max_courant}); got {mz}. Use "
            f"advect_mode='exact' or a coarser mesh.")
    mesh = mesh.reshape(pz, 1)
    run = _ZSlabStep(cfg, mesh, audited, exact=advect_mode == "exact")

    def step_fn(state, src):
        return run(state, src)

    step_fn.shard_backend = "slab"
    step_fn.advect_mode = advect_mode
    step_fn.mesh = mesh
    step_fn.chunks = run.chunks
    return step_fn
