"""Stable Fluids 2-D — the flagship solver (PyTorch twin of
``fluidsimulationcuda_tpu.models.stable_fluids_2d``).

The step composition mirrors ``vel_step``/``dens_step``
(``FluidSequential.c:176-241``) exactly, including the quirks that matter
for parity:

- the Jacobi initial guess of the velocity/density diffusions is the raw
  source buffer (the reference's post-SWAP ``*_prev`` contents, ``:201-204``);
- both self-advections read the same *pre-advection* velocity (``:232,237``);
- the velocity step projects twice (``:213-226`` and ``:238-240``).

PyTorch runs eagerly, so a step is a plain function of tensors and
``simulate`` is a Python loop.  A step takes one (side, side) grid per
field or a batch of them, (B, side, side), through either backend
(``models/batched.py``).
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from ..core.config import SimConfig
from ..core.state import FluidState, Sources, zero_sources_like
from ..kernels.dispatch import OpSet, get_ops
from ..ops.cg import cg_pressure_solve
from ..ops.diffuse import as_scalar
from ..ops.multigrid import mg_pressure_solve_fast

__all__ = [
    "vel_step", "dens_step", "step", "step_audited", "make_step_fn",
    "simulate", "StableFluids2D",
]


def _require_2d(cfg: SimConfig, what: str) -> None:
    if cfg.ndim != 2:
        raise ValueError(f"{what} requires ndim == 2, got ndim={cfg.ndim} "
                         f"(the 3-D step is models/stable_fluids_3d.py)")


def _make_project(cfg: SimConfig, ops: OpSet):
    """Pressure-projection closure honouring ``cfg.pressure_solver``.  The
    multigrid and CG solves sit between the OpSet's divergence and
    gradient (K2 on the card); multigrid smooths with the OpSet's smoother
    (K1's damped sweep on the card), CG runs the same torch code on both
    backends."""
    if cfg.pressure_solver == "multigrid":
        def _project(u, v):
            div = ops.divergence(u, v, cfg.n)
            p = mg_pressure_solve_fast(div, cycles=cfg.mg_cycles,
                                       smooth=ops.smooth)
            return ops.apply_pressure_gradient(u, v, p, cfg.n)
    elif cfg.pressure_solver == "cg":
        def _project(u, v):
            div = ops.divergence(u, v, cfg.n)
            p = cg_pressure_solve(div, iters=cfg.cg_iters)
            return ops.apply_pressure_gradient(u, v, p, cfg.n)
    elif cfg.pressure_solver == "chebyshev":
        def _project(u, v):
            return ops.project(u, v, cfg.n, cfg.press_cheby_iters,
                               cheby_rho=cfg.cheby_rho)
    else:
        def _project(u, v):
            return ops.project(u, v, cfg.n, cfg.jacobi_iters)
    return _project


def _diffusion_args(cfg: SimConfig, dens: bool = False) -> tuple[int, dict]:
    """(iters, extra kwargs) of a diffusion solve under
    ``cfg.diffusion_solver``; ``dens`` marks the density solve, the only
    one "chebyshev-dens" accelerates."""
    if cfg.diffusion_solver == "chebyshev":
        return cfg.cheby_iters, {"cheby_rho": cfg.cheby_rho}
    if dens and cfg.diffusion_solver == "chebyshev-dens":
        return cfg.cheby_dens_iters, {"cheby_rho": cfg.cheby_rho}
    return cfg.jacobi_iters, {}


def _diffuse_velocity(cfg, ops, u, v, u_src, v_src):
    alpha = cfg.diffusion_alpha_visc
    beta = 1.0 + 4.0 * alpha
    d_iters, d_kw = _diffusion_args(cfg)
    u = ops.diffuse_src(1, u_src, u, alpha, beta, d_iters, cfg.dt, **d_kw)
    v = ops.diffuse_src(2, v_src, v, alpha, beta, d_iters, cfg.dt, **d_kw)
    return u, v


def vel_step(cfg: SimConfig, u: torch.Tensor, v: torch.Tensor,
             u_src: torch.Tensor, v_src: torch.Tensor,
             ops: OpSet | None = None):
    """Velocity update (``FluidSequential.c:189-241``), on ``ops`` or the
    backend's OpSet."""
    _require_2d(cfg, "vel_step")
    ops = get_ops(cfg) if ops is None else ops
    project = _make_project(cfg, ops)
    u, v = project(*_diffuse_velocity(cfg, ops, u, v, u_src, v_src))
    u, v = ops.advect_pair(1, 2, u, v, u, v, cfg.dt, cfg.n)
    return project(u, v)


def dens_step(cfg: SimConfig, dens: torch.Tensor, dens_src: torch.Tensor,
              u: torch.Tensor, v: torch.Tensor,
              ops: OpSet | None = None) -> torch.Tensor:
    """Density update (``FluidSequential.c:176-186``), on ``ops`` or the
    backend's OpSet."""
    _require_2d(cfg, "dens_step")
    ops = get_ops(cfg) if ops is None else ops
    alpha = cfg.diffusion_alpha_diff
    beta = 1.0 + 4.0 * alpha
    d_iters, d_kw = _diffusion_args(cfg, dens=True)
    if ops.diffuse_advect is not None:
        return ops.diffuse_advect(0, dens_src, dens, u, v, alpha, beta,
                                  d_iters, cfg.dt, cfg.n, **d_kw)
    dens = ops.diffuse_src(0, dens_src, dens, alpha, beta, d_iters, cfg.dt,
                           **d_kw)
    return ops.advect(0, dens, u, v, cfg.dt, cfg.n)


def step(cfg: SimConfig, state: FluidState, sources: Sources,
         ops: OpSet | None = None) -> FluidState:
    """One full timestep: ``vel_step`` then ``dens_step``
    (``FluidSequential.c:305-306``).  ``ops`` replaces the backend's OpSet
    (``get_ops(cfg)``), as the plain twins of the ``cuda`` kernels
    (``cuda_ops.make_opset(cfg, plain=True)``) do to hold a fast-math step
    on the card to the same arithmetic in torch ops."""
    u, v = vel_step(cfg, state.u, state.v, sources.u, sources.v, ops)
    dens = dens_step(cfg, state.dens, sources.dens, u, v, ops)
    return FluidState(dens=dens, u=u, v=v)


def step_audited(cfg: SimConfig, state: FluidState,
                 sources: Sources) -> tuple[FluidState, torch.Tensor]:
    """``step`` plus the largest semi-Lagrangian backtrace displacement
    (cells, a 0-dim tensor, over every grid of a batch) of this step's
    advections.  The self-advection
    backtraces through the post-projection intermediate velocity, so the
    stored state alone under-reports it.  Under ``advect_mode="windowed"``
    the gathers were exact while it stays at or below ``cfg.max_courant``
    and clamped above; under ``"auto"``/``"exact"`` they are exact at any
    displacement, and the number says whether the windowed gather would
    have been."""
    _require_2d(cfg, "step_audited")
    dt0 = cfg.dt * cfg.n

    def _disp(u, v):
        # dt0 in the fields' dtype, as JAX's python scalar is; the batched
        # runs' accumulators stay float32.
        return (torch.maximum(u.abs().max(), v.abs().max())
                * as_scalar(dt0, u))

    ops = get_ops(cfg)
    project = _make_project(cfg, ops)
    u, v = project(*_diffuse_velocity(cfg, ops, state.u, state.v, sources.u,
                                      sources.v))
    d_vel = _disp(u, v)
    u, v = ops.advect_pair(1, 2, u, v, u, v, cfg.dt, cfg.n)
    u, v = project(u, v)
    d_dens = _disp(u, v)
    dens = dens_step(cfg, state.dens, sources.dens, u, v, ops)
    return FluidState(dens=dens, u=u, v=v), torch.maximum(d_vel, d_dens)


def make_step_fn(cfg: SimConfig) -> Callable[[FluidState, Sources], FluidState]:
    """``step`` bound to ``cfg``."""
    _require_2d(cfg, "make_step_fn")
    return functools.partial(step, cfg)


def simulate(cfg: SimConfig, state: FluidState, sources: Sources,
             num_steps: int, *, sources_every_step: bool = False) -> FluidState:
    """Run ``num_steps`` steps.  Sources fire on step 1 only by default,
    matching the reference harness (``FluidSequential.c:289-303``);
    ``sources_every_step=True`` makes them a continuous inflow."""
    zeros = sources if sources_every_step else zero_sources_like(sources)
    for k in range(num_steps):
        state = step(cfg, state, sources if k == 0 else zeros)
    return state


class StableFluids2D:
    """Object-style wrapper around ``step`` and ``simulate``."""

    def __init__(self, cfg: SimConfig):
        _require_2d(cfg, "StableFluids2D")
        self.cfg = cfg
        self._zeros = None

    def step(self, state: FluidState,
             sources: Sources | None = None) -> FluidState:
        if sources is None:
            zeros = self._zeros
            if zeros is None or zeros.dens.shape != state.dens.shape:
                self._zeros = zero_sources_like(state)
            sources = self._zeros
        return step(self.cfg, state, sources)

    def simulate(self, state, sources, num_steps, **kw) -> FluidState:
        return simulate(self.cfg, state, sources, num_steps, **kw)
