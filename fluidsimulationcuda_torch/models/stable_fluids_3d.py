"""Stable Fluids 3-D — smoke volumes, BASELINE config 5 (PyTorch twin of
``fluidsimulationcuda_tpu.models.stable_fluids_3d``).

The 2-D step composition (``FluidSequential.c:176-241``) lifted to three
dimensions, kept exactly as the JAX package composes it:

- sources are added before the diffusions, and the raw source is each
  diffusion's Jacobi guess (the CUDA backend folds the addition into the
  first sweep: same expression, same rounding);
- the velocity step projects twice;
- the three self-advections all read the pre-advection velocity;
- ``diffusion_solver="chebyshev"`` runs every diffusion on Chebyshev sweeps
  (the compensated mode, ``PERF_POINT_3D``), ``"chebyshev-dens"`` only the
  density's;
- ``advect_mode="windowed"`` clamps every gather to the window of
  ``cfg.max_courant`` cells per axis, on both backends (JAX's Pallas 3-D
  step always gathers so, and its jnp step on a TPU); ``"auto"`` and
  ``"exact"`` gather exactly, as in the 2-D step.

Every op of either backend returns its full ghost layer, so the JAX
package's ghost-layer policy (which kernel outputs get ``set_bnd3``) has
nothing to decide here.  PyTorch runs eagerly: a step is a plain function of
tensors.

In bf16 storage (``SimConfig(dtype=torch.bfloat16)``) the state and sources
are bf16 and the step composes the same ops.  The ``reference`` backend is
JAX's jnp ``step3`` on bf16 arrays, every op rounded to bf16 as JAX rounds
it, except the gathers, which widen their inputs, gather in float32 and
round once (JAX's own bf16 gather cannot resolve a fraction of a cell at
these sides).  The ``cuda`` backend is the kernels' bf16 forms: each solve
keeps a float32 iterate and rounds once at its end, the folded or
prescaled rhs is rounded to bf16 before any sweep reads it, and the
projection keeps a float32 divergence and pressure between bf16 velocities
(``kernels/cuda_ops_3d.py``).  ``_Ops3(cfg, plain=True)`` composes the
kernels' plain twins instead, which equal them bit for bit.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from ..core.config import SimConfig
from ..core.state import FluidState, Sources, zero_sources
from ..ops.chebyshev import cheby_diffuse3, cheby_pressure_solve3
from ..ops.diffuse import as_scalar
from ..ops.source import add_source
from ..ops.three_d import (advect3, advect3_windowed,
                           apply_pressure_gradient3, diffuse3, divergence3,
                           pressure_solve3)

__all__ = ["vel_step3", "dens_step3", "step3", "step_audited3",
           "make_step_fn_3d", "StableFluids3D"]


def _require_3d(cfg: SimConfig, what: str) -> None:
    if cfg.ndim != 3:
        raise ValueError(f"{what} requires ndim == 3, got ndim={cfg.ndim}")


class _Ops3:
    """3-D op dispatch by ``cfg.resolved_backend``: the plain ops of
    ``ops/three_d.py`` (``reference``) or the CUDA kernels of
    ``kernels/cuda_ops_3d.py`` (``cuda``; with ``plain``, their plain
    twins, on any device).  Chosen once, explicitly; nothing falls back.
    ``cmax`` is the gather window (None: exact)."""

    def __init__(self, cfg: SimConfig, plain: bool = False):
        backend = cfg.resolved_backend
        if backend not in ("reference", "cuda"):
            raise ValueError(f"unknown backend {backend!r}")
        self.cfg = cfg
        self.cmax = cfg.max_courant if cfg.advect_mode == "windowed" else None
        self.k3 = None
        if backend == "cuda":
            from ..kernels import cuda_ops_3d

            self.k3 = cuda_ops_3d.PLAIN_TWINS if plain else cuda_ops_3d

    def diffuse_src(self, b, src, base, alpha, beta, iters, cheby_rho=None):
        """``add_source(base, src)`` diffused from the guess ``src``."""
        cfg = self.cfg
        if self.k3 is not None:
            return self.k3.fused_jacobi3(b, src, base, alpha, beta, iters,
                                         src_dt=cfg.dt, fast=cfg.fast_math,
                                         cheby_rho=cheby_rho)
        x0 = add_source(base, src, cfg.dt)
        if cheby_rho is not None:
            return cheby_diffuse3(b, src, x0, alpha, beta, iters, cheby_rho)
        return diffuse3(b, src, x0, alpha, beta, iters)

    def project(self, u, v, w):
        """Divergence, pressure solve from zero (alpha=1, beta=6) and
        gradient, with the sweeps of ``cfg.pressure_solver``."""
        cfg = self.cfg
        if cfg.pressure_solver == "chebyshev":
            iters, rho = cfg.press_cheby_iters, cfg.cheby_rho
        else:
            iters, rho = cfg.jacobi_iters, None
        if self.k3 is not None:
            div = self.k3.divergence3_p(u, v, w, cfg.n)
            p = self.k3.fused_jacobi3(0, div, div, 1.0, 6.0, iters,
                                      zero_init=True, fast=cfg.fast_math,
                                      cheby_rho=rho)
            return self.k3.gradient3_p(u, v, w, p, cfg.n)
        div = divergence3(u, v, w, cfg.n)
        p = (pressure_solve3(div, iters) if rho is None
             else cheby_pressure_solve3(div, iters, rho))
        return apply_pressure_gradient3(u, v, w, p, cfg.n)

    def advect_self(self, u, v, w):
        """(u, v, w) advected by themselves, all three reading the
        pre-advection velocity (one K6 launch on the card)."""
        cfg = self.cfg
        if self.k3 is not None:
            return self.k3.advect3_shift_fused((1, 2, 3), (u, v, w), u, v, w,
                                               cfg.dt, cfg.n, self.cmax)
        return tuple(self.advect(b, f, u, v, w)
                     for b, f in ((1, u), (2, v), (3, w)))

    def advect(self, b, d0, u, v, w):
        cfg = self.cfg
        if self.k3 is not None:
            return self.k3.advect3_shift(b, d0, u, v, w, cfg.dt, cfg.n,
                                         self.cmax)
        if self.cmax is not None:
            return advect3_windowed(b, d0, u, v, w, cfg.dt, cfg.n, self.cmax)
        return advect3(b, d0, u, v, w, cfg.dt, cfg.n)


def _velocity_diffusion(cfg: SimConfig) -> tuple[int, float | None]:
    """(sweeps, Chebyshev rho or None) of the three velocity diffusions."""
    if cfg.diffusion_solver == "chebyshev":
        return cfg.cheby_iters, cfg.cheby_rho
    return cfg.jacobi_iters, None


def _diffuse_velocity(cfg, ops, u, v, w, u_src, v_src, w_src):
    alpha = cfg.diffusion_alpha_visc
    beta = 1.0 + 6.0 * alpha
    iters, rho = _velocity_diffusion(cfg)
    return tuple(ops.diffuse_src(b, src, x, alpha, beta, iters, rho)
                 for b, src, x in ((1, u_src, u), (2, v_src, v),
                                   (3, w_src, w)))


def vel_step3(cfg: SimConfig, u, v, w, u_src, v_src, w_src,
              ops: _Ops3 | None = None):
    """Velocity update: sources, diffusion, projection, self-advection,
    projection (through ``ops``, ``_Ops3(cfg)`` if None)."""
    _require_3d(cfg, "vel_step3")
    ops = ops if ops is not None else _Ops3(cfg)
    u, v, w = ops.project(*_diffuse_velocity(cfg, ops, u, v, w, u_src, v_src,
                                             w_src))
    return ops.project(*ops.advect_self(u, v, w))


def dens_step3(cfg: SimConfig, dens, dens_src, u, v, w,
               ops: _Ops3 | None = None):
    """Density update: source, diffusion, advection by the new velocity."""
    _require_3d(cfg, "dens_step3")
    ops = ops if ops is not None else _Ops3(cfg)
    alpha = cfg.diffusion_alpha_diff
    beta = 1.0 + 6.0 * alpha
    if cfg.diffusion_solver == "chebyshev-dens":
        iters, rho = cfg.cheby_dens_iters, cfg.cheby_rho
    elif cfg.diffusion_solver == "chebyshev":
        iters, rho = cfg.cheby_iters, cfg.cheby_rho
    else:
        iters, rho = cfg.jacobi_iters, None
    dens = ops.diffuse_src(0, dens_src, dens, alpha, beta, iters, rho)
    return ops.advect(0, dens, u, v, w)


def step3(cfg: SimConfig, state: FluidState, sources: Sources,
          ops: _Ops3 | None = None) -> FluidState:
    """One full 3-D timestep: ``vel_step3`` then ``dens_step3``, through
    ``ops`` (``_Ops3(cfg)`` if None)."""
    ops = ops if ops is not None else _Ops3(cfg)
    u, v, w = vel_step3(cfg, state.u, state.v, state.w, sources.u, sources.v,
                        sources.w, ops)
    dens = dens_step3(cfg, state.dens, sources.dens, u, v, w, ops)
    return FluidState(dens=dens, u=u, v=v, w=w)


def step_audited3(cfg: SimConfig, state: FluidState,
                  sources: Sources) -> tuple[FluidState, torch.Tensor]:
    """``step3`` plus the largest trilinear backtrace displacement (cells, a
    0-dim tensor) its advections see: the self-advection backtraces through
    the first projection's velocity, the density through the second's.
    Under ``advect_mode="windowed"`` the gathers were exact while it stays
    at or below ``cfg.max_courant`` and clamped above; under ``"auto"``/
    ``"exact"`` they are exact at any displacement, and the number says
    whether the windowed gather would have been.  In bf16 storage the
    displacement is bf16, as JAX's is."""
    _require_3d(cfg, "step_audited3")
    dt0 = cfg.dt * cfg.n

    def _disp(u, v, w):
        m = torch.maximum(u.abs().max(), v.abs().max())
        # dt0 rounded to the fields' dtype first, as JAX's weakly typed
        # scalar is.
        return torch.maximum(m, w.abs().max()) * as_scalar(dt0, m)

    ops = _Ops3(cfg)
    u, v, w = ops.project(*_diffuse_velocity(
        cfg, ops, state.u, state.v, state.w, sources.u, sources.v, sources.w))
    d_vel = _disp(u, v, w)
    u, v, w = ops.project(*ops.advect_self(u, v, w))
    d_dens = _disp(u, v, w)
    dens = dens_step3(cfg, state.dens, sources.dens, u, v, w)
    return (FluidState(dens=dens, u=u, v=v, w=w),
            torch.maximum(d_vel, d_dens))


def make_step_fn_3d(cfg: SimConfig) -> Callable[[FluidState, Sources],
                                                FluidState]:
    """``step3`` bound to ``cfg``."""
    _require_3d(cfg, "make_step_fn_3d")
    return functools.partial(step3, cfg)


class StableFluids3D:
    """Object-style wrapper around ``step3``."""

    def __init__(self, cfg: SimConfig):
        _require_3d(cfg, "StableFluids3D")
        self.cfg = cfg
        self._zeros = None

    def step(self, state: FluidState,
             sources: Sources | None = None) -> FluidState:
        if sources is None:
            if self._zeros is None:
                self._zeros = zero_sources(self.cfg)
            sources = self._zeros
        return step3(self.cfg, state, sources)
