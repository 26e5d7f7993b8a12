"""Solver-quality validation bars (PyTorch twin of
``fluidsimulationcuda_tpu.utils.validate``; the CLI's ``run --validate``).

A performance mode (the Chebyshev solves, ``ops/chebyshev.py``) is honest
only where it is measured: the operating points are size-coupled, so a
point validated at one grid is validated again at another.  Each bar says
"the perf solve is no worse than the parity Jacobi solve on the same
states":

- ``audit_divergence``: post-projection max|div| (incompressibility);
- ``audit_diffusion_residual``: the velocity diffusion solve's residual
  ratio;
- ``audit_dens_residual``: the density solve's residual ratio on a forcing
  twin (the decay trajectory's density is extinct by steady state).

With them the exactness audit of the windowed gather
(``audit_displacement`` / ``select_cmax``): the gather is exact while the
displacement stays under ``cmax`` (``ops/advect.py:advect_windowed``).

Every function runs on ``cfg.device`` and reads one number a step back to
the host.  The random draws come from a ``torch.Generator`` on that device
seeded 0 where the JAX package takes ``jax.random.key(0)``, so the two
packages' bars agree when fed the same draws, not bit for bit on their own.
"""
from __future__ import annotations

import math

import torch

from ..core.config import SimConfig
from ..core.state import Sources, reference_init, zero_sources
from ..models.stable_fluids_2d import make_step_fn, step_audited
from ..ops.chebyshev import cheby_diffuse
from ..ops.diffuse import as_scalar, diffuse
from ..ops.project import divergence

__all__ = [
    "inject_exact",
    "audit_displacement",
    "select_cmax",
    "audit_divergence",
    "audit_diffusion_residual",
    "audit_diffusion_residual_twin",
    "audit_dens_residual",
    "validate_perf_point",
]


def _draw(cfg: SimConfig):
    """``reference_init`` from a generator on ``cfg.device`` seeded 0."""
    return reference_init(torch.Generator(device=cfg.device).manual_seed(0),
                          cfg)


def inject_exact(cfg: SimConfig):
    """Run the source-injection step with exact gathers on the
    ``reference`` backend, on ``cfg.device``.

    The impulse backtraces ~``0.01 * dt * n`` cells on the first step (~21
    at 2048², far outside any practical window) before viscosity flattens
    the field to sub-cell displacements by step 3, so that one step runs
    exact and the timed steady state may run windowed.  Returns (the
    post-injection state, the transient displacement in cells)."""
    exact_cfg = cfg.replace(backend="reference", advect_mode="exact")
    state, sources = _draw(exact_cfg)
    state, disp = step_audited(exact_cfg, state, sources)
    return state, float(disp)


def audit_displacement(cfg: SimConfig, state, steps: int,
                       drive=None) -> float:
    """The largest backtrace displacement (cells) any advection sees over
    ``steps`` audited steps from ``state`` (``drive``: the sources of every
    step; None: zero, the steady decay).  The trajectory is deterministic,
    so this replay sees what a timed run of the same steps does."""
    drive = zero_sources(cfg) if drive is None else drive
    dmax = torch.zeros((), dtype=torch.float32, device=cfg.device)
    for _ in range(steps):
        state, d = step_audited(cfg, state, drive)
        dmax = torch.maximum(dmax, d)
    return float(dmax)


def select_cmax(cfg: SimConfig, state, steps: int, margin: float = 0.25,
                drive=None):
    """The smallest gather window ``cmax`` whose exactness condition
    (displacement < cmax) holds with ``margin`` cells to spare over the
    audited trajectory, and the displacement audited.  A clamped replay is
    not the true trajectory, so the candidate window grows until the audit
    fits, then shrinks to the smallest sufficient one (no clamp fires
    under either, so the trajectory is the same)."""
    c = cfg.max_courant
    for _ in range(6):
        dmax = audit_displacement(cfg.replace(max_courant=c), state, steps,
                                  drive=drive)
        if dmax < c - margin:
            return max(1, int(math.floor(dmax + margin)) + 1), dmax
        c = int(math.ceil(dmax + 2 * margin))
    return c, dmax


def audit_divergence(cfg: SimConfig, state, steps: int, drive=None) -> float:
    """The largest post-step max|divergence| of the stored velocity over
    ``steps`` steps of ``cfg`` from ``state``: the perf mode is honest only
    if this is no worse than the parity Jacobi solve's on the same
    trajectory."""
    drive = zero_sources(cfg) if drive is None else drive
    step_fn = make_step_fn(cfg)
    worst = 0.0
    for _ in range(steps):
        state = step_fn(state, drive)
        worst = max(worst, float(divergence(state.u, state.v,
                                            cfg.n).abs().max()))
    return worst


def _residual(x, rhs, alpha: float, beta: float) -> torch.Tensor:
    """max|beta*x - rhs - alpha*neighbours| over the interior, in the JAX
    bar's summation order with float32 constants."""
    nb = (((x[1:-1, :-2] + x[1:-1, 2:]) + x[:-2, 1:-1]) + x[2:, 1:-1])
    r = (as_scalar(beta, x) * x[1:-1, 1:-1] - rhs[1:-1, 1:-1]
         - as_scalar(alpha, x) * nb)
    return r.abs().max()


def _worst_ratio(pairs) -> tuple:
    """The largest rc / rj of the ``(rc, rj)`` residual pairs with rj > 0,
    and its pair, as floats."""
    worst, worst_pair = 0.0, (0.0, 0.0)
    for rc, rj in pairs:
        rc, rj = float(rc), float(rj)
        if rj > 0 and rc / rj > worst:
            worst, worst_pair = rc / rj, (rc, rj)
    return worst, worst_pair


def audit_diffusion_residual(cfg: SimConfig, state, steps: int,
                             drive=None) -> tuple:
    """The worst relative residual ratio (Chebyshev-``cheby_iters`` solve
    over Jacobi-``jacobi_iters`` solve) of the velocity diffusion along the
    trajectory, and its pair: <= 1 means the perf solve leaves every state
    at least as converged as the parity solve."""
    alpha = cfg.diffusion_alpha_visc
    beta = 1.0 + 4.0 * alpha
    step_fn = make_step_fn(cfg)
    drive = zero_sources(cfg) if drive is None else drive

    def ratio(u):
        zero = torch.zeros_like(u)
        rj = _residual(diffuse(1, zero, u, alpha, beta, cfg.jacobi_iters), u,
                       alpha, beta)
        rc = _residual(cheby_diffuse(1, zero, u, alpha, beta,
                                     cfg.cheby_iters, cfg.cheby_rho), u,
                       alpha, beta)
        return rc, rj

    pairs = []
    for _ in range(steps):
        state = step_fn(state, drive)
        pairs.append(ratio(state.u))
    return _worst_ratio(pairs)


def _forcing_twin(cfg: SimConfig, forcing: float):
    """The forcing twin's config (a window of at least 2 cells: the twin
    displaces ~1.5) and its drive, ``forcing`` times the drawn sources
    every step."""
    cfg = cfg.replace(max_courant=max(cfg.max_courant, 2))
    _, sources = _draw(cfg)
    scale = torch.tensor(forcing, dtype=torch.float32, device=cfg.device)
    return cfg, Sources(*(None if s is None else scale * s for s in sources))


def audit_diffusion_residual_twin(cfg: SimConfig, state, steps: int,
                                  forcing: float = 0.05) -> tuple:
    """``audit_diffusion_residual`` on a continuous-forcing twin of the
    trajectory: where diffusion extinguishes the decay trajectory's
    velocities (8192², 40 it), its residuals are denormal noise whose ratio
    means nothing."""
    cfg, drive = _forcing_twin(cfg, forcing)
    return audit_diffusion_residual(cfg, state, steps, drive=drive)


def audit_dens_residual(cfg: SimConfig, state, steps: int,
                        forcing: float = 0.05) -> tuple:
    """The worst density-solve residual ratio (Chebyshev-
    ``cheby_dens_iters`` over Jacobi-``jacobi_iters``) along a
    continuous-forcing twin of the trajectory, and its pair: the bar for
    the "chebyshev-dens" swap, where the decay density is extinct by the
    steady state."""
    alpha = cfg.diffusion_alpha_diff
    beta = 1.0 + 4.0 * alpha
    cfg, drive = _forcing_twin(cfg, forcing)
    step_fn = make_step_fn(cfg)

    def ratio(dens):
        rhs = dens + cfg.dt * drive.dens
        rj = _residual(diffuse(0, rhs, rhs, alpha, beta, cfg.jacobi_iters),
                       rhs, alpha, beta)
        rc = _residual(cheby_diffuse(0, rhs, rhs, alpha, beta,
                                     cfg.cheby_dens_iters, cfg.cheby_rho),
                       rhs, alpha, beta)
        return rc, rj

    pairs = []
    for _ in range(steps):
        state = step_fn(state, drive)
        pairs.append(ratio(state.dens))
    return _worst_ratio(pairs)


def validate_perf_point(cfg: SimConfig, perf_cfg: SimConfig,
                        steps: int = 20) -> dict:
    """The bars for ``perf_cfg`` against the parity ``cfg`` at the
    requested size (2-D), as the CLI's ``run --validate`` runs them.
    Returns the bar values and booleans; ``ok`` is the conjunction of the
    bars that apply to the perf config's solvers."""
    state, _ = inject_exact(cfg)
    out = {}
    div_jac = audit_divergence(cfg, state, steps)
    div_perf = audit_divergence(perf_cfg, state, steps)
    out["max_abs_divergence"] = div_perf
    out["jacobi_max_abs_divergence"] = div_jac
    out["divergence_ok"] = bool(div_perf <= div_jac)
    ok = out["divergence_ok"]
    if perf_cfg.diffusion_solver == "chebyshev":
        # The forcing twin: decay velocities can be extinct, and a ratio of
        # denormal noise would fail the bar for nothing.
        ratio, _pair = audit_diffusion_residual_twin(perf_cfg, state,
                                                     min(8, steps))
        out["diffusion_residual_ratio"] = ratio
        out["diffusion_ok"] = bool(ratio <= 1.0)
        ok = ok and out["diffusion_ok"]
    if perf_cfg.diffusion_solver in ("chebyshev", "chebyshev-dens"):
        dcfg = perf_cfg
        if perf_cfg.diffusion_solver == "chebyshev":
            dcfg = perf_cfg.replace(cheby_dens_iters=perf_cfg.cheby_iters)
        dratio, _pair = audit_dens_residual(dcfg, state, min(8, steps))
        out["dens_residual_ratio"] = dratio
        out["dens_ok"] = bool(dratio <= 1.0)
        ok = ok and out["dens_ok"]
    out["ok"] = ok
    return out
