"""Batched simulation: datagen over a leading batch axis (PyTorch twin of
``fluidsimulationcuda_tpu.models.batched``, BASELINE config 4: 1024
independent 256² sims).

The reference runs one simulation per process (``FluidSequential.c:273-334``).
Here every 2-D op of either backend takes a batch of grids ``(B, side,
side)`` directly: the ``reference`` ops slice the last two axes, and the
``cuda`` kernels K1-K4 launch every grid of the batch in one launch; the
multigrid and CG solves reduce each grid over its last two axes.  So a
batched step is the 2-D ``step`` itself, with the launches of one grid (105
a step in parity, 63 in the compensated mode) whatever B is.  JAX's
``_use_batched_pallas``/``_batched_cfg`` split (Pallas kernels or a vmapped
jnp step) has no counterpart.

Sources fire on step 1 only, as in the reference harness.  The random
draws come from a ``torch.Generator`` (``core.state.reference_init``), so
they differ from the JAX package's ``jax.random`` bits; tests feed both
packages the same numpy arrays through ``_trajectory_runner`` and
``_probe_cmax``.
"""
from __future__ import annotations

import math
import warnings
from typing import Callable

import torch

from ..core.config import SimConfig
from ..core.state import (FluidState, Sources, reference_init,
                          zero_sources_like)
from .stable_fluids_2d import make_step_fn, step_audited

__all__ = ["batched_init", "make_batched_step_fn", "select_cmax_batched",
           "generate_trajectories"]


def batched_init(generator: torch.Generator, cfg: SimConfig,
                 batch: int) -> tuple[FluidState, Sources]:
    """``batch`` independent reference-style initial conditions (each a
    draw of ``reference_init`` from ``generator``), stacked on a leading
    axis."""
    states, sources = zip(*(reference_init(generator, cfg)
                            for _ in range(batch)))

    def stack(parts):
        return type(parts[0])(*(None if f[0] is None else torch.stack(f)
                                for f in zip(*parts)))

    return stack(states), stack(sources)


def make_batched_step_fn(cfg: SimConfig) -> Callable:
    """``step`` bound to ``cfg``, for a batched state and sources.  Every
    pressure solver takes the batch: the Jacobi and Chebyshev solves on
    kernels with a batch axis, the multigrid and CG solves per grid over
    the last two axes (``ops/multigrid.py``, ``ops/cg.py``), as JAX's
    vmapped step runs them (``models/batched.py:38-63`` there)."""
    return make_step_fn(cfg)


def _probe_cmax(cfg: SimConfig, state: FluidState, sources: Sources, *,
                probe_steps: int = 8,
                margin: float = 0.25) -> tuple[int, float]:
    """``select_cmax_batched``'s probe on a given batch: ``probe_steps``
    audited steps of ``cfg`` with exact gathers (``advect_mode="exact"`` on
    the config's own backend, so the true trajectory at any displacement),
    sources on the first only.  Returns the smallest window with ``margin``
    cells to spare and the largest displacement seen."""
    exact = cfg.replace(advect_mode="exact")
    zeros = zero_sources_like(sources)
    dmax = torch.zeros((), dtype=torch.float32, device=state.dens.device)
    for k in range(probe_steps):
        state, d = step_audited(exact, state, sources if k == 0 else zeros)
        dmax = torch.maximum(dmax, d)
    probed = float(dmax)  # the probe's one host sync
    return max(1, int(math.floor(probed + margin)) + 1), probed


def select_cmax_batched(generator: torch.Generator, cfg: SimConfig,
                        batch: int, *, probe_steps: int = 8,
                        margin: float = 0.25) -> tuple[int, float]:
    """Pick the smallest exact gather window for a datagen run: replay the
    first ``probe_steps`` steps of a batch drawn from ``generator`` with
    exact gathers while auditing the largest backtrace displacement, and
    return ``(cmax, probed_displacement)``, ``cmax`` with ``margin`` cells
    to spare.  Datagen displacement peaks at injection and decays under
    viscosity, so the probe sees the maximum; ``generate_trajectories``
    audits the whole run."""
    state, sources = batched_init(generator, cfg, batch)
    return _probe_cmax(cfg, state, sources, probe_steps=probe_steps,
                       margin=margin)


def generate_trajectories(generator: torch.Generator, cfg: SimConfig,
                          batch: int, num_steps: int, *,
                          snapshot_every: int = 0, auto_cmax: bool = False):
    """Run ``batch`` sims drawn from ``generator`` for ``num_steps`` steps
    (sources on step 1 only).  Returns ``(final_state, snapshots,
    max_disp)``: the final batched state; with ``snapshot_every=k`` the
    density every k steps, ``(num_steps // k, batch, side, side)``, else
    None; and the largest backtrace displacement (cells, a 0-dim tensor)
    of any advection of the run: under ``advect_mode="windowed"`` the
    gathers were exact while it stays at or below ``cfg.max_courant``.

    ``auto_cmax=True`` first probes the same batch with exact gathers
    (``select_cmax_batched``) and sets ``cfg.max_courant`` to the smallest
    exact window, growing it, with a warning, when the probe exceeds the
    configured one."""
    state, sources = batched_init(generator, cfg, batch)
    if auto_cmax:
        cmax, probed = _probe_cmax(cfg, state, sources)
        if cmax > cfg.max_courant:
            # Growing the window keeps the run exact; clamping silently
            # would not.
            warnings.warn(
                f"probed displacement {probed:.3f} cells exceeds the "
                f"configured max_courant={cfg.max_courant}; growing the "
                f"gather window to cmax={cmax} to keep the run exact",
                stacklevel=2)
        cfg = cfg.replace(max_courant=cmax)
    return _trajectory_runner(cfg, num_steps, snapshot_every)(state, sources)


def _trajectory_runner(cfg: SimConfig, num_steps: int, snapshot_every: int):
    """The trajectory loop of ``generate_trajectories`` (JAX's scan), as a
    function of ``(state, sources)``.  The audited displacement's running
    maximum stays a 0-dim device tensor: nothing syncs with the host
    inside the loop."""

    def run(state: FluidState, sources: Sources):
        zeros = zero_sources_like(sources)
        dmax = torch.zeros((), dtype=torch.float32, device=state.dens.device)
        num_snaps = num_steps // snapshot_every if snapshot_every else 0
        snaps = state.dens.new_empty((num_snaps,) + state.dens.shape)
        for k in range(num_steps):
            state, d = step_audited(cfg, state, sources if k == 0 else zeros)
            dmax = torch.maximum(dmax, d)
            if snapshot_every and (k + 1) % snapshot_every == 0:
                snaps[(k + 1) // snapshot_every - 1].copy_(state.dens)
        return state, (snaps if snapshot_every else None), dmax

    return run
