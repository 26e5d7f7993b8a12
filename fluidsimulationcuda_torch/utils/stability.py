"""Stability diagnostics (PyTorch twin of
``fluidsimulationcuda_tpu.utils.stability``).

The reference calls ``//checkStability(u, v);`` (``FluidSequential.c:309``),
commented out and defined nowhere.  Here it is one reduction pass over the
state that returns 0-dim tensors on the state's device, so a host loop
reads them only when it needs a verdict:

- ``finite``: no NaN/Inf in any field;
- ``max_displacement``: ``dt·n·max component speed`` in cells, the number
  the audited steps measure at their advections, here from the stored state;
- ``max_speed`` / ``max_density``: watermarks for drift over a long run.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import SimConfig
from ..core.state import FluidState

__all__ = ["StabilityReport", "check_stability", "is_stable"]


class StabilityReport(NamedTuple):
    """Scalar diagnostics of a :class:`FluidState` (all 0-dim tensors)."""

    finite: torch.Tensor            # bool: every field free of NaN/Inf
    max_displacement: torch.Tensor  # cells: dt * n * max component speed
    max_speed: torch.Tensor         # max(|u|, |v|[, |w|])
    max_density: torch.Tensor       # max|dens|


def check_stability(cfg: SimConfig, state: FluidState) -> StabilityReport:
    """One reduction pass of stability diagnostics; nothing syncs with the
    host.  The displacement takes the per-component maximum, as the
    gather window is per axis (``ops/advect.py:advect_windowed``)."""
    fields = [f for f in state if f is not None]
    finite = torch.stack([torch.isfinite(f).all() for f in fields]).all()
    max_speed = torch.stack([f.abs().max() for f in fields[1:]]).max()
    disp = torch.tensor(cfg.dt * cfg.n, dtype=state.dens.dtype,
                        device=state.dens.device) * max_speed
    return StabilityReport(finite=finite, max_displacement=disp,
                           max_speed=max_speed,
                           max_density=state.dens.abs().max())


def is_stable(cfg: SimConfig, state: FluidState) -> bool:
    """Host-side verdict: finite everywhere and the stored state's
    displacement under ``cfg.max_courant``.  A screen, not a proof of
    exactness: a step backtraces through post-projection velocities that
    can exceed the stored state's, which is why ``step_audited`` measures
    at its advections.  Reads the device."""
    rep = check_stability(cfg, state)
    return bool(rep.finite) and float(rep.max_displacement) < cfg.max_courant
