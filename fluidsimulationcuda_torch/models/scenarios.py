"""Initial-condition and forcing scenarios (PyTorch twin of
``fluidsimulationcuda_tpu.models.scenarios``).

The reference has one scenario, a random centre-square density source with
uniform random velocities on step 1 (``initializeParameters``,
``FluidSequential.c:244-271``; ``reference_init`` here).  These add the JAX
package's demo set.  Each takes ``(generator, cfg)`` and returns
``(FluidState, Sources, sources_every_step)``; the random draws come from
the ``torch.Generator``, so ``reference_square`` and ``plume`` differ from
the JAX package's bits, while ``vortex_pair`` and ``opposing_jets`` draw
nothing and equal its arrays.
"""
from __future__ import annotations

import torch

from ..core.config import SimConfig
from ..core.state import Sources, reference_init, zero_state

__all__ = ["reference_square", "plume", "vortex_pair", "opposing_jets",
           "SCENARIOS"]


def _coords(cfg: SimConfig):
    c = torch.arange(cfg.n + 2, dtype=cfg.dtype, device=cfg.device)
    return torch.meshgrid(c, c, indexing="ij")  # (ii rows/y, jj cols/x)


def _where(mask: torch.Tensor, value) -> torch.Tensor:
    return torch.where(mask, value, 0.0).to(torch.float32)


def _normal(generator: torch.Generator, cfg: SimConfig) -> torch.Tensor:
    """Standard normal draws of the grid's shape from ``generator`` (on its
    device), moved to ``cfg.device``."""
    return torch.randn(cfg.grid_shape, generator=generator, dtype=cfg.dtype,
                       device=generator.device).to(cfg.device)


def reference_square(generator: torch.Generator, cfg: SimConfig):
    """The reference's own scenario (impulse sources, step 1 only)."""
    state, sources = reference_init(generator, cfg)
    return state, sources, False


def plume(generator: torch.Generator, cfg: SimConfig):
    """Continuous bottom-centre dye inflow with upward velocity, a smoke
    plume (sources every step).  In 3-D the nozzle is a cylinder and y
    stays the vertical axis (row 0 = top, as in 2-D)."""
    side = cfg.n + 2
    cx = side / 2.0
    r = side / 16.0
    if cfg.ndim == 3:
        c = torch.arange(side, dtype=cfg.dtype, device=cfg.device)
        zz, yy, xx = c[:, None, None], c[None, :, None], c[None, None, :]
        nozzle = (((xx - cx) ** 2 + (zz - cx) ** 2 < r ** 2)
                  & (yy > side - side // 8))
        dens = _where(nozzle, 2.0)
        v = _where(nozzle, -3.0)  # upward
        u = _where(nozzle, 0.3 * _normal(generator, cfg))
        w = _where(nozzle, 0.3 * _normal(generator, cfg))
        return zero_state(cfg), Sources(dens=dens, u=u, v=v, w=w), True
    ii, jj = _coords(cfg)
    nozzle = ((jj - cx) ** 2 < r ** 2) & (ii > side - side // 8)
    dens = _where(nozzle, 2.0)
    v = _where(nozzle, -3.0)  # upward (row 0 = top)
    u = _where(nozzle, 0.3 * _normal(generator, cfg))
    return zero_state(cfg), Sources(dens=dens, u=u, v=v), True


def vortex_pair(generator: torch.Generator, cfg: SimConfig):
    """Two counter-rotating vortices advecting a dye stripe (impulse).
    2-D only."""
    if cfg.ndim != 2:
        raise ValueError("scenario 'vortex-pair' is 2-D only; "
                         "use 'plume' or 'reference' for ndim=3")
    side = cfg.n + 2
    ii, jj = _coords(cfg)
    y = (ii - side / 2.0) / side
    x = (jj - side / 2.0) / side

    def vortex(cx, cy, sign):
        dx, dy = x - cx, y - cy
        r2 = dx * dx + dy * dy + 1e-4
        amp = sign * torch.exp(-r2 * 80.0)
        return -dy * amp, dx * amp

    u1, v1 = vortex(-0.15, 0.0, 40.0)
    u2, v2 = vortex(0.15, 0.0, -40.0)
    dens = torch.exp(-(y * y) * 200.0)  # horizontal stripe
    return zero_state(cfg), Sources(dens=dens, u=u1 + u2, v=v1 + v2), False


def opposing_jets(generator: torch.Generator, cfg: SimConfig):
    """Left and right inflow jets colliding at the centre (continuous).
    2-D only."""
    if cfg.ndim != 2:
        raise ValueError("scenario 'jets' is 2-D only; "
                         "use 'plume' or 'reference' for ndim=3")
    side = cfg.n + 2
    ii, jj = _coords(cfg)
    band = (ii - side / 2.0).abs() < side / 24.0
    left = band & (jj < side // 10)
    right = band & (jj > side - side // 10)
    u = _where(left, 2.0) + _where(right, -2.0)
    dens = _where(left | right, 1.0)
    return (zero_state(cfg), Sources(dens=dens, u=u, v=torch.zeros_like(u)),
            True)


SCENARIOS = {
    "reference": reference_square,
    "plume": plume,
    "vortex-pair": vortex_pair,
    "jets": opposing_jets,
}
