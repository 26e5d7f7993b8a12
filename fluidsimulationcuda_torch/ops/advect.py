"""Semi-Lagrangian advection (plain torch; twin of the exact path of
``fluidsimulationcuda_tpu.ops.advect``).

Backtrace plus bilinear gather, matching ``advect`` in
``FluidSequential.c:107-141``: departure point ``(x, y) = (j, i) -
dt*n*(u, v)``, clamped to ``[0.5, n+0.5]`` (``:117-127``), truncated to the
lower cell (the clamp makes trunc == floor), bilinearly interpolated from
``d0`` (``:136-137``).  Exact for any displacement; the clamp keeps every
read inside the padded grid.
"""
from __future__ import annotations

import numpy as np
import torch

from .boundary import embed_interior

__all__ = ["advect", "backtrace"]


def backtrace(u: torch.Tensor, v: torch.Tensor, dt: float, n: int):
    """Clamped departure coordinates (x, y) of every interior cell, float32
    arrays of shape (n, n) in grid units (column, row).  ``dt0 = dt*n`` is
    taken in float32, as the JAX package takes it."""
    dt0 = float(np.float32(dt) * np.float32(n))
    idx = torch.arange(1, n + 1, dtype=torch.float32, device=u.device)
    x = idx[None, :] - dt0 * u[1:-1, 1:-1]
    y = idx[:, None] - dt0 * v[1:-1, 1:-1]
    return x.clamp(0.5, n + 0.5), y.clamp(0.5, n + 0.5)


def advect(b: int, d0: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
           dt: float, n: int) -> torch.Tensor:
    x, y = backtrace(u, v, dt, n)
    j0 = x.to(torch.int32)
    i0 = y.to(torch.int32)
    s1 = x - j0.to(torch.float32)
    s0 = 1.0 - s1
    t1 = y - i0.to(torch.float32)
    t0 = 1.0 - t1

    side = n + 2
    flat = d0.reshape(-1)
    base = (i0 * side + j0).to(torch.int64)
    g00 = flat[base]
    g10 = flat[base + side]
    g01 = flat[base + 1]
    g11 = flat[base + side + 1]
    interior = s0 * (t0 * g00 + t1 * g10) + s1 * (t0 * g01 + t1 * g11)
    return embed_interior(b, interior)
