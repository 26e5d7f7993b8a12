"""Semi-Lagrangian advection (plain torch; twin of
``fluidsimulationcuda_tpu.ops.advect``).

Backtrace plus bilinear gather, matching ``advect`` in
``FluidSequential.c:107-141``: departure point ``(x, y) = (j, i) -
dt*n*(u, v)``, clamped to ``[0.5, n+0.5]`` (``:117-127``), truncated to the
lower cell (the clamp makes trunc == floor), bilinearly interpolated from
``d0`` (``:136-137``).  ``advect`` is exact for any displacement; the clamp
keeps every read inside the padded grid.  ``advect_windowed`` also clamps
the departure point to ``cmax`` cells around its cell; the slab gathers of
the multi-device step (``kernels/cuda_sharded.py``) apply the same
``departure`` and ``bilinear`` at global coordinates.  ``advect`` and
``advect_windowed`` take one (side, side) grid or a batch of them on
leading axes.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .boundary import embed_interior

__all__ = ["advect", "advect_windowed", "backtrace", "bilinear", "departure"]


def departure(u: torch.Tensor, v: torch.Tensor, cols: torch.Tensor,
              rows: torch.Tensor, dt: float, n: int,
              cmax: int | None = None):
    """Departure points (x, y) in grid units (column, row) of the cells at
    padded-grid coordinates ``(cols, rows)`` (broadcast against the
    velocities ``u``, ``v`` of those cells): clamped to ``[0.5, n+0.5]``
    and then, with ``cmax``, to ``[g - cmax, g + cmax]`` around the cell's
    own coordinate ``g``, in that order.  ``dt0 = dt*n`` is taken in
    float32, as the JAX package takes it, and so is every coordinate: bf16
    velocities are widened first (JAX ``ops/advect.py:27-29``), since a
    grid index past 256 has no exact bf16 value."""
    dt0 = float(np.float32(dt) * np.float32(n))
    u, v = u.float(), v.float()
    x = (cols - dt0 * u).clamp(0.5, n + 0.5)
    y = (rows - dt0 * v).clamp(0.5, n + 0.5)
    if cmax is not None:
        x = torch.clamp(x, cols - cmax, cols + cmax)
        y = torch.clamp(y, rows - cmax, rows + cmax)
    return x, y


def backtrace(u: torch.Tensor, v: torch.Tensor, dt: float, n: int,
              cmax: int | None = None):
    """``departure`` of every interior cell of the (side, side) grid, or of
    each grid of a batch on leading axes: float32 arrays of shape (..., n,
    n)."""
    idx = torch.arange(1, n + 1, dtype=torch.float32, device=u.device)
    return departure(u[..., 1:-1, 1:-1], v[..., 1:-1, 1:-1], idx[None, :],
                     idx[:, None], dt, n, cmax)


def bilinear(d0: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             row0: int = 0, col0: int = 0) -> torch.Tensor:
    """Bilinear gather of ``d0`` at departure points (x, y) in the
    reference's blend order (the clamp makes trunc == floor); global row
    ``i`` is row ``i - row0`` of ``d0``, global column ``j`` its column
    ``j - col0``.  Leading axes of ``d0`` are a batch
    of grids: the points of grid ``g`` (the same leading index of x and y)
    gather from grid ``g`` alone.  The blend runs in float32 whatever
    ``d0`` stores, and the result is rounded to ``d0``'s dtype (JAX
    ``ops/advect.py:48-70``)."""
    j0 = x.to(torch.int32)
    i0 = y.to(torch.int32)
    s1 = x - j0.to(torch.float32)
    s0 = 1.0 - s1
    t1 = y - i0.to(torch.float32)
    t0 = 1.0 - t1

    side = d0.shape[-1]
    flat = d0.reshape(-1)
    base = ((i0 - row0) * side + (j0 - col0)).to(torch.int64)
    if d0.dim() > 2:
        # Each grid's flat offset, g * rows * side, broadcast over its points.
        grids = torch.arange(math.prod(d0.shape[:-2]), device=d0.device)
        base = base + (grids.reshape(d0.shape[:-2] + (1, 1))
                       * (d0.shape[-2] * side))
    g00 = flat[base]
    g10 = flat[base + side]
    g01 = flat[base + 1]
    g11 = flat[base + side + 1]
    out = s0 * (t0 * g00 + t1 * g10) + s1 * (t0 * g01 + t1 * g11)
    return out.to(d0.dtype)


def advect(b: int, d0: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
           dt: float, n: int) -> torch.Tensor:
    return embed_interior(b, bilinear(d0, *backtrace(u, v, dt, n)))


def advect_windowed(b: int, d0: torch.Tensor, u: torch.Tensor,
                    v: torch.Tensor, dt: float, n: int,
                    cmax: int) -> torch.Tensor:
    """Window-clamped advection (``ops/advect.py:73-145`` of the JAX
    package; ``departure`` with ``cmax``).  It equals ``advect`` while the
    displacement ``dt*n*|velocity|`` stays at or below ``cmax``, and is
    clamped, not refused, above it.  The JAX package sums (2*cmax+1)²
    masked shifts; after the window clamp every departure point lies inside
    the window, so a direct gather reads the same four values."""
    return embed_interior(b, bilinear(d0, *backtrace(u, v, dt, n, cmax)))
