"""Boundary conditions (PyTorch twin of ``fluidsimulationcuda_tpu.ops.boundary``).

The border of the padded grid is a *derived* quantity of the interior:
``embed_interior`` builds the ghost border and corners of an (n+2, n+2)
grid from its (n, n) interior, which is ``set_bnd``
(``FluidSequential.c:62-75``) without a separate pass.  The CUDA kernels
use the same idea: a ghost-cell thread derives its value from the interior
cell next to it in the launch that computes that cell.

Boundary modes (b): 0 = plain copy (scalars/density/pressure), 1 = negate at
left/right walls (x-velocity), 2 = negate at top/bottom walls (y-velocity).
"""
from __future__ import annotations

import torch

__all__ = ["set_bnd", "embed_interior", "embed_copy"]


def _signs(b: int) -> tuple[float, float]:
    return (-1.0 if b == 1 else 1.0), (-1.0 if b == 2 else 1.0)


def embed_interior(b: int, interior: torch.Tensor) -> torch.Tensor:
    """The full (n+2, n+2) grid from an (n, n) interior, its ghost border
    derived by the mode-``b`` rule: edges mirror the adjacent interior cell
    (negated on the wall-normal component), corners average their two
    adjacent edge cells (``FluidSequential.c:71-74``), in the expression
    order of the JAX ``embed_interior``."""
    sx, sy = _signs(b)
    n = interior.shape[-1]
    out = interior.new_empty(interior.shape[:-2] + (n + 2, n + 2))
    out[..., 1:-1, 1:-1] = interior
    out[..., 1:-1, 0] = sx * interior[..., :, 0]
    out[..., 1:-1, -1] = sx * interior[..., :, -1]
    out[..., 0, 1:-1] = sy * interior[..., 0, :]
    out[..., -1, 1:-1] = sy * interior[..., -1, :]
    for r, c in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
        corner = interior[..., r, c]
        out[..., r, c] = 0.5 * (sy * corner + sx * corner)
    return out


def embed_copy(interior: torch.Tensor) -> torch.Tensor:
    """``embed_interior(0, interior)`` in one replicate pad: under mode 0 an
    edge is a copy of its interior cell and a corner ``0.5*(v + v)``, which
    is ``v`` to the bit, so the two are equal.  For one (n, n) interior or
    a batch of them on leading axes, as the multigrid and CG solves build
    their iterates."""
    flat = interior.reshape((-1,) + interior.shape[-2:])
    out = torch.nn.functional.pad(flat, (1, 1, 1, 1), mode="replicate")
    return out.reshape(interior.shape[:-2] + out.shape[-2:])


def set_bnd(b: int, x: torch.Tensor) -> torch.Tensor:
    """Re-derive the border of a full padded grid from its interior — the
    functional equivalent of ``set_bnd(b, x)`` (``FluidSequential.c:62-75``)."""
    return embed_interior(b, x[..., 1:-1, 1:-1])
