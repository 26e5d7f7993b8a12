"""Pressure projection (plain torch; twin of
``fluidsimulationcuda_tpu.ops.project``).

Divergence with a zero pressure guess (``computeDivergenceAndPressure``,
``FluidSequential.c:143-158``), Jacobi Poisson solve (alpha=1, beta=4,
``:218-220``), and gradient subtraction (``lastProject``, ``:161-173``).
Each takes one (side, side) grid or a batch of them on leading axes.
"""
from __future__ import annotations

import numpy as np
import torch

from .boundary import embed_interior
from .diffuse import as_scalar, diffuse

__all__ = ["divergence", "pressure_solve", "apply_pressure_gradient", "project"]


def grid_h(n: int) -> float:
    """The cell size ``h = 1/n``, taken in float32 as the reference takes it."""
    return float(np.float32(1.0) / np.float32(n))


def _h(n: int, like: torch.Tensor) -> torch.Tensor:
    """``h = 1/n`` as the JAX package takes it, ``jnp.asarray(1.0, dtype) /
    n``: n and the quotient rounded to ``like``'s dtype (``grid_h(n)`` in
    float32; in bf16 n=2046 rounds to 2048 first)."""
    return as_scalar(1.0, like) / as_scalar(n, like)


def divergence(u: torch.Tensor, v: torch.Tensor, n: int) -> torch.Tensor:
    """``div = -0.5*h*(uR-uL + vD-vU)``, ``h = 1/n``
    (``FluidSequential.c:148-155``); boundary mode 0."""
    coef = as_scalar(-0.5, u) * _h(n, u)  # exact: a power-of-two scaling
    d = coef * ((u[..., 1:-1, 2:] - u[..., 1:-1, :-2])
                + (v[..., 2:, 1:-1] - v[..., :-2, 1:-1]))
    return embed_interior(0, d)


def pressure_solve(div: torch.Tensor, iters: int) -> torch.Tensor:
    """Jacobi Poisson solve from a zero guess (p is zeroed in the reference,
    ``FluidSequential.c:153``)."""
    return diffuse(0, torch.zeros_like(div), div, 1.0, 4.0, iters)


def apply_pressure_gradient(u: torch.Tensor, v: torch.Tensor,
                            p: torch.Tensor, n: int):
    """``u -= 0.5*(pR-pL)/h``, ``v -= 0.5*(pD-pU)/h``
    (``FluidSequential.c:165-172``); boundary modes 1 and 2.  Written in
    u's dtype: a float32 pressure (bf16 multigrid's) against bf16 u, v is
    computed in float32 and rounded once, as JAX's Pallas ``gradient_p``
    writes it; JAX's jnp version returns float32 there (ROADMAP §C)."""
    h = _h(n, u)
    un = (u[..., 1:-1, 1:-1]
          - (0.5 * (p[..., 1:-1, 2:] - p[..., 1:-1, :-2])) / h)
    vn = (v[..., 1:-1, 1:-1]
          - (0.5 * (p[..., 2:, 1:-1] - p[..., :-2, 1:-1])) / h)
    return (embed_interior(1, un.to(u.dtype)),
            embed_interior(2, vn.to(v.dtype)))


def project(u: torch.Tensor, v: torch.Tensor, n: int, iters: int):
    div = divergence(u, v, n)
    p = pressure_solve(div, iters)
    return apply_pressure_gradient(u, v, p, n)
