"""Jacobi diffusion / Poisson solves (plain torch; twin of
``fluidsimulationcuda_tpu.ops.diffuse``).

The plain form of the CUDA ``jacobi_sweep`` kernel: one sweep is one
``jacobi_sweep`` call, and a solve is a Python loop of them.
"""
from __future__ import annotations

import torch

from .boundary import embed_interior

__all__ = ["jacobi_sweep", "diffuse", "damped_diffuse", "as_scalar"]


def as_scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim tensor of ``like``'s dtype on ``like``'s device
    (the twin of ``jnp.asarray(value, dtype)``).  Dividing by it is a true
    division on every device; dividing a CUDA tensor by a python scalar
    multiplies by the reciprocal instead, one rounding away from the
    reference's expression."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def jacobi_sweep(b: int, x: torch.Tensor, rhs_int: torch.Tensor, alpha,
                 beta) -> torch.Tensor:
    """One Jacobi sweep (``FluidSequential.c:93-101``):
    ``x'[c] = (rhs[c] + alpha*(xL+xR+xU+xD)) / beta`` on the interior, border
    re-derived by the mode-``b`` rule.  ``rhs_int`` is the (n, n) interior
    of the right-hand side; ``alpha`` and ``beta`` are floats or 0-dim
    tensors.  Leading axes are a batch of grids, each swept alone."""
    neigh = (((x[..., 1:-1, :-2] + x[..., 1:-1, 2:]) + x[..., :-2, 1:-1])
             + x[..., 2:, 1:-1])
    return embed_interior(b, (rhs_int + alpha * neigh) / beta)


def diffuse(b: int, x_init: torch.Tensor, x0: torch.Tensor, alpha: float,
            beta: float, iters: int) -> torch.Tensor:
    """``iters`` Jacobi sweeps from guess ``x_init`` with RHS ``x0``
    (``FluidSequential.c:85-104``).  Covers diffusion (alpha = dt*k*n²,
    beta = 1+4*alpha) and the pressure Poisson solve (alpha=1, beta=4), on
    one (side, side) grid or a batch of them."""
    a = as_scalar(alpha, x0)
    bt = as_scalar(beta, x0)
    rhs_int = x0[..., 1:-1, 1:-1]
    x = x_init
    for _ in range(iters):
        x = jacobi_sweep(b, x, rhs_int, a, bt)
    return x


def damped_diffuse(b: int, x_init: torch.Tensor, x0: torch.Tensor,
                   alpha: float, beta: float, iters: int, damp: float, *,
                   omega_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``iters`` damped Jacobi sweeps ``x <- (1-w)*x + w*S(x)`` with
    ``w = damp`` and ``S`` the sweep of ``diffuse`` (guess ``x_init``, rhs
    ``x0``), in the order of the TPU kernel's damped mode
    (``pallas_ops.py:456-459``).  w and 1-w are taken in the guess's dtype
    (or ``omega_dtype``), 1-w from float64 and rounded once, as JAX's
    multigrid ``_smooth`` takes ``jnp.asarray(1.0 - w, p.dtype)``: in
    bf16 0.80078125 and 0.2001953125."""
    wt = dict(dtype=omega_dtype or x_init.dtype, device=x_init.device)
    w = torch.full((), damp, **wt)
    omw = torch.full((), 1.0 - damp, **wt)
    a = as_scalar(alpha, x0)
    bt = as_scalar(beta, x0)
    rhs_int = x0[..., 1:-1, 1:-1]
    x = x_init
    for _ in range(iters):
        neigh = (((x[..., 1:-1, :-2] + x[..., 1:-1, 2:]) + x[..., :-2, 1:-1])
                 + x[..., 2:, 1:-1])
        val = (rhs_int + a * neigh) / bt
        x = embed_interior(b, omw * x[..., 1:-1, 1:-1] + w * val)
    return x
