"""Conjugate-gradient pressure solver (plain torch; twin of
``fluidsimulationcuda_tpu.ops.cg``).

Solves the same discrete Poisson problem as the projection's Jacobi solve,

    A p = div,   A p := 4 p - (pL + pR + pU + pD)   (unit index spacing),

with the copy (mode 0) ghost rule folded into the operator: ghosts mirror
the adjacent interior cell, so A is symmetric positive semi-definite on the
mean-zero subspace CG walks.  Plain CG from p = 0, no preconditioner (a
Jacobi one, diag(A) = 4I, only rescales).  An optional alternative to the
parity solve (``SimConfig.pressure_solver = "cg"``), non-parity numerics.

In bf16 storage the solve stays bf16, as JAX's does, its dot products
summed in float32 (``_dot``).  No kernel: both backends run this code (the projection around it takes
K2's divergence and gradient on the card).  It takes one padded grid or a
batch of them on leading axes, each solved alone, as JAX's vmapped solve
runs them: every reduction is per grid, over the last two axes.  The
scalars of the recurrence (``rs``, ``alpha``, ``beta``, one per grid) stay
tensors on the solve's device, so an iteration never waits for the host
and a step that calls it can be captured as a CUDA graph.
"""
from __future__ import annotations

import torch

from .boundary import embed_copy
from .diffuse import as_scalar

__all__ = ["cg_pressure_solve", "cg_residual_norm"]


def _apply_A_bc(p_int: torch.Tensor) -> torch.Tensor:
    """A with the copy ghost rule folded in: the interior with mirrored
    ghosts, then the 5-point operator."""
    p = embed_copy(p_int)
    return 4.0 * p[..., 1:-1, 1:-1] - (
        ((p[..., 1:-1, :-2] + p[..., 1:-1, 2:]) + p[..., :-2, 1:-1])
        + p[..., 2:, 1:-1])


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each grid's sum of ``a * b``, kept as a (..., 1, 1) tensor of their
    dtype.  The products and the sum are float32 and only the sum is
    rounded: in bf16, XLA fuses JAX's ``jnp.sum(r * r)`` into its float32
    accumulation without rounding the products to bf16 (a bf16 product
    rounded first moved one ``rs`` by a bf16 unit at n = 30)."""
    return (a.float() * b.float()).sum(dim=(-2, -1), keepdim=True).to(a.dtype)


def cg_pressure_solve(div: torch.Tensor, iters: int = 20) -> torch.Tensor:
    """``iters`` conjugate-gradient iterations on A p = div from p = 0, on
    padded (n+2, n+2) grids (the result's ghost ring by the copy rule).

    A with the copy rule is singular (constants are its null space), so
    the rhs mean is deflated first: pressure is only used through its
    gradient, and without the deflation CG stalls at the inconsistency
    floor of the f32 mean."""
    b = div[..., 1:-1, 1:-1]
    b = b - b.mean(dim=(-2, -1), keepdim=True)
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = _dot(r, r)
    eps = as_scalar(1e-30, div)
    for _ in range(iters):
        Ap = _apply_A_bc(p)
        alpha = rs / (_dot(p, Ap) + eps)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = _dot(r, r)
        beta = rs_new / (rs + eps)
        p = r + beta * p
        rs = rs_new
    return embed_copy(x)


def cg_residual_norm(p: torch.Tensor, div: torch.Tensor) -> torch.Tensor:
    """max |div - A p| over the interior of every grid (a 0-dim
    tensor)."""
    return (div[..., 1:-1, 1:-1]
            - _apply_A_bc(p[..., 1:-1, 1:-1])).abs().max()
