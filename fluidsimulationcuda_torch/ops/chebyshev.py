"""Chebyshev semi-iterative acceleration of the Jacobi solves (plain torch;
twin of ``fluidsimulationcuda_tpu.ops.chebyshev``, 2-D and 3-D).

The same Jacobi sweep ``S`` as parity mode, combined by the three-term
recurrence (Golub & Van Loan §11.2.8):

    x_1     = S(x_0)
    x_{k+1} = w_{k+1} * S(x_k) + (1 - w_{k+1}) * x_{k-1}
    w_{k+1} = 1 / (1 - rho^2 * w_k / 4),   w_1 = 2

Not a parity mode; it is the compensated perf mode's solver, and the plain
form of the Chebyshev flag of the CUDA ``jacobi_sweep`` and
``jacobi3_sweep`` kernels.
"""
from __future__ import annotations

import torch

from .boundary import embed_interior
from .diffuse import as_scalar, jacobi_sweep
from .three_d import embed_faces3, embed_interior3, jacobi_sweep3

__all__ = ["cheby_omegas", "cheby_diffuse", "cheby_pressure_solve",
           "cheby_diffuse3", "cheby_pressure_solve3"]


def cheby_omegas(rho: float, iters: int) -> tuple[float, ...]:
    """The w_2..w_iters schedule (w for sweep k applies to x_k -> x_{k+1}),
    run in float64 and returned as plain floats.  The CUDA wrapper passes
    them to the kernel one per launch, rounded to float32."""
    ws = []
    w = 2.0
    for _ in range(1, iters):
        w = 1.0 / (1.0 - 0.25 * rho * rho * w)
        ws.append(w)
    return tuple(ws)


def cheby_diffuse(b: int, x_init: torch.Tensor, x0: torch.Tensor,
                  alpha: float, beta: float, iters: int,
                  rho: float) -> torch.Tensor:
    """``iters`` Chebyshev-accelerated Jacobi sweeps (the perf-mode twin of
    ``ops.diffuse.diffuse``; guess ``x_init``, rhs ``x0``; one grid or a
    batch of them)."""
    a = as_scalar(alpha, x0)
    bt = as_scalar(beta, x0)
    rhs_int = x0[..., 1:-1, 1:-1]
    xm = x_init
    x = jacobi_sweep(b, xm, rhs_int, a, bt)
    for w in cheby_omegas(rho, iters):
        wc = as_scalar(w, x0)
        xn = wc * jacobi_sweep(b, x, rhs_int, a, bt) + (1.0 - wc) * xm
        # Re-derive the ghost ring from the combined interior: the affine
        # combination would otherwise leak x_{k-1}'s ghosts (for k=2 the raw
        # guess border) into the ring the next sweep reads.
        xm, x = x, embed_interior(b, xn[..., 1:-1, 1:-1])
    return x


def cheby_pressure_solve(div: torch.Tensor, iters: int,
                         rho: float) -> torch.Tensor:
    """Chebyshev Poisson solve from the zero guess (perf-mode twin of
    ``ops.project.pressure_solve``)."""
    return cheby_diffuse(0, torch.zeros_like(div), div, 1.0, 4.0, iters, rho)


def cheby_diffuse3(b: int, x_init: torch.Tensor, x0: torch.Tensor,
                   alpha: float, beta: float, iters: int,
                   rho: float) -> torch.Tensor:
    """3-D twin of :func:`cheby_diffuse` (7-point sweep, semantics of
    ``ops.three_d.diffuse3``): the ghost faces are re-derived from the
    combined interior after every iterate, the full ghost layer once at the
    end."""
    a = as_scalar(alpha, x0)
    bt = as_scalar(beta, x0)
    rhs = x0[1:-1, 1:-1, 1:-1]
    xm = x_init
    x = jacobi_sweep3(b, xm, rhs, a, bt)
    for w in cheby_omegas(rho, iters):
        wc = as_scalar(w, x0)
        xn = wc * jacobi_sweep3(b, x, rhs, a, bt) + (1.0 - wc) * xm
        xm, x = x, embed_faces3(b, xn[1:-1, 1:-1, 1:-1])
    return embed_interior3(b, x[1:-1, 1:-1, 1:-1])


def cheby_pressure_solve3(div: torch.Tensor, iters: int,
                          rho: float) -> torch.Tensor:
    """3-D Chebyshev Poisson solve from the zero guess (perf-mode twin of
    ``ops.three_d.pressure_solve3``)."""
    return cheby_diffuse3(0, torch.zeros_like(div), div, 1.0, 6.0, iters, rho)
