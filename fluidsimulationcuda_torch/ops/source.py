"""External source injection: ``x += dt * s`` over the full padded grid
(``FluidSequential.c:78-82``).  The CUDA path folds it into the first
Jacobi sweep of a solve; this is its plain form."""
from __future__ import annotations

import torch

__all__ = ["add_source"]


def add_source(x: torch.Tensor, s: torch.Tensor, dt: float) -> torch.Tensor:
    # A python scalar is cast to the tensor's float32 before the multiply,
    # as ``jnp.asarray(dt, x.dtype)`` is in the JAX package.
    return x + dt * s
