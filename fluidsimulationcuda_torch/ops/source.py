"""External source injection: ``x += dt * s`` over the full padded grid
(``FluidSequential.c:78-82``).  The CUDA path folds it into the first
Jacobi sweep of a solve; this is its plain form."""
from __future__ import annotations

import torch

from .diffuse import as_scalar

__all__ = ["add_source"]


def add_source(x: torch.Tensor, s: torch.Tensor, dt: float) -> torch.Tensor:
    # dt rounded to the fields' dtype before the multiply, as
    # ``jnp.asarray(dt, x.dtype)`` is in the JAX package (torch would
    # multiply a bf16 tensor by a python scalar in float32).
    return x + as_scalar(dt, x) * s
