"""Simulation state (PyTorch twin of ``fluidsimulationcuda_tpu.core.state``).

``FluidState`` holds the fields carried across steps, ``Sources`` the
per-step inputs integrated as ``x += dt * src`` (``FluidSequential.c:78-82``).
Both are NamedTuples of tensors of shape ``cfg.grid_shape``, indexed
``[i, j] = [row, col]`` like the reference's ``x[j + i*(N+2)]`` layout in
2-D and ``[z, y, x]`` in 3-D, where ``w`` carries the depth velocity.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import SimConfig

__all__ = [
    "FluidState", "Sources", "zero_state", "zero_sources", "zero_sources_like",
    "reference_init", "state_from_numpy", "state_to_numpy",
]


class FluidState(NamedTuple):
    """Fields carried across timesteps: ``u`` is the x (column) velocity,
    ``v`` the y (row) velocity, ``w`` the z (depth) velocity in 3-D and
    None in 2-D."""

    dens: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor | None = None


class Sources(NamedTuple):
    """Per-step external sources; shapes match the state fields."""

    dens: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor | None = None


def _zeros(cfg: SimConfig) -> torch.Tensor:
    return torch.zeros(cfg.grid_shape, dtype=cfg.dtype, device=cfg.device)


def _w(cfg: SimConfig) -> torch.Tensor | None:
    return _zeros(cfg) if cfg.ndim == 3 else None


def zero_state(cfg: SimConfig) -> FluidState:
    return FluidState(dens=_zeros(cfg), u=_zeros(cfg), v=_zeros(cfg),
                      w=_w(cfg))


def zero_sources(cfg: SimConfig) -> Sources:
    return Sources(dens=_zeros(cfg), u=_zeros(cfg), v=_zeros(cfg), w=_w(cfg))


def zero_sources_like(fields) -> Sources:
    """Zero sources shaped like ``fields`` (a state or sources, one grid or
    a batch of them), on their device."""
    return Sources(*(None if t is None else torch.zeros_like(t)
                     for t in fields))


def reference_init(generator: torch.Generator,
                   cfg: SimConfig) -> tuple[FluidState, Sources]:
    """Initial condition mirroring ``initializeParameters``
    (``FluidSequential.c:244-271``), with the distributions of the JAX
    package's ``reference_init``: density source uniform in [0, 0.099]
    inside a centred square (a cube in 3-D) of half-width ``(n+2)//8``,
    zero elsewhere; velocity sources (``w`` too in 3-D) uniform in
    [0, 0.99] everywhere; carried fields zero.  Sources are meant for
    step 1 only.

    The numbers come from ``generator`` (drawn on its device, then moved to
    ``cfg.device``), so they differ from the JAX package's bits; tests that
    compare the two packages feed both the same numpy arrays instead."""
    side = cfg.n + 2

    def uniform(lo: float, hi: float) -> torch.Tensor:
        r = torch.rand(cfg.grid_shape, generator=generator, dtype=cfg.dtype,
                       device=generator.device)
        return (lo + (hi - lo) * r).to(cfg.device)

    dens_src = uniform(0.0, 0.099)
    u_src = uniform(0.0, 0.99)
    v_src = uniform(0.0, 0.99)
    w_src = uniform(0.0, 0.99) if cfg.ndim == 3 else None
    center, radius = side // 2, side // 8
    band = slice(center - radius, center + radius)
    mask = torch.zeros(cfg.grid_shape, dtype=torch.bool, device=cfg.device)
    mask[(band,) * cfg.ndim] = True
    dens_src = torch.where(mask, dens_src, torch.zeros_like(dens_src))
    return zero_state(cfg), Sources(dens=dens_src, u=u_src, v=v_src,
                                    w=w_src)


def _field(obj, name: str):
    if hasattr(obj, name):
        return getattr(obj, name)
    if name == "w" and name not in obj:
        return None  # a 2-D npz file or dict has no w
    return obj[name]


def state_from_numpy(obj, device: torch.device | str = "cuda",
                     dtype: torch.dtype = torch.float32) -> FluidState:
    """A ``FluidState`` of ``dtype`` tensors (float32 unless the caller asks
    for ``torch.bfloat16``) on ``device`` (the card unless the caller asks
    for ``"cpu"``) from any object whose ``dens``/``u``/``v`` and, in 3-D,
    ``w`` (attributes or keys) convert through ``np.asarray``: a JAX
    ``FluidState`` (bf16 arrays included), an npz file, a dict.  Each field
    goes through float32, where a bf16 value is exact, and is rounded to
    nearest even from there, as ``astype(jnp.bfloat16)`` rounds the same
    float32 array.  Shapes carry over as they are, a batch of grids ``(B,
    side, side)`` included."""
    def conv(name):
        a = _field(obj, name)
        if a is None:
            return None
        a = np.asarray(a, dtype=np.float32)
        return torch.from_numpy(a.copy()).to(device=device, dtype=dtype)

    return FluidState(*map(conv, FluidState._fields))


def state_to_numpy(state: FluidState) -> FluidState:
    """The same state with each field as a float32 numpy array (``w`` stays
    None in 2-D; a bf16 field widens exactly), ready for ``np.savez`` or the
    JAX package's ``FluidState``."""
    return FluidState(*(None if t is None else t.detach().float().cpu().numpy()
                        for t in state))
