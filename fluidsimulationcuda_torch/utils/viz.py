"""Visualization helpers (twin of ``fluidsimulationcuda_tpu.utils.viz``).

The reference's only visualization was printf grid dumps
(``printStateGrid``, ``FluidSequential.c:32-52``).  These render density
and velocity fields to PNG with matplotlib's Agg backend (headless), which
is imported at the first call: without matplotlib the call raises its
``ImportError``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["save_density_png", "save_velocity_png"]


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save_density_png(path: str, dens, title: str = "density") -> str:
    plt = _plt()
    arr = _host(dens)
    fig, ax = plt.subplots(figsize=(6, 6), dpi=120)
    im = ax.imshow(arr, origin="upper", cmap="magma")
    ax.set_title(title)
    ax.set_xticks([])
    ax.set_yticks([])
    fig.colorbar(im, ax=ax, fraction=0.046)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def save_velocity_png(path: str, u, v, stride: int = 0,
                      title: str = "velocity") -> str:
    plt = _plt()
    uu, vv = _host(u), _host(v)
    n = uu.shape[0]
    stride = stride or max(1, n // 48)
    speed = np.hypot(uu, vv)
    fig, ax = plt.subplots(figsize=(6, 6), dpi=120)
    im = ax.imshow(speed, origin="upper", cmap="viridis")
    ys, xs = np.mgrid[0:n:stride, 0:n:stride]
    ax.quiver(xs, ys, uu[::stride, ::stride], vv[::stride, ::stride],
              color="white", scale_units="xy", angles="xy", width=0.002)
    ax.set_title(title)
    ax.set_xticks([])
    ax.set_yticks([])
    fig.colorbar(im, ax=ax, fraction=0.046)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path
