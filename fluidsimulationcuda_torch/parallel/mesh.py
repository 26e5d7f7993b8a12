"""Device meshes for the multi-device step (PyTorch twin of
``fluidsimulationcuda_tpu.parallel.mesh``).

A ``Mesh`` is a 2-D grid of ``torch.device``s with axes ("x", "y"), held
by one process: the step (``parallel/sharded.py``) drives every device from
it and moves halo rows between devices with ``.to``.  A mesh may list one
device more than once.  That is the port's counterpart of the JAX tests'
virtual 8-device CPU mesh, and how one card runs a 4- or 8-slab mesh with
interior and wall slabs both present.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["Mesh", "make_mesh", "SPATIAL_AXES"]

SPATIAL_AXES = ("x", "y")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[i][j]`` is the device of mesh position (x=i, y=j)."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        """``{"x": px, "y": py}``, as ``jax.sharding.Mesh.shape``."""
        return {"x": len(self.devices), "y": len(self.devices[0])}

    @property
    def device_list(self) -> list[torch.device]:
        """The devices in row-major order."""
        return [d for row in self.devices for d in row]

    def reshape(self, px: int, py: int) -> "Mesh":
        """The same devices, row-major, as a (px, py) mesh."""
        return _mesh(self.device_list, px, py)


def _mesh(devices: list[torch.device], px: int, py: int) -> Mesh:
    if px * py != len(devices):
        raise ValueError(f"mesh shape {(px, py)} != {len(devices)} devices")
    return Mesh(tuple(tuple(devices[i * py:(i + 1) * py]) for i in range(px)))


def _normalise(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices=None, shape: tuple[int, int] | None = None) -> Mesh:
    """A 2-D ("x", "y") mesh over ``devices``: every CUDA device by
    default, and an error where there is none (nothing falls back to the
    CPU; a CPU mesh lists ``torch.device("cpu")`` as often as it has
    slabs).  ``shape`` defaults to the (n, 1) row mesh of full-width slabs,
    the only layout the port's step runs (it row-flattens a 2-D mesh).
    """
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices explicitly (a "
                "device may repeat, e.g. [torch.device('cpu')] * 4)")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [_normalise(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh needs at least one device")
    return _mesh(devices, *(shape or (len(devices), 1)))
