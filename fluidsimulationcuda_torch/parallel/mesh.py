"""Device meshes for the multi-device step (PyTorch twin of
``fluidsimulationcuda_tpu.parallel.mesh``).

A ``Mesh`` is a 2-D grid of ``torch.device``s with axes ("x", "y"), held
by one process: the steps (``parallel/sharded.py``, ``sharded3d.py``) and
the slab solvers (``parallel/solvers.py``) drive every device from it and
move halo rows between devices with ``.to`` (``_halos``, ``_ext``), or
assemble a whole field on each device for the exact gathers (``_gather``).  A
mesh may list one device more than once.  That is the port's counterpart
of the JAX tests' virtual 8-device CPU mesh, and how one card runs a 4- or
8-slab mesh with interior and wall slabs both present.
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


def _halos(xs, k: int):
    """(top, bottom) halos of each slab of ``xs``: the ``k`` leading-axis
    entries (rows, or planes of a z-slab) of the neighbouring slabs next to
    it, moved to its device, zeros beyond a wall.  A halo must come from
    the adjacent slab: deeper than a slab raises (JAX's ``x[-K:]`` would
    silently take fewer)."""
    out = []
    for i, x in enumerate(xs):
        if k > x.shape[0]:
            raise ValueError(f"a {k}-deep halo is deeper than the "
                             f"{x.shape[0]}-deep slab")
        zeros = (k, *x.shape[1:])
        top = xs[i - 1][-k:].to(x.device) if i > 0 else x.new_zeros(zeros)
        bot = (xs[i + 1][:k].to(x.device) if i < len(xs) - 1
               else x.new_zeros(zeros))
        out.append((top, bot))
    return out


def _ext(xs, k: int):
    """Each slab extended by its ``k``-deep halos on both sides."""
    return [torch.cat([top, x, bot])
            for x, (top, bot) in zip(xs, _halos(xs, k))]


def _gather(xs):
    """JAX's ``_gather_global`` for the slabs ``xs``: the whole field
    (slabs stacked along the leading axis) assembled once on each distinct
    device of the slabs, every slab on that device reading the same tensor.
    One copy per slab would hold a mesh's slab count of whole fields on
    one card where it lists its device once per slab."""
    full: dict[torch.device, torch.Tensor] = {}
    for x in xs:
        if x.device not in full:
            full[x.device] = torch.cat([s.to(x.device) for s in xs])
    return [full[x.device] for x in xs]
