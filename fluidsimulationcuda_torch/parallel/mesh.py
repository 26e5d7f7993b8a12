"""Device meshes for the multi-device step (PyTorch twin of
``fluidsimulationcuda_tpu.parallel.mesh``).

A ``Mesh`` is a 2-D grid of ``torch.device``s with axes ("x", "y"), held
by one process: the steps (``parallel/sharded.py``, ``sharded3d.py``) and
the solvers (``parallel/solvers.py``) drive every device from it and move
halos between devices with ``.to``.  A field is cut either into row slabs
(the slab route: ``_halos``, ``_ext``, ``_gather``) or into the (px, py)
blocks of a 2-D mesh (the block route: ``Blocks``, whose halos come in
JAX's two phases, rows first, then the columns of the row-extended block,
which carry the corners).  A mesh may list one device more than once.
That is the port's counterpart of the JAX tests' virtual 8-device CPU
mesh, and how one card runs a 4- or 8-part mesh with interior and wall
parts both present.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["Mesh", "make_mesh", "SPATIAL_AXES", "Blocks"]

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


def _factor_2d(n: int) -> tuple[int, int]:
    """Near-square factorization of a device count (JAX's)."""
    px = math.isqrt(n)
    while n % px:
        px -= 1
    return px, n // px


def make_mesh(devices=None, shape: tuple[int, int] | None = None, *,
              layout: str = "rows") -> Mesh:
    """A 2-D ("x", "y") mesh over ``devices``: every CUDA device by
    default, and an error where there is none (nothing falls back to the
    CPU; a CPU mesh lists ``torch.device("cpu")`` as often as it has
    parts).  Without ``shape``, ``layout`` picks it: ``"rows"`` (the
    default), the (n, 1) row mesh of full-width slabs, which the slab
    route runs; ``"square"``, JAX's near-square factorization, whose
    blocks the block route runs (the slab route row-flattens it where the
    grid allows).
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
    if shape is None:
        if layout == "rows":
            shape = (len(devices), 1)
        elif layout == "square":
            shape = _factor_2d(len(devices))
        else:
            raise ValueError(f"unknown layout {layout!r}")
    return _mesh(devices, *shape)


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


@dataclasses.dataclass(frozen=True)
class Blocks:
    """The (px, py) blocks of a (side, side) field: block ``i`` (row-major
    in the mesh) holds rows ``[r0, r0 + m)`` and columns ``[c0, c0 + k)``,
    ``(r0, c0) = origins[i]``, ``m = side/px``, ``k = side/py``.  A (px, 1)
    mesh's blocks are its row slabs."""

    px: int
    py: int
    side: int

    @property
    def m(self) -> int:
        return self.side // self.px

    @property
    def k(self) -> int:
        return self.side // self.py

    @property
    def origins(self) -> list[tuple[int, int]]:
        return [(i * self.m, j * self.k) for i in range(self.px)
                for j in range(self.py)]

    def _at(self, i: int, j: int) -> int | None:
        """The index of mesh block (i, j); None outside the mesh."""
        if 0 <= i < self.px and 0 <= j < self.py:
            return i * self.py + j
        return None

    def neighbours(self, b: int) -> tuple:
        """(above, below, left, right): the indices of block ``b``'s mesh
        neighbours, None beyond a wall."""
        i, j = divmod(b, self.py)
        return (self._at(i - 1, j), self._at(i + 1, j), self._at(i, j - 1),
                self._at(i, j + 1))

    def halos(self, xs) -> list[tuple]:
        """JAX's ``_neighbor_halos``: each block's one-deep (top, bottom,
        left, right) halos, the neighbours' edge rows ((1, k)) and columns
        ((m,), contiguous), moved to its device; None beyond a wall, where
        no cell the stencils keep reads them."""
        out = []
        for b, x in enumerate(xs):
            up, dn, lt, rt = self.neighbours(b)

            def take(nb, part):
                return None if nb is None else part(xs[nb]).to(x.device)

            out.append((take(up, lambda y: y[-1:]), take(dn, lambda y: y[:1]),
                        take(lt, lambda y: y[:, -1].contiguous()),
                        take(rt, lambda y: y[:, 0].contiguous())))
        return out

    def ext(self, xs, K: int) -> list[torch.Tensor]:
        """JAX's ``_extend_deep``: each (m, k) block extended to (m + 2K,
        k + 2K) by the two-phase exchange, rows first, then the columns of
        the row-extended blocks (which carry the corner blocks); zeros
        beyond a wall.  A halo deeper than a block raises (JAX's ``x[-K:]``
        would silently take fewer)."""
        if K > self.m or K > self.k:
            raise ValueError(f"a {K}-deep halo is deeper than the "
                             f"{self.m} x {self.k} blocks")
        rows = []
        for b, x in enumerate(xs):
            up, dn, _, _ = self.neighbours(b)
            zeros = x.new_zeros((K, self.k))
            top = xs[up][-K:].to(x.device) if up is not None else zeros
            bot = xs[dn][:K].to(x.device) if dn is not None else zeros
            rows.append(torch.cat([top, x, bot]))
        out = []
        for b, r in enumerate(rows):
            _, _, lt, rt = self.neighbours(b)
            zeros = r.new_zeros((self.m + 2 * K, K))
            left = rows[lt][:, -K:].to(r.device) if lt is not None else zeros
            right = rows[rt][:, :K].to(r.device) if rt is not None else zeros
            out.append(torch.cat([left, r, right], dim=1))
        return out

    def stitch(self, xs, device=None) -> torch.Tensor:
        """The whole (side, side) field from its blocks, on ``device`` (the
        first block's by default)."""
        device = xs[0].device if device is None else device
        return torch.cat([torch.cat([xs[self._at(i, j)].to(device)
                                     for j in range(self.py)], dim=1)
                          for i in range(self.px)])

    def gather(self, xs) -> list[torch.Tensor]:
        """JAX's ``_gather_global`` for the blocks ``xs``: the whole field
        assembled once on each distinct device of the blocks, every block
        on that device reading the same tensor (as ``_gather`` for
        slabs)."""
        full: dict[torch.device, torch.Tensor] = {}
        for x in xs:
            if x.device not in full:
                full[x.device] = self.stitch(xs, x.device)
        return [full[x.device] for x in xs]

    def cut(self, full: torch.Tensor, devices=None) -> tuple:
        """The blocks of the (side, side) field ``full``, block ``i`` a copy
        on ``devices[i]`` (``full``'s device by default)."""
        out = []
        for b, (r0, c0) in enumerate(self.origins):
            dev = full.device if devices is None else devices[b]
            out.append(full[r0:r0 + self.m, c0:c0 + self.k].to(
                dev, copy=True).contiguous())
        return tuple(out)
