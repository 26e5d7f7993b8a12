"""3-D Stable Fluids operators (plain torch; twin of
``fluidsimulationcuda_tpu.ops.three_d``).

The smoke-volume generalization of the 2-D solver (BASELINE config 5):

- grid ``(n+2)^3``, ghost cells on all six faces, index order [z, y, x];
- boundary modes b: 0 copy, 1 flip at the x walls (u), 2 flip at the y
  walls (v), 3 flip at the z walls (w);
- the ghost layer is derived from the interior: faces mirror the adjacent
  interior cell (sign per mode), edges average their two adjacent face
  cells, corners average their three adjacent edge cells (``fix_edges3``);
  the 7-point stencil never reads edges or corners, the advection gather
  does;
- diffusion ``alpha = dt*k*n^2``, ``beta = 1 + 6*alpha``; pressure
  alpha=1, beta=6;
- advection: backtrace clamped to ``[0.5, n+0.5]`` per axis, trilinear
  gather, exact at any displacement (``advect3``); ``advect3_windowed``
  also clamps to ``cmax`` cells around the cell, as every z-slab gather of
  the multi-device step does (``kernels/cuda_sharded_3d.py``).  All three
  share ``departure3`` and ``trilinear``.

Each function keeps the JAX package's expression order, so both round
alike.  These are the ``reference`` backend's 3-D ops and the plain forms
of the CUDA kernels in ``kernels/cuda_ops_3d.py``.

On bf16 fields (JAX's bf16 storage mode) every op but the gathers rounds
each operation to bf16 as JAX's jnp ops do: the constants (``1/3``, ``h``,
``-0.5*h``) are taken in the fields' dtype first, ``jnp.asarray(c,
dtype)``.  The gathers keep float32 coordinates and blend: bf16 cannot
resolve a fraction of a cell at these sides (JAX's own ``advect3`` blends
in bf16 and lies rel-L2 0.35 from its float32 gather on a random field at
n = 126), so bf16 fields and velocities are widened, the gather and its
ghost layer computed in float32 and the result rounded once, as K6's bf16
form stores it.
"""
from __future__ import annotations

import numpy as np
import torch

from .diffuse import as_scalar
from .project import _h

__all__ = [
    "embed_faces3", "embed_interior3", "set_bnd3", "fix_faces3",
    "fix_edges3", "jacobi_sweep3", "diffuse3", "departure3", "backtrace3",
    "trilinear", "advect3", "advect3_windowed", "divergence3",
    "pressure_solve3", "apply_pressure_gradient3", "project3",
]

_AXIS_OF_MODE = {1: 2, 2: 1, 3: 0}  # boundary mode -> flipped axis (z, y, x)
# 1/3 rounded to float32, as ``jnp.asarray(1.0 / 3.0, float32)`` rounds it.
_THIRD = float(np.float32(1.0 / 3.0))


def _fix_faces3_(b: int, x: torch.Tensor) -> torch.Tensor:
    """Set the six ghost faces of ``x`` in place from the adjacent interior
    planes, axis by axis as the JAX ``fix_faces3`` does."""
    for axis in range(3):
        sign = -1.0 if _AXIS_OF_MODE.get(b) == axis else 1.0
        for ghost, inner in ((0, 1), (-1, -2)):
            dst = [slice(None)] * 3
            src = [slice(None)] * 3
            dst[axis], src[axis] = ghost, inner
            x[tuple(dst)] = sign * x[tuple(src)]
    return x


def _fix_edges3_(x: torch.Tensor) -> torch.Tensor:
    """Derive the ghost edges (mean of the two adjacent face cells) and then
    the corners (mean of the three adjacent edge cells) in place; 1/3 is
    rounded to ``x``'s dtype, as ``jnp.asarray(1.0 / 3.0, dtype)``."""
    n2 = x.shape[0]
    third = as_scalar(1.0 / 3.0, x)
    for a1 in range(3):
        for a2 in range(a1 + 1, 3):
            for i1 in (0, n2 - 1):
                for i2 in (0, n2 - 1):
                    idx = [slice(1, -1)] * 3
                    idx[a1], idx[a2] = i1, i2
                    nb1 = list(idx)
                    nb1[a1] = 1 if i1 == 0 else n2 - 2
                    nb2 = list(idx)
                    nb2[a2] = 1 if i2 == 0 else n2 - 2
                    x[tuple(idx)] = 0.5 * (x[tuple(nb1)] + x[tuple(nb2)])
    for iz in (0, n2 - 1):
        for iy in (0, n2 - 1):
            for ix in (0, n2 - 1):
                nz = 1 if iz == 0 else n2 - 2
                ny = 1 if iy == 0 else n2 - 2
                nx = 1 if ix == 0 else n2 - 2
                x[iz, iy, ix] = third * ((x[nz, iy, ix] + x[iz, ny, ix])
                                         + x[iz, iy, nx])
    return x


def _pad(interior: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(interior, (1, 1, 1, 1, 1, 1))


def fix_faces3(b: int, x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` with only its six ghost faces re-derived."""
    return _fix_faces3_(b, x.clone())


def fix_edges3(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` with its ghost edges and corners derived from its
    faces."""
    return _fix_edges3_(x.clone())


def embed_faces3(b: int, interior: torch.Tensor) -> torch.Tensor:
    """(n, n, n) interior -> padded volume with only the ghost faces set
    (enough for the 7-point stencil)."""
    return _fix_faces3_(b, _pad(interior))


def embed_interior3(b: int, interior: torch.Tensor) -> torch.Tensor:
    """(n, n, n) interior -> (n+2)^3 volume with the full ghost layer."""
    return _fix_edges3_(_fix_faces3_(b, _pad(interior)))


def set_bnd3(b: int, x: torch.Tensor) -> torch.Tensor:
    """Re-derive the full ghost layer of a padded volume from its
    interior."""
    return _fix_edges3_(_fix_faces3_(b, x.clone()))


def _neigh3(x: torch.Tensor) -> torch.Tensor:
    """The 6-neighbour sum of every interior cell, in the order
    ``((L+R)+(U+D))+(F+B)`` of the JAX ``diffuse3``."""
    return (((x[1:-1, 1:-1, :-2] + x[1:-1, 1:-1, 2:])
             + (x[1:-1, :-2, 1:-1] + x[1:-1, 2:, 1:-1]))
            + (x[:-2, 1:-1, 1:-1] + x[2:, 1:-1, 1:-1]))


def jacobi_sweep3(b: int, x: torch.Tensor, rhs_int: torch.Tensor, alpha,
                  beta) -> torch.Tensor:
    """One 7-point Jacobi sweep ``(rhs + alpha*neigh)/beta`` on the
    interior, ghost faces re-derived (edges and corners are not stencil
    inputs).  ``alpha`` and ``beta`` are floats or 0-dim tensors."""
    return embed_faces3(b, (rhs_int + alpha * _neigh3(x)) / beta)


def diffuse3(b: int, x_init: torch.Tensor, x0: torch.Tensor, alpha: float,
             beta: float, iters: int) -> torch.Tensor:
    """``iters`` Jacobi sweeps from guess ``x_init`` (read as it is, ghost
    faces included, by the first sweep) with rhs ``x0``; the full ghost
    layer is derived at the end."""
    a = as_scalar(alpha, x0)
    bt = as_scalar(beta, x0)
    rhs = x0[1:-1, 1:-1, 1:-1]
    x = x_init
    for _ in range(iters):
        x = jacobi_sweep3(b, x, rhs, a, bt)
    return embed_interior3(b, x[1:-1, 1:-1, 1:-1])


def departure3(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               xs: torch.Tensor, ys: torch.Tensor, zs: torch.Tensor,
               dt: float, n: int, cmax: int | None = None):
    """Departure points (x, y, z) in grid units of the cells at global
    padded coordinates ``(xs, ys, zs)`` (broadcast against their velocities
    ``u``, ``v``, ``w``): ``g - dt0*vel`` per axis, clamped to
    ``[0.5, n+0.5]`` and then, with ``cmax``, to ``[g - cmax, g + cmax]``
    around the cell's own coordinate ``g``, in that order.  ``dt0 = dt*n``
    is taken in float32, as the JAX package takes it, and so is every
    coordinate: bf16 velocities are widened first."""
    dt0 = float(np.float32(dt) * np.float32(n))
    out = []
    for g, vel in ((xs, u), (ys, v), (zs, w)):
        c = (g - dt0 * vel.float()).clamp(0.5, n + 0.5)
        if cmax is not None:
            c = torch.clamp(c, g - cmax, g + cmax)
        out.append(c)
    return tuple(out)


def backtrace3(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, dt: float,
               n: int, cmax: int | None = None):
    """``departure3`` of every interior cell of the padded volume, float32
    arrays of shape (n, n, n)."""
    idx = torch.arange(1, n + 1, dtype=torch.float32, device=u.device)
    return departure3(u[1:-1, 1:-1, 1:-1], v[1:-1, 1:-1, 1:-1],
                      w[1:-1, 1:-1, 1:-1], idx[None, None, :],
                      idx[None, :, None], idx[:, None, None], dt, n, cmax)


def trilinear(d0: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
              z: torch.Tensor, z_offset: int = 0) -> torch.Tensor:
    """Trilinear gather of ``d0`` at departure points (x, y, z), truncated
    to the lower corner (the clamp makes trunc == floor) and blended in the
    JAX ``advect3`` order; global plane ``k`` is plane ``k - z_offset`` of
    ``d0``.  The blend runs in float32 whatever ``d0`` stores (a bf16
    ``d0`` is widened)."""
    i0, j0, k0 = (t.to(torch.int32) for t in (x, y, z))
    fx = x - i0.to(torch.float32)
    fy = y - j0.to(torch.float32)
    fz = z - k0.to(torch.float32)

    side = d0.shape[-1]
    flat = d0.float().reshape(-1)
    base = (((k0 - z_offset) * side + j0) * side + i0).to(torch.int64)

    def g(dz, dy, dx):
        return flat[base + ((dz * side + dy) * side + dx)]

    return (
        (1.0 - fz) * (
            (1.0 - fy) * ((1.0 - fx) * g(0, 0, 0) + fx * g(0, 0, 1))
            + fy * ((1.0 - fx) * g(0, 1, 0) + fx * g(0, 1, 1))
        )
        + fz * (
            (1.0 - fy) * ((1.0 - fx) * g(1, 0, 0) + fx * g(1, 0, 1))
            + fy * ((1.0 - fx) * g(1, 1, 0) + fx * g(1, 1, 1))
        )
    )


def _gathered(b: int, d0: torch.Tensor, interior: torch.Tensor
              ) -> torch.Tensor:
    """A gather's float32 interior with its ghost layer, in ``d0``'s dtype:
    a bf16 result is rounded once, after the float32 ghost layer."""
    return embed_interior3(b, interior).to(d0.dtype)


def advect3(b: int, d0: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, dt: float, n: int) -> torch.Tensor:
    """Semi-Lagrangian advection: backtrace by ``dt*n*(u, v, w)`` taken in
    float32, clamp to ``[0.5, n+0.5]``, trilinear gather."""
    return _gathered(b, d0, trilinear(d0, *backtrace3(u, v, w, dt, n)))


def advect3_windowed(b: int, d0: torch.Tensor, u: torch.Tensor,
                     v: torch.Tensor, w: torch.Tensor, dt: float, n: int,
                     cmax: int = 2) -> torch.Tensor:
    """Window-clamped trilinear advection (``ops/three_d.py:212-280`` of
    the JAX package; ``departure3`` with ``cmax``).  It equals ``advect3``
    while the displacement ``dt*n*|velocity|`` stays at or below ``cmax``
    on every axis, and is clamped, not refused, above it.  The JAX package
    sums (2*cmax+1)³ masked shifts; after the window clamp every departure
    point lies inside the window, so a direct gather reads the same eight
    values."""
    return _gathered(b, d0, trilinear(d0, *backtrace3(u, v, w, dt, n,
                                                      cmax)))


def divergence3(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                n: int) -> torch.Tensor:
    """``div = (-0.5*h)*((du + dv) + dw)``, ``h = 1/n`` taken in the
    fields' dtype (``_h``); boundary mode 0."""
    coef = as_scalar(-0.5, u) * _h(n, u)  # exact: a power-of-two scaling
    d = coef * ((u[1:-1, 1:-1, 2:] - u[1:-1, 1:-1, :-2])
                + (v[1:-1, 2:, 1:-1] - v[1:-1, :-2, 1:-1])
                + (w[2:, 1:-1, 1:-1] - w[:-2, 1:-1, 1:-1]))
    return embed_interior3(0, d)


def pressure_solve3(div: torch.Tensor, iters: int) -> torch.Tensor:
    """Jacobi Poisson solve from the zero guess (alpha=1, beta=6)."""
    return diffuse3(0, torch.zeros_like(div), div, 1.0, 6.0, iters)


def apply_pressure_gradient3(u: torch.Tensor, v: torch.Tensor,
                             w: torch.Tensor, p: torch.Tensor, n: int):
    """``u -= 0.5*(pR-pL)/h`` and likewise for v and w, dividing by
    ``h = 1/n`` taken in u's dtype (``_h``); boundary modes 1, 2 and 3.
    Written in u's dtype: a float32 pressure against bf16 u, v, w is
    computed in float32 and rounded once."""
    h = _h(n, u)
    un = u[1:-1, 1:-1, 1:-1] - (0.5 * (p[1:-1, 1:-1, 2:] - p[1:-1, 1:-1, :-2])) / h
    vn = v[1:-1, 1:-1, 1:-1] - (0.5 * (p[1:-1, 2:, 1:-1] - p[1:-1, :-2, 1:-1])) / h
    wn = w[1:-1, 1:-1, 1:-1] - (0.5 * (p[2:, 1:-1, 1:-1] - p[:-2, 1:-1, 1:-1])) / h
    return tuple(embed_interior3(b, f.to(u.dtype))
                 for b, f in ((1, un), (2, vn), (3, wn)))


def project3(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, n: int,
             iters: int):
    div = divergence3(u, v, w, n)
    p = pressure_solve3(div, iters)
    return apply_pressure_gradient3(u, v, w, p, n)
