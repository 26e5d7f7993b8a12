"""The fused velocity tail (twin of
``fluidsimulationcuda_tpu.kernels.pallas_step``).

``fused_advect_project`` is the tail of ``vel_step``
(``FluidSequential.c:232-240``) in one CUDA launch, K17
(``csrc/advect_project.cu``), which replaces the TPU kernel ``_ap_call``
(``pallas_step.py:299``): the u/v self-advection pair under the gather
window of ``cmax`` cells, both fields backtraced from the pre-advection
velocity, then the second projection (divergence, ``iters`` pressure sweeps
from zero, Jacobi or Chebyshev, and the gradient).  As in the JAX package
it is no OpSet hook and no step calls it: it is a tested capability.

On CPU tensors the wrapper returns its plain version, ``advect_windowed``
on the pair followed by ``cuda_ops.fused_project_plain``; on CUDA tensors it
launches K17 or raises.  Its launches count in
``cuda_ops.launch_counts()``.  The TPU kernel's VMEM strip plan
(``_ap_plan``) and its Mosaic gates (``side % tm``, ``side // tm >= 4``,
``cmax <= 3``) are left out: ``advect_project_supported`` says what K17
takes.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.advect import advect_windowed
from ..ops.chebyshev import cheby_omegas
from ..ops.project import grid_h
from . import build
from . import cuda_ops as co

__all__ = ["fused_advect_project", "fused_advect_project_plain",
           "advect_project_supported"]

# Sweeps one K17 launch takes: its Chebyshev weights travel in the launch
# parameters (csrc/advect_project.cu kMaxSweeps).
MAX_SWEEPS = 256


def advect_project_supported(side: int, iters: int, cmax: int) -> bool:
    """Whether K17 takes a grid of ``side``, ``iters`` pressure sweeps and a
    gather window of ``cmax`` cells (``>= 1``, as in JAX)."""
    return (side >= 3 and side * side < 2**31 and 1 <= iters <= MAX_SWEEPS
            and cmax >= 1)


def _shape(u: torch.Tensor, side: int) -> tuple[int, ...]:
    """``u``'s shape, checked: one grid or a batch of grids of ``side``,
    below 2**31 cells (the kernel indexes with 32-bit ints)."""
    if u.dim() not in (2, 3) or tuple(u.shape[-2:]) != (side, side):
        raise ValueError(f"expected (side, side) or (nb, side, side) grids "
                         f"of side {side}, got {tuple(u.shape)}")
    if u.numel() >= 2**31:
        raise ValueError(f"{tuple(u.shape)} exceeds the kernel's 32-bit "
                         f"cell index")
    return tuple(u.shape)


def fused_advect_project_plain(u, v, n: int, iters: int, dt: float, *,
                               cmax: int = 1, cheby_rho=None):
    """``advect_windowed`` of the u/v pair by itself, then
    ``fused_project_plain``; a batch grid by grid."""
    if u.dim() == 3:
        pairs = [fused_advect_project_plain(a, b, n, iters, dt, cmax=cmax,
                                            cheby_rho=cheby_rho)
                 for a, b in zip(u, v)]
        return (torch.stack([p[0] for p in pairs]),
                torch.stack([p[1] for p in pairs]))
    ua = advect_windowed(1, u, u, v, dt, n, cmax)
    va = advect_windowed(2, v, u, v, dt, n, cmax)
    return co.fused_project_plain(ua, va, n, iters, cheby_rho=cheby_rho)


def fused_advect_project(u, v, n: int, iters: int, dt: float, *,
                         cmax: int = 1, cheby_rho=None):
    """``project(advect_pair(1, 2, u, v, u, v))`` with the gather window of
    ``cmax`` cells, on float32 ``(side, side)`` or ``(nb, side, side)``
    velocities (``side = n + 2``); ``cheby_rho`` makes the pressure sweeps
    Chebyshev.  One K17 launch; returns fresh (u, v) tensors."""
    side = n + 2
    if not advect_project_supported(side, iters, cmax):
        raise ValueError(f"unsupported side={side} iters={iters} "
                         f"cmax={cmax} (see advect_project_supported)")
    shape = _shape(u, side)
    if not co._on_device((u, shape), (v, shape)):
        return fused_advect_project_plain(u, v, n, iters, dt, cmax=cmax,
                                          cheby_rho=cheby_rho)
    nb = shape[0] if len(shape) == 3 else 1
    cheby = cheby_rho is not None
    ws = cheby_omegas(float(cheby_rho), iters) if cheby else ()
    omegas = (ctypes.c_float * max(len(ws), 1))(*map(co._f32, ws))
    with torch.cuda.device(u.device):
        lib = build.load()
        uo, vo, au, av, rhs, p0, p1 = (torch.empty_like(u) for _ in range(7))
        p2 = torch.empty_like(u) if cheby else None
        h = grid_h(n)
        co._launch("advect_project", lib.fsc_advect_project, u.data_ptr(),
                   v.data_ptr(), uo.data_ptr(), vo.data_ptr(), au.data_ptr(),
                   av.data_ptr(), rhs.data_ptr(), p0.data_ptr(),
                   p1.data_ptr(), co._ptr(p2), side, nb, iters, int(cmax),
                   co._dt0(dt, n), -0.5 * h, h, ctypes.addressof(omegas),
                   int(cheby), co._stream(u))
        return uo, vo
