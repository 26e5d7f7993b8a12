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

K17 has two forms, chosen at launch: the resident form keeps the pressure
iterate in the SMs' shared memory, one band of rows a block, where the
band fits (a grid of up to about 2048² on an H100 SXM's 132 SMs); the
streaming form keeps the iterates in device memory (the 1024 × 256²
datagen batch, 8192²).  ``form="streaming"`` or ``"resident"`` asks for
one; a resident form that does not fit raises, and never becomes the
streaming form.  ``advect_project_form`` says which form a launch takes,
and ``form_counts()`` counts the launches of each.

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
           "advect_project_supported", "advect_project_form", "FORMS",
           "form_counts", "reset_form_counts"]

# Sweeps one K17 launch takes: its Chebyshev weights travel in the launch
# parameters (csrc/advect_project.cu kMaxSweeps).
MAX_SWEEPS = 256
# K17's forms, by their code in csrc/advect_project.cu (0: the launch's
# choice).
FORMS = ("streaming", "resident")
_FORM_CODES = {None: 0, "streaming": 1, "resident": 2}
_form_launches = dict.fromkeys(FORMS, 0)


def form_counts() -> dict[str, int]:
    """K17 launches of each form since the last reset."""
    return dict(_form_launches)


def reset_form_counts() -> None:
    for name in _form_launches:
        _form_launches[name] = 0


def _form(lib, side: int, nb: int, form: str | None) -> tuple[str, int]:
    """(the form a K17 launch on ``nb`` grids of ``side`` takes, the floats
    of the resident form's edge buffer) on the current device."""
    if form not in _FORM_CODES:
        raise ValueError(f"form must be one of {FORMS} or None, got {form!r}")
    code, edges = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.fsc_advect_project_form(side, nb, _FORM_CODES[form],
                                      ctypes.byref(code),
                                      ctypes.byref(edges))
    if err != 0:
        raise RuntimeError(f"K17's {form or 'chosen'} form cannot take "
                           f"{nb} grid(s) of side {side} on this device: "
                           f"cudaError_t {err}")
    return FORMS[code.value - 1], edges.value


def advect_project_form(side: int, nb: int = 1,
                        form: str | None = None) -> str:
    """The form (``"streaming"`` or ``"resident"``) of a K17 launch on
    ``nb`` grids of ``side`` on the current CUDA device; ``form`` asks for
    one, and raises where it cannot be made."""
    return _form(build.load(), side, nb, form)[0]


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
                               cmax: int = 1, cheby_rho=None, form=None):
    """``advect_windowed`` of the u/v pair by itself, then
    ``fused_project_plain``, on one grid or a batch.  ``form`` (K17's) does
    not change the function."""
    ua = advect_windowed(1, u, u, v, dt, n, cmax)
    va = advect_windowed(2, v, u, v, dt, n, cmax)
    return co.fused_project_plain(ua, va, n, iters, cheby_rho=cheby_rho)


def fused_advect_project(u, v, n: int, iters: int, dt: float, *,
                         cmax: int = 1, cheby_rho=None,
                         form: str | None = None):
    """``project(advect_pair(1, 2, u, v, u, v))`` with the gather window of
    ``cmax`` cells, on float32 ``(side, side)`` or ``(nb, side, side)``
    velocities (``side = n + 2``); ``cheby_rho`` makes the pressure sweeps
    Chebyshev.  One K17 launch, in ``form`` (see the module docstring) or
    the form it chooses; returns fresh (u, v) tensors."""
    side = n + 2
    if not advect_project_supported(side, iters, cmax):
        raise ValueError(f"unsupported side={side} iters={iters} "
                         f"cmax={cmax} (see advect_project_supported)")
    if form not in _FORM_CODES:
        raise ValueError(f"form must be one of {FORMS} or None, got {form!r}")
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
        chosen, edge_floats = _form(lib, side, nb, form)
        uo, vo, au, av, rhs = (torch.empty_like(u) for _ in range(5))
        # The scratch the chosen form reads: the resident form x_{k-1}
        # (Chebyshev) and the bands' edge rows, the streaming form the
        # pressure iterates.
        if chosen == "resident":
            p = (torch.empty_like(u) if cheby else None, None, None)
            edges = u.new_empty(edge_floats)
        else:
            p = (torch.empty_like(u), torch.empty_like(u),
                 torch.empty_like(u) if cheby else None)
            edges = None
        h = grid_h(n)
        co._launch("advect_project", lib.fsc_advect_project, u.data_ptr(),
                   v.data_ptr(), uo.data_ptr(), vo.data_ptr(), au.data_ptr(),
                   av.data_ptr(), rhs.data_ptr(), *map(co._ptr, p),
                   co._ptr(edges), side, nb, iters, int(cmax),
                   co._dt0(dt, n), -0.5 * h, h, ctypes.addressof(omegas),
                   int(cheby), _FORM_CODES[chosen], co._stream(u))
        _form_launches[chosen] += 1
        return uo, vo
