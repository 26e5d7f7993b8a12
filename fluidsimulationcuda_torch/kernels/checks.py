"""Kernel-against-plain comparisons and device timing on the card.

Shared by ``chip_smoke.py`` and the GPU tests: each ``Check`` calls one
``cuda_ops`` wrapper on CUDA tensors and its plain version on the same
tensors, at the coefficients the 2-D step gives it.  Inputs come from
``np.random.default_rng(seed)``: fields in [-1, 1], velocities scaled so the
backtrace moves at most two cells.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from . import cuda_ops as co

__all__ = ["TOL", "Check", "kernel_checks", "timing_checks", "max_abs_diff",
           "device_ms"]

# Kernel against plain version on the same inputs.  Both evaluate the same
# float32 expressions in the same order (the kernels build with
# --fmad=false), so parity modes agree to a few ulps; fast mode differs by
# one rounding per sweep (fmaf against a multiply and an add).
TOL = 1e-5

DT, VISC, DIFF = 0.016, 0.0025, 0.1


@dataclasses.dataclass
class Check:
    label: str
    kernels: tuple[str, ...]  # the CUDA kernels this wrapper call launches
    run: Callable[[], object]
    plain: Callable[[], object]


def _check(label, kernels, fn, plain, *args, **kw) -> Check:
    return Check(label, kernels, lambda: fn(*args, **kw),
                 lambda: plain(*args, **kw))


class _Inputs:
    """Random fields at grid ``side`` and the step's coefficients there."""

    def __init__(self, side: int, device, seed: int):
        rng = np.random.default_rng(seed)
        self.n = n = side - 2

        def field(scale=1.0):
            a = rng.uniform(-1.0, 1.0, (side, side)).astype(np.float32)
            return torch.from_numpy(a * np.float32(scale)).to(device)

        vscale = 2.0 / (DT * n)  # |dt*n*u| <= 2 cells
        self.x, self.x0, self.src, self.p = field(), field(), field(), field()
        self.u, self.v = field(vscale), field(vscale)
        self.a_visc = DT * VISC * n * n
        self.a_diff = DT * DIFF * n * n


JAC = ("jacobi_sweep",)
PROJ = ("divergence", "jacobi_sweep", "gradient")
DENS = ("jacobi_sweep", "dens_advect")


def kernel_checks(side: int, device, seed: int = 0) -> list[Check]:
    """Every wrapper of the 2-D step in every mode the step uses, at grid
    ``side``: 20 parity sweeps, and the compensated perf mode's
    (rho, k_d, k_p) = (0.9, 10, 14)."""
    t = _Inputs(side, device, seed)
    n, av, ad = t.n, t.a_visc, t.a_diff
    iters, (rho, k_d, k_p) = 20, (0.9, 10, 14)
    modes = {
        "jacobi": dict(),
        "src_dt": dict(src_dt=DT),
        "zero_init": dict(zero_init=True),
        "fast": dict(src_dt=DT, fast=True),
        "chebyshev": dict(src_dt=DT, cheby_rho=rho),
        "chebyshev+fast": dict(src_dt=DT, cheby_rho=rho, fast=True),
    }
    out = []
    for b in (0, 1, 2):
        for mode, kw in modes.items():
            k = k_d if "cheby_rho" in kw else iters
            out.append(_check(f"fused_jacobi b={b} {mode} {k}it", JAC,
                              co.fused_jacobi, co.fused_jacobi_plain, b, t.x,
                              t.x0, av, 1 + 4 * av, k, **kw))
    return out + [
        _check("divergence_p", ("divergence",), co.divergence_p,
               co.divergence_p_plain, t.u, t.v, n),
        _check("gradient_p", ("gradient",), co.gradient_p,
               co.gradient_p_plain, t.u, t.v, t.p, n),
        _check(f"fused_project jacobi {iters}it", PROJ, co.fused_project,
               co.fused_project_plain, t.u, t.v, n, iters),
        _check(f"fused_project chebyshev {k_p}it", PROJ, co.fused_project,
               co.fused_project_plain, t.u, t.v, n, k_p, cheby_rho=rho),
        _check("advect_shift b=0", ("advect",), co.advect_shift,
               co.advect_shift_plain, 0, t.x, t.u, t.v, DT, n),
        _check("advect_shift_fused u/v pair", ("advect",),
               co.advect_shift_fused, co.advect_shift_fused_plain, (1, 2),
               (t.u, t.v), t.u, t.v, DT, n),
        _check(f"fused_dens_advect jacobi {iters}it", DENS,
               co.fused_dens_advect, co.fused_dens_advect_plain, 0, t.src,
               t.x0, t.u, t.v, ad, 1 + 4 * ad, iters, DT, n),
        _check(f"fused_dens_advect chebyshev+fast {k_d}it", DENS,
               co.fused_dens_advect, co.fused_dens_advect_plain, 0, t.src,
               t.x0, t.u, t.v, ad, 1 + 4 * ad, k_d, DT, n, fast=True,
               cheby_rho=rho),
    ]


def timing_checks(side: int, device, seed: int = 0) -> list[Check]:
    """What ``chip_smoke.py`` times: first one launch of each CUDA kernel
    (labelled by the kernel's name) beside its plain version, then each
    wrapper at the main path's iteration counts, then the unfused density
    step (K1 then K3) that K4 has to beat (ROADMAP B4)."""
    t = _Inputs(side, device, seed)
    n, av, ad = t.n, t.a_visc, t.a_diff
    bv, bd = 1 + 4 * av, 1 + 4 * ad

    def unfused_density():
        d = co.fused_jacobi(0, t.src, t.x0, ad, bd, 20, src_dt=DT)
        return co.advect_shift(0, d, t.u, t.v, DT, n)

    return [
        _check("jacobi_sweep", JAC, co.fused_jacobi, co.fused_jacobi_plain,
               1, t.x, t.x0, av, bv, 1),
        _check("divergence", ("divergence",), co.divergence_p,
               co.divergence_p_plain, t.u, t.v, n),
        _check("gradient", ("gradient",), co.gradient_p, co.gradient_p_plain,
               t.u, t.v, t.p, n),
        _check("advect", ("advect",), co.advect_shift_fused,
               co.advect_shift_fused_plain, (1, 2), (t.u, t.v), t.u, t.v, DT,
               n),
        _check("dens_advect", ("dens_advect",), co.fused_dens_advect,
               co.fused_dens_advect_plain, 0, t.src, t.x0, t.u, t.v, ad, bd,
               1, DT, n),
        _check("fused_jacobi 20it src_dt (u diffusion)", JAC, co.fused_jacobi,
               co.fused_jacobi_plain, 1, t.src, t.x0, av, bv, 20, src_dt=DT),
        _check("fused_jacobi 10it chebyshev+fast", JAC, co.fused_jacobi,
               co.fused_jacobi_plain, 1, t.src, t.x0, av, bv, 10, src_dt=DT,
               fast=True, cheby_rho=0.9),
        _check("fused_project 20it", PROJ, co.fused_project,
               co.fused_project_plain, t.u, t.v, n, 20),
        _check("fused_project 14it chebyshev", PROJ, co.fused_project,
               co.fused_project_plain, t.u, t.v, n, 14, cheby_rho=0.9),
        _check("fused_dens_advect 20it", DENS, co.fused_dens_advect,
               co.fused_dens_advect_plain, 0, t.src, t.x0, t.u, t.v, ad, bd,
               20, DT, n),
        _check("fused_dens_advect 10it chebyshev+fast", DENS,
               co.fused_dens_advect, co.fused_dens_advect_plain, 0, t.src,
               t.x0, t.u, t.v, ad, bd, 10, DT, n, fast=True, cheby_rho=0.9),
        Check("unfused density step: K1 20it + K3", ("jacobi_sweep", "advect"),
              unfused_density,
              lambda: co.fused_dens_advect_plain(0, t.src, t.x0, t.u, t.v,
                                                 ad, bd, 20, DT, n)),
    ]


def _as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def max_abs_diff(a, b) -> float:
    return max(float((x - y).abs().max())
               for x, y in zip(_as_tuple(a), _as_tuple(b)))


def device_ms(fn: Callable[[], object], reps: int = 20) -> float:
    """Device milliseconds of one ``fn()`` call: ``reps`` calls captured in
    a CUDA graph, replayed between CUDA events, so Python and launch
    overhead are not in the number.  ``fn`` must launch on the current
    stream and not synchronise."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up: builds the library, fills the allocator
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()  # warm-up replay
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps
