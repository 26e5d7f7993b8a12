"""Per-phase timing (PyTorch twin of ``fluidsimulationcuda_tpu.utils.timing``).

Rebuilds the reference's observability (SURVEY.md §5): the phase times
``timeSource/timeDiffusion/timeDivergence/timeAdvection/timeProjection``
that ``vel_step`` fills and ``main`` averages (``FluidSequential.c:16,
192-235,314-324``; diffusion also per sweep, ``:324``), plus throughput in
cell-updates/s, the currency of ``project/report.txt``.

Each phase is one operator of the step's OpSet (``get_ops(cfg)``: K1, K2
and K3 on the ``cuda`` backend) run alone on the step's shapes, ``chain``
calls in a row after a warm-up: between two CUDA events on the card, by the
host clock on the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from ..core.config import SimConfig
from ..core.state import reference_init
from ..kernels.dispatch import get_ops
from ..ops.diffuse import as_scalar

__all__ = ["PhaseReport", "profile_phases", "wallclock"]


def wallclock(fn: Callable, *args, reps: int = 3, chain: int = 10) -> float:
    """Seconds per call of ``x = fn(x, *rest)`` (``args = (x, *rest)``):
    one warm-up chain of ``chain`` calls (it builds the kernels on first
    use), then ``reps`` chains timed together, between two CUDA events on
    a CUDA device and by the host clock on the CPU."""
    x, *rest = args

    def run():
        y = x
        for _ in range(chain):
            y = fn(y, *rest)
        return y

    run()
    calls = reps * chain
    if x.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3 / calls
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    return (time.perf_counter() - t0) / calls


@dataclasses.dataclass
class PhaseReport:
    """Per-phase seconds for one timestep (reference phase names)."""

    source: float
    diffusion: float       # one velocity-field diffusion solve
    divergence: float
    projection: float      # pressure solve + gradient subtraction
    advection: float       # u/v pair self-advection
    per_sweep: float       # diffusion / jacobi_iters (reference :324)
    step_estimate: float   # composed full-step estimate
    cells: int

    @property
    def mcells_per_s(self) -> float:
        return self.cells / self.step_estimate / 1e6

    def pretty(self) -> str:
        rows = [
            ("add_source", self.source),
            ("diffuse (1 solve)", self.diffusion),
            ("  per sweep", self.per_sweep),
            ("divergence", self.divergence),
            ("projection", self.projection),
            ("advection (pair)", self.advection),
            ("full step (est)", self.step_estimate),
        ]
        out = "\n".join(f"{k:22s} {v * 1e3:9.3f} ms" for k, v in rows)
        return out + (f"\n{'throughput (op-sum)':22s} "
                      f"{self.mcells_per_s:9.1f} Mcell/s")


def profile_phases(cfg: SimConfig,
                   generator: torch.Generator | None = None) -> PhaseReport:
    """Time each phase of the 2-D step of ``cfg`` on ``cfg.device``, on the
    velocity sources ``reference_init`` draws from ``generator`` (one on
    ``cfg.device`` seeded 0 if None)."""
    if cfg.ndim != 2:
        raise ValueError("profile_phases times the 2-D step's operators; "
                         f"got ndim={cfg.ndim}")
    ops = get_ops(cfg)
    if generator is None:
        generator = torch.Generator(device=cfg.device).manual_seed(0)
    _, src = reference_init(generator, cfg)
    u, v = src.u, src.v
    alpha = cfg.diffusion_alpha_visc
    beta = 1.0 + 4.0 * alpha
    it = cfg.jacobi_iters
    dtc = as_scalar(cfg.dt, u)

    t_source = wallclock(lambda x, s: x + dtc * s, u, v)
    t_diff = wallclock(
        lambda x, s: ops.diffuse(1, x, s, alpha, beta, it), u, v, chain=6)
    t_div = wallclock(lambda x, s: ops.divergence(x, s, cfg.n), u, v)
    t_proj = wallclock(
        lambda x, s: ops.apply_pressure_gradient(
            x, s, ops.pressure_solve(ops.divergence(x, s, cfg.n), it), cfg.n
        )[0],
        u, v, chain=6)
    t_adv = wallclock(
        lambda x, s: ops.advect_pair(1, 2, x, s, x, s, cfg.dt, cfg.n)[0],
        u, v, chain=6)
    # A step: 3 add_source + 3 diffusions (u, v, dens) + 2 projections
    # (divergence included) + the pair advection + the density's (~pair/2).
    est = 3 * t_source + 3 * t_diff + 2 * t_proj + t_adv * 1.5
    return PhaseReport(
        source=t_source,
        diffusion=t_diff,
        divergence=t_div,
        projection=t_proj,
        advection=t_adv,
        per_sweep=t_diff / it,
        step_estimate=est,
        cells=cfg.num_cells,
    )
