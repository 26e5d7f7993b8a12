"""Simulation configuration (PyTorch twin of ``fluidsimulationcuda_tpu.core.config``).

Same fields and defaults as the JAX ``SimConfig``, plus an explicit
``device``.  PyTorch runs eagerly, so the config is a plain frozen
dataclass read by the ops at call time; nothing is compiled against it.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Tuple

import torch

__all__ = ["SimConfig", "PERF_POINTS_2D", "PERF_POINT_3D", "perf_operating_point"]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Frozen simulation configuration.

    The fields mean what they mean in the JAX package's ``SimConfig``
    (grid ``(n+2)^2`` with one ghost cell per side, ``dt``, ``visc``,
    ``diff``, ``jacobi_iters``, the solver choices and the Chebyshev
    knobs).  What differs:

      dtype: ``torch.float32``, or ``torch.bfloat16`` as a storage format
        (JAX's bf16 mode): state and sources are stored in bf16.  The
        ``reference`` backend runs its plain ops on bf16 tensors, as JAX's
        jnp ops run on bf16 arrays; the ``cuda`` kernels read bf16, compute
        in float32 and write bf16 (``kernels/cuda_ops.py``).  The 2-D step
        on one device, with any pressure solve: multigrid takes a bf16
        divergence to a float32 pressure (float32 transfers and coarse
        levels, as JAX's), CG stays bf16, and the gradient writes the
        state's dtype.  The 2-D multi-device step runs bf16 on its block
        route.  The 3-D step on one device, in every solver mode and both
        gathers: the ``reference`` backend rounds each jnp op of JAX's
        bf16 ``step3`` as JAX does, its gathers in float32 rounded once;
        on the ``cuda`` backend a solve's iterate stays float32 from its
        first sweep to its last and is rounded once at the end, the folded
        or prescaled rhs is rounded to bf16 before any sweep reads it, and
        the projection keeps a float32 divergence and pressure
        (``kernels/cuda_ops_3d.py``).  The 3-D z-slab step, with the same
        rules on its slabs, a solve's float32 iterate handed from segment
        to segment (``parallel/sharded3d.py``).
      backend: ``"reference"`` runs the plain torch ops of ``ops/``;
        ``"cuda"`` runs the hand-written kernels of ``kernels/cuda_ops.py``
        and ``kernels/cuda_ops_3d.py`` and needs a CUDA ``device``;
        ``"auto"`` is ``"cuda"`` when ``device`` is a CUDA device and
        ``"reference"`` otherwise.  It is decided from ``device`` alone:
        nothing probes for a GPU and nothing falls back to the CPU.
      device: where the state lives and the ops run; the card
        (``"cuda"``) unless the caller asks for ``"cpu"``.
      fuse_sweeps, max_courant: the multi-device steps' sweeps per halo
        exchange (0: 20) and gather window in cells, as in the JAX
        package.  The single-device 2-D step runs T sweeps of a solve per
        launch of the tiled K1, T a constant of the kernel chosen by
        measurement (``cuda_ops.SWEEPS_PER_LAUNCH``), and the 3-D step one
        sweep per launch, so ``fuse_sweeps`` changes nothing there;
        ``max_courant`` is the 2-D step's window under
        ``advect_mode="windowed"``.
      pressure_solver: ``"jacobi"`` and ``"chebyshev"`` everywhere;
        ``"multigrid"`` (``mg_cycles`` V-cycles, ``ops/multigrid.py``) and
        ``"cg"`` (``cg_iters`` iterations, ``ops/cg.py``) in the 2-D step,
        on one grid, a batch or row slabs (``parallel/solvers.py``; the
        slab multigrid needs slabs of an even row count); 3-D refuses them,
        as the JAX package does.
      advect_mode: ``"auto"`` and ``"exact"`` gather exactly (the JAX
        package's ``"auto"`` is windowed on a TPU only); ``"windowed"``
        clamps each departure point to ``max_courant`` cells around its
        cell (``ops.advect.advect_windowed``, ``ops.three_d.
        advect3_windowed``: exact while the backtrace moves at most
        ``max_courant`` cells), in the 2-D and 3-D steps on both backends.
        The multi-device steps take their own ``advect_mode`` argument:
        ``"exact"`` gathers from the assembled fields at any displacement,
        ``"windowed"`` in the window; ``"auto"`` is windowed where every
        slab holds ``max_courant+1`` rows or planes, and on thinner z-slabs
        exact (thinner row slabs take the 2-D step's block route, exact).
      ndim: 2 (the flagship) or 3 (smoke volumes, ``(n+2)^3``).
    """

    n: int = 126
    dt: float = 0.016
    visc: float = 0.0025
    diff: float = 0.1
    jacobi_iters: int = 20
    dtype: torch.dtype = torch.float32
    backend: str = "auto"
    fuse_sweeps: int = 0
    max_courant: int = 4
    pressure_solver: str = "jacobi"
    diffusion_solver: str = "jacobi"
    mg_cycles: int = 2
    cg_iters: int = 20
    cheby_iters: int = 8
    cheby_press_iters: int = 0
    cheby_rho: float = 0.99
    cheby_dens_iters: int = 10
    advect_mode: str = "auto"
    fast_math: bool = False
    ndim: int = 2
    device: torch.device = torch.device("cuda")

    def __post_init__(self):
        object.__setattr__(self, "device", torch.device(self.device))
        if self.n < 2:
            raise ValueError(f"n must be >= 2, got {self.n}")
        if self.jacobi_iters < 1:
            raise ValueError("jacobi_iters must be >= 1")
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or "
                             f"torch.bfloat16, got {self.dtype}")
        if self.backend not in ("reference", "cuda", "auto"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.backend == "cuda" and self.device.type != "cuda":
            raise ValueError("backend='cuda' needs a CUDA device, got "
                             f"device={self.device}")
        if self.pressure_solver not in ("jacobi", "multigrid", "cg",
                                        "chebyshev"):
            raise ValueError(f"unknown pressure_solver {self.pressure_solver!r}")
        if self.diffusion_solver not in ("jacobi", "chebyshev",
                                         "chebyshev-dens"):
            raise ValueError(
                f"unknown diffusion_solver {self.diffusion_solver!r}")
        if not (0.0 < self.cheby_rho < 1.0):
            raise ValueError("cheby_rho must be in (0, 1)")
        if self.cheby_iters < 2:
            raise ValueError("cheby_iters must be >= 2")
        if self.cheby_press_iters and self.cheby_press_iters < 2:
            raise ValueError("cheby_press_iters must be 0 (follow "
                             "cheby_iters) or >= 2")
        if self.cheby_dens_iters < 2:
            raise ValueError("cheby_dens_iters must be >= 2")
        if self.advect_mode not in ("auto", "exact", "windowed"):
            raise ValueError(f"unknown advect_mode {self.advect_mode!r}")
        if self.ndim not in (2, 3):
            raise ValueError("ndim must be 2 or 3")
        if self.ndim == 3 and self.pressure_solver not in ("jacobi",
                                                           "chebyshev"):
            raise ValueError(
                "pressure_solver='multigrid'/'cg' are 2-D solvers; "
                "ndim=3 supports 'jacobi' and 'chebyshev'")
        if (self.ndim == 3 and self.diffusion_solver == "chebyshev"
                and self.pressure_solver != "chebyshev"):
            # The velocity-diffusion swap is validated only with the
            # Chebyshev pressure solve compensating it (PERF_POINT_3D).
            raise ValueError(
                "ndim=3 diffusion_solver='chebyshev' requires "
                "pressure_solver='chebyshev' (the compensated mode); "
                "uncompensated 3-D swaps have no validated operating point")

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        """Full padded grid shape, ghost border included."""
        return (self.n + 2,) * self.ndim

    @property
    def press_cheby_iters(self) -> int:
        """Effective pressure-solve sweep count in chebyshev mode."""
        return self.cheby_press_iters or self.cheby_iters

    @property
    def num_cells(self) -> int:
        return math.prod(self.grid_shape)

    @property
    def diffusion_alpha_visc(self) -> float:
        """alpha for velocity diffusion (``FluidSequential.c:199``)."""
        return self.dt * self.visc * self.n * self.n

    @property
    def diffusion_alpha_diff(self) -> float:
        """alpha for density diffusion (``FluidSequential.c:179``)."""
        return self.dt * self.diff * self.n * self.n

    @property
    def resolved_backend(self) -> str:
        """``backend`` with ``"auto"`` decided from ``device``."""
        if self.backend != "auto":
            return self.backend
        return "cuda" if self.device.type == "cuda" else "reference"

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


# Validated compensated perf-mode operating points, keyed by full grid side
# (n + 2): (rho, k_d diffusion sweeps, k_p pressure sweeps).  Measured by
# the JAX package's probes, not defaults:
#
# - 2-D 2048²/20it: dev/bench_r3q_compensated.py; all three bars pass
#   (div 0.44x, forced v-res 0.304, dens 0.913).
# - 2-D 8192²/40it: dev/bench_r4a_frontier8k.py plus the forced-twin
#   probes; the 2048² point FAILS the forced velocity-residual bar there
#   (1.029), (0.96, 12, 14) passes all bars (div 0.990x, v-res 0.998).
# - 3-D 256³/20it: dev/bench_r3s_3dcomp.py; rho=0.9 fails 3-D, 0.85 passes
#   with k_p=12.
#
# The bars are properties of the numerics, not of the hardware, so the
# points carry over to the port unchanged.
PERF_POINTS_2D = {2048: (0.9, 10, 14), 8192: (0.96, 12, 14)}
PERF_POINT_3D = (0.85, 10, 12)


def perf_operating_point(side: int, ndim: int = 2):
    """(cheby_rho, cheby_iters, cheby_press_iters) for the compensated perf
    preset at full grid ``side`` = n + 2, as the JAX package's
    ``perf_operating_point`` returns it.

    A side in the table gets its measured point.  Any other side gets the
    anchor nearest in log-distance, with a warning that the point is
    unvalidated at this size.  The distance is JAX's float expression, so
    4096², which lies between 2048² and 8192², takes the 2048² point there
    as here (its distance to 2048 rounds 9e-16 smaller)."""
    if ndim == 3:
        return PERF_POINT_3D
    if side in PERF_POINTS_2D:
        return PERF_POINTS_2D[side]
    nearest = min(PERF_POINTS_2D,
                  key=lambda s: abs(math.log(s) - math.log(max(side, 1))))
    warnings.warn(
        f"perf operating point unvalidated at this size (side={side}); "
        f"using the side={nearest} point {PERF_POINTS_2D[nearest]}. Run "
        f"the perf-mode bars at this size before trusting it.",
        stacklevel=2,
    )
    return PERF_POINTS_2D[nearest]
