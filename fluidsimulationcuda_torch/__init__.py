"""fluidsimulationcuda_torch — the Stable Fluids engine on PyTorch, with
hand-written CUDA kernels for the NVIDIA H100.

The port of ``fluidsimulationcuda_tpu`` (JAX/Pallas), which stays the
reference it is tested against.  It imports ``torch`` and never ``jax``:

- ``core``     — ``SimConfig`` (with an explicit ``device``), ``FluidState`` /
  ``Sources`` tensor NamedTuples and numpy round-trip helpers
- ``ops``      — the 2-D and 3-D operators in plain torch (``reference``
  backend)
- ``kernels``  — backend dispatch, the CUDA wrappers (``cuda`` backend) and
  the nvcc build of ``csrc/``
- ``models``   — the 2-D step, batched datagen over it, and the 3-D
  smoke-volume step
- ``parallel`` — the multi-device steps on one process's mesh: row slabs
  or 2-D blocks (2-D) and z-slabs (3-D)
- ``utils``    — checkpoints (readable by both packages), stability
  diagnostics, per-phase timing, the validation bars and PNG rendering

The command line is ``python -m fluidsimulationcuda_torch run | profile |
datagen | info`` (``__main__.py``).

Entry points run on the card (``SimConfig.device`` defaults to ``"cuda"``)
unless the caller asks for the CPU.
"""

from .core.config import SimConfig
from .core.state import FluidState, Sources, reference_init, zero_sources, zero_state
from .models import SCENARIOS
from .models.batched import (batched_init, generate_trajectories,
                             make_batched_step_fn, select_cmax_batched)
from .models.stable_fluids_2d import StableFluids2D, make_step_fn, simulate, step, step_audited
from .models.stable_fluids_3d import StableFluids3D, step3
from .parallel import (make_mesh, make_sharded_step_fn,
                       make_sharded_step_fn_3d, shard_blocks, shard_state,
                       shard_state_3d, unshard)
from .utils import (PhaseReport, StabilityReport, check_stability, is_stable,
                    load_checkpoint, profile_phases, save_checkpoint,
                    wallclock)

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "FluidState",
    "Sources",
    "reference_init",
    "zero_state",
    "zero_sources",
    "StableFluids2D",
    "StableFluids3D",
    "make_step_fn",
    "simulate",
    "step",
    "step_audited",
    "step3",
    "batched_init",
    "make_batched_step_fn",
    "select_cmax_batched",
    "generate_trajectories",
    "make_mesh",
    "make_sharded_step_fn",
    "make_sharded_step_fn_3d",
    "shard_blocks",
    "shard_state",
    "shard_state_3d",
    "unshard",
    "SCENARIOS",
    "load_checkpoint",
    "save_checkpoint",
    "StabilityReport",
    "check_stability",
    "is_stable",
    "PhaseReport",
    "profile_phases",
    "wallclock",
    "__version__",
]
