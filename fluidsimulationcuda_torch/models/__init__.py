from .batched import (batched_init, generate_trajectories,
                      make_batched_step_fn, select_cmax_batched)
from .scenarios import SCENARIOS
from .stable_fluids_2d import StableFluids2D, make_step_fn, simulate, step, step_audited
from .stable_fluids_3d import (StableFluids3D, dens_step3, make_step_fn_3d, step3,
                               step_audited3, vel_step3)

__all__ = ["StableFluids2D", "make_step_fn", "simulate", "step", "step_audited",
           "StableFluids3D", "make_step_fn_3d", "step3", "step_audited3",
           "vel_step3", "dens_step3", "batched_init", "make_batched_step_fn",
           "select_cmax_batched", "generate_trajectories", "SCENARIOS"]
