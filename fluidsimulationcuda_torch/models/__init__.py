from .stable_fluids_2d import StableFluids2D, make_step_fn, simulate, step, step_audited

__all__ = ["StableFluids2D", "make_step_fn", "simulate", "step", "step_audited"]
