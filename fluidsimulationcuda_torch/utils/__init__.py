from .checkpoint import load_checkpoint, save_checkpoint
from .stability import StabilityReport, check_stability, is_stable
from .timing import PhaseReport, profile_phases, wallclock

__all__ = [
    "load_checkpoint",
    "save_checkpoint",
    "StabilityReport",
    "check_stability",
    "is_stable",
    "PhaseReport",
    "profile_phases",
    "wallclock",
]
