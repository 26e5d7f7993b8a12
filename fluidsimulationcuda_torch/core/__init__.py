from .config import SimConfig
from .state import (FluidState, Sources, reference_init, state_from_numpy,
                    state_to_numpy, zero_sources, zero_state)

__all__ = ["SimConfig", "FluidState", "Sources", "reference_init", "zero_sources",
           "zero_state", "state_from_numpy", "state_to_numpy"]
