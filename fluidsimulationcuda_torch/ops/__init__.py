from .advect import advect, advect_windowed, backtrace
from .boundary import embed_interior, set_bnd
from .diffuse import diffuse, jacobi_sweep
from .project import apply_pressure_gradient, divergence, pressure_solve, project
from .source import add_source

__all__ = [
    "advect", "advect_windowed", "backtrace", "embed_interior", "set_bnd",
    "diffuse", "jacobi_sweep", "apply_pressure_gradient", "divergence",
    "pressure_solve", "project", "add_source",
]
