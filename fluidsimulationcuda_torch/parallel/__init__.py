"""The multi-device step: device meshes and the 2-D row-slab step."""
from .mesh import Mesh, make_mesh
from .sharded import make_sharded_step_fn, shard_state, unshard

__all__ = ["Mesh", "make_mesh", "make_sharded_step_fn", "shard_state",
           "unshard"]
