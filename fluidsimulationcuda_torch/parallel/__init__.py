"""The multi-device steps: device meshes, the 2-D row-slab step and the
3-D z-slab step."""
from .mesh import Mesh, make_mesh
from .sharded import make_sharded_step_fn, shard_state, unshard
from .sharded3d import make_sharded_step_fn_3d, shard_state_3d

__all__ = ["Mesh", "make_mesh", "make_sharded_step_fn", "shard_state",
           "unshard", "make_sharded_step_fn_3d", "shard_state_3d"]
