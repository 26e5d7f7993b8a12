"""The multi-device steps: device meshes, the 2-D step on row slabs or
2-D blocks and the 3-D z-slab step."""
from .mesh import Blocks, Mesh, make_mesh
from .sharded import make_sharded_step_fn, shard_blocks, shard_state, unshard
from .sharded3d import make_sharded_step_fn_3d, shard_state_3d

__all__ = ["Blocks", "Mesh", "make_mesh", "make_sharded_step_fn",
           "shard_state", "shard_blocks", "unshard",
           "make_sharded_step_fn_3d", "shard_state_3d"]
