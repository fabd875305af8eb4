from .distributed import hybrid_mesh, initialize, launch
from .mesh import (Mesh, batch_sharding, make_mesh, replicated, shard_batch,
                   shard_params)

__all__ = ["batch_sharding", "make_mesh", "replicated", "shard_batch",
           "shard_params", "Mesh", "hybrid_mesh", "initialize", "launch"]
