"""The device mesh (port of `diffmusic_tpu/parallel`): dp x tp ranks over
`torch.distributed`, the sharded batch and the ranks' launcher."""

from .mesh import (Mesh, data_parallel_map, launch, make_mesh, parse_mesh, replicate,
                   shard_batch_dp, shard_params_tp, sharded_batch)

__all__ = ["Mesh", "make_mesh", "parse_mesh", "launch", "replicate", "shard_batch_dp",
           "shard_params_tp", "data_parallel_map", "sharded_batch"]
