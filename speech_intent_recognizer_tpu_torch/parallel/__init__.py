"""Data and tensor parallelism over ``torch.distributed``, and in-process
device meshes (counterpart of ``speech_intent_recognizer_tpu/parallel/``)."""

from speech_intent_recognizer_tpu_torch.parallel.distributed import (
    host_shard,
    initialize_distributed,
    shard_list,
)
from speech_intent_recognizer_tpu_torch.parallel.mesh import (
    Mesh,
    MeshSpec,
    create_mesh,
    local_batch_size,
)
from speech_intent_recognizer_tpu_torch.parallel.sharding import (
    ShardedGenerator,
    batch_sharding,
    full_state_dict,
    param_shardings,
    place_params,
    replicas,
    shard_batch,
    sharded_generator,
    spec_for_leaf,
)

__all__ = [
    "Mesh",
    "MeshSpec",
    "ShardedGenerator",
    "batch_sharding",
    "create_mesh",
    "full_state_dict",
    "host_shard",
    "initialize_distributed",
    "local_batch_size",
    "param_shardings",
    "place_params",
    "replicas",
    "shard_batch",
    "shard_list",
    "sharded_generator",
    "spec_for_leaf",
]
