"""Data parallelism over ``torch.distributed`` and in-process device
meshes (counterpart of ``speech_intent_recognizer_tpu/parallel/``)."""

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
    replicas,
    shard_batch,
    sharded_generator,
)

__all__ = [
    "Mesh",
    "MeshSpec",
    "ShardedGenerator",
    "batch_sharding",
    "create_mesh",
    "host_shard",
    "initialize_distributed",
    "local_batch_size",
    "replicas",
    "shard_batch",
    "shard_list",
    "sharded_generator",
]
