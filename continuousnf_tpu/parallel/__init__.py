"""Multi-device / multi-host scaling.

The reference is single-process single-device (SURVEY §2.3: no DP/TP/PP, no
communication backend).  This package is the from-scratch scale-out
mandated by BASELINE: a `Mesh` over ("data", "probe") axes, batch sharding +
Hutchinson-probe sharding with XLA collectives inserted by the compiler, and
multi-host initialization.
"""

from .mesh import MeshConfig, make_mesh, data_sharding, probe_sharding, replicated
from .sharding import shard_batch, shard_params, make_sharded_train_step, make_sharded_logprob
from .distributed import initialize_distributed, global_batch_from_host_shards

__all__ = [
    "MeshConfig",
    "probe_sharding",
    "make_sharded_logprob",
    "global_batch_from_host_shards",
    "make_mesh",
    "data_sharding",
    "replicated",
    "shard_batch",
    "shard_params",
    "make_sharded_train_step",
    "initialize_distributed",
]
