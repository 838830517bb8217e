"""Multi-host initialization and per-host data feeding.

The reference has no multi-process capability (SURVEY §2.3); this is the
jax.distributed-based scale-out: one process per host, global mesh spanning
all hosts, per-host shards assembled into global arrays so the training step
is identical to the single-host case (the compiler inserts the collectives
from the mesh layout).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the multi-host JAX runtime.

    No-op when running single-process (the common dev path).  With several
    processes, call once per process before any jax op.  Arguments left None
    are auto-detected by `jax.distributed.initialize` where the cluster
    environment provides them; where it does not, pass the coordinator
    address, process count and process id.
    """
    if num_processes is not None and num_processes <= 1:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError) as e:  # already initialized / single proc
        if "already" not in str(e).lower():
            raise


def global_batch_from_host_shards(mesh, host_batch: np.ndarray) -> jax.Array:
    """Assemble per-host local batches into one globally-sharded array.

    Each host passes its local (B_local, d) shard; the result is a global
    (B_local * num_hosts, d) array sharded over the mesh's data axis —
    the per-host loader pattern of SURVEY §5.
    """
    from .mesh import data_sharding

    return jax.make_array_from_process_local_data(data_sharding(mesh), host_batch)


def host_batch_slice(mesh, global_batch_size: int) -> slice:
    """The batch-dim slice this process must pass to
    `global_batch_from_host_shards` for the given mesh.

    For a pure data mesh every process holds a distinct contiguous chunk;
    for meshes whose data axis does NOT span all processes (e.g. the probe
    axis crossing hosts), processes in the same data-group must pass
    IDENTICAL rows — `jax.make_array_from_process_local_data` treats the
    local value as the process's addressable portion of the global array.
    """
    from .mesh import data_sharding

    sh = data_sharding(mesh)
    idx_map = sh.addressable_devices_indices_map((global_batch_size,))
    starts = {(ix[0].start or 0, ix[0].stop) for ix in idx_map.values()}
    if len(starts) != 1:
        raise ValueError(
            "this process's devices hold different data shards; feed per-"
            "device (jax.make_array_from_callback) instead of per-host"
        )
    start, stop = next(iter(starts))
    return slice(start, stop)


__all__ = ["initialize_distributed", "global_batch_from_host_shards", "host_batch_slice"]
