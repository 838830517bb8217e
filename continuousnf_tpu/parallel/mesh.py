"""Device mesh construction for batch + probe sharding.

The CNF analog of sequence/context parallelism (SURVEY §5): the two
embarrassingly-parallel axes of the augmented dynamics are the **batch** axis
and the **Hutchinson probe** axis — both reduce into the loss, so sharding
either one turns the final mean into a psum that XLA compiles into a
collective.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
PROBE_AXIS = "probe"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh description.

    `data` shards the sample batch; `probe` shards the K Hutchinson probes.
    Total devices = data * probe must equal the devices used.
    """

    data: int
    probe: int = 1

    @property
    def axis_names(self) -> Tuple[str, str]:
        return (DATA_AXIS, PROBE_AXIS)

    @property
    def total(self) -> int:
        return self.data * self.probe


def make_mesh(config: Optional[MeshConfig] = None, devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh over ("data", "probe").

    Default: all local devices on the data axis.  Device order follows
    `jax.devices()`.
    """
    if devices is None:
        devices = jax.devices()
    if config is None:
        config = MeshConfig(data=len(devices), probe=1)
    if config.total != len(devices):
        raise ValueError(
            f"mesh {config.data}x{config.probe} needs {config.total} devices, got {len(devices)}"
        )
    dev_array = np.asarray(devices).reshape(config.data, config.probe)
    return Mesh(dev_array, config.axis_names)


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (B, ...) batch arrays: batch split over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def probe_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (K, B, dz) probe arrays: K over probe, B over data."""
    return NamedSharding(mesh, P(PROBE_AXIS, DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    """Fully-replicated sharding (params, scalars)."""
    return NamedSharding(mesh, P())


__all__ = [
    "DATA_AXIS",
    "PROBE_AXIS",
    "MeshConfig",
    "make_mesh",
    "data_sharding",
    "probe_sharding",
    "replicated",
]
