"""Device mesh helpers.

The reference's entire parallel runtime is OpenMP thread packs over a single
host (SURVEY.md section 2.3); the rebuild replaces it with a 1-D device
mesh ("d") over which the text, ranks and sort waves are sharded. Multi-host
meshes extend the same axis across hosts.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


AXIS = "d"


def make_mesh(n_devices: Optional[int] = None, axis: str = AXIS) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                "requested %d devices, only %d available" % (n_devices, len(devices))
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def shard_1d(mesh: Mesh, x, axis: str = AXIS):
    return jax.device_put(x, NamedSharding(mesh, PartitionSpec(axis)))


def replicated(mesh: Mesh, x):
    return jax.device_put(x, NamedSharding(mesh, PartitionSpec()))
