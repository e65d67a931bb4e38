"""Multi-host execution support.

The reference has no multi-node capability at all (SURVEY.md section 2.3:
no MPI/NCCL/sockets — OpenMP only). The rebuild scales across hosts
with ``jax.distributed``: every host runs the same program, the global
mesh spans all hosts' devices, and the sharded engine
(parallel/doubling.py) runs unchanged — its collectives (ppermute
merge-split rounds, all_gathers of per-shard scalars) ride the
interconnect within a host and the network across hosts.

Single-process testing of the multi-host code path uses the virtual CPU
mesh (tests/conftest.py); this module only adds the process bootstrap and
host-sharded I/O helpers.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID). No-op
    for single-process runs."""
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes or int(os.environ["JAX_NUM_PROCESSES"]),
        process_id=process_id or int(os.environ["JAX_PROCESS_ID"]),
    )


def global_mesh(axis: str = "d"):
    """1-D mesh over every device of every process."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def host_local_slice(n: int) -> slice:
    """The text slice this host should load (equal contiguous shards per
    process; n must divide evenly across the global device count)."""
    import jax

    nproc = jax.process_count()
    pid = jax.process_index()
    if n % nproc:
        raise ValueError("n=%d not divisible by process count %d" % (n, nproc))
    per = n // nproc
    return slice(pid * per, (pid + 1) * per)


def make_global_text_array(local_text: np.ndarray, n: int, mesh, axis: str = "d"):
    """Assemble a globally-sharded device array from each host's local
    contiguous text shard (jax.make_array_from_process_local_data)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_process_local_data(
        sharding, np.asarray(local_text, dtype=np.int32), (n,))
