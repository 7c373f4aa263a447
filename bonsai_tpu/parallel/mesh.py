"""Device mesh construction.

The reference's parallelism is a single-node thread pool
(klib kthread work stealing, /root/reference/klib/kthread.c:71-174).  The
device-mesh equivalents (SURVEY §2.10):

  axis 'dp' — data parallelism over reads (replaces the read-slice pool)
  axis 'db' — database sharding: each rank owns a contiguous range of
              table buckets; probes combine with one psum over 'db'
              (replaces the shared-memory khash read by all threads)
  axis 'sp' — sequence parallelism for multi-Mb contigs in DB build, with
              ppermute halo exchange (replaces streaming rolling state)

All collectives are standard jax.lax primitives under shard_map, which XLA
hands to NCCL on GPUs (NVLink within a host, the network across hosts).
Every device reaches every other at the same rate, so mesh axes follow the
algorithm alone, in jax.devices() order.  Multi-host launches use
jax.distributed.initialize() (see init_distributed).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Join the multi-host runtime (the reference has no cross-node story;
    this is the multi-host growth path, SURVEY §2.10 'distributed backend').

    Pass the coordinator \"host:port\", the process count and this
    process's id, or set JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID; nothing is auto-detected on a plain GPU cluster.
    Returns this process's id.  Safe to call twice (second call no-ops).
    """
    import os

    import jax

    if getattr(init_distributed, "_done", False):
        return jax.process_index()
    kw = {}
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator:
        kw["coordinator_address"] = coordinator
    num_processes = num_processes or os.environ.get("JAX_NUM_PROCESSES")
    if num_processes is not None:
        kw["num_processes"] = int(num_processes)
    process_id = process_id if process_id is not None else os.environ.get("JAX_PROCESS_ID")
    if process_id is not None:
        kw["process_id"] = int(process_id)
    jax.distributed.initialize(**kw)
    init_distributed._done = True
    return jax.process_index()


def make_mesh(axis_sizes: Dict[str, int], devices: Optional[Sequence] = None):
    import jax
    from jax.sharding import Mesh

    devices = list(devices if devices is not None else jax.devices())
    n = int(np.prod(list(axis_sizes.values())))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    arr = np.array(devices[:n]).reshape(tuple(axis_sizes.values()))
    return Mesh(arr, tuple(axis_sizes.keys()))


def default_mesh(n_devices: Optional[int] = None, db_shards: int = 1):
    import jax

    n = n_devices or len(jax.devices())
    if n % db_shards:
        raise ValueError(f"{n} devices not divisible by db_shards={db_shards}")
    return make_mesh({"dp": n // db_shards, "db": db_shards})
