"""Multi-host bring-up (SURVEY.md P6, §5.8).

The comm stack is XLA collectives (NCCL between GPUs), reached through
jax.distributed + Mesh/NamedSharding.
Steady-state decode needs zero collectives (streams are independent);
this module covers the three places communication exists:
  (a) multi-host initialization,
  (b) result gather to host 0,
  (c) aggregate-metric all-reduce (the north-star realtime factor).
"""
from __future__ import annotations

import jax


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> int:
    """jax.distributed.initialize for multi-host pods; no-op single host.

    Returns the process index. Safe to call unconditionally in launchers:
    with no coordinator and a single process it does nothing.
    """
    if coordinator is None and num_processes in (None, 1):
        return 0
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.process_index()


def gather_to_host0(x):
    """Gather a stream-sharded array to host 0 (final PCM collection)."""
    from jax.experimental import multihost_utils
    return multihost_utils.process_allgather(x)


def allreduce_metric(value: float, mesh) -> float:
    """Aggregate a scalar metric (e.g. realtime factor) across the mesh."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    arr = jax.device_put(
        jnp.full((mesh.devices.size,), value / mesh.devices.size, jnp.float32),
        NamedSharding(mesh, P("streams")))
    return float(jnp.sum(arr))
