"""Device mesh construction and multi-host bootstrap.

The reference is single-process/single-GPU (SURVEY.md §1); its distributed
story is rebuilt here the JAX way: one ``Mesh`` with named axes, shardings
annotated with ``NamedSharding`` / ``shard_map``, collectives compiled by
XLA (which hands them to NCCL on GPUs) — no hand-written communication.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "bootstrap_distributed", "node_sharding", "replicated"]


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data", "edge"),
    devices=None,
) -> Mesh:
    """Build a mesh over all (or given) devices.

    Default layout puts every device on the "edge" (graph-partition) axis
    when no shape is given — the right default for one big graph; pass
    ``shape=(n_data, n_edge)`` for hybrid batch × graph parallelism.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (1, len(devices)) if len(axis_names) == 2 else (len(devices),)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    return Mesh(devices.reshape(shape), axis_names=tuple(axis_names))


def bootstrap_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """Multi-host init (SURVEY.md §5 distributed-comm row).  No-op when
    single-process; call once per host before building the mesh."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_count(), jax.process_index()


def node_sharding(mesh: Mesh, axis: str = "edge") -> NamedSharding:
    """Node arrays [N, F]: rows sharded over the edge-partition axis."""
    return NamedSharding(mesh, P(axis, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
