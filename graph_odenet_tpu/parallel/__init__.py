"""Multi-device execution (SURVEY.md §2 T6/T7 — absent in the single-GPU
reference, mandated by BASELINE): edge-partitioned graph aggregation over a
``jax.sharding.Mesh`` with XLA collectives between the devices.

  mesh.py       — mesh construction + ``jax.distributed`` bootstrap
  partition.py  — receiver-block edge partitioning (each shard owns its
                  output rows), sender-block bucketing for overlap
  halo.py       — ``shard_map`` SpMM: all-gather halo exchange, and the
                  ppermute-pipelined variant that overlaps the ring with
                  local segment-sums

Parallelism vocabulary for this workload (SURVEY.md §2 T7): DP = batch of
graphs/simulations over the "data" axis; the TP/SP analogue is edge
partitioning over the "edge" axis.  PP/EP/CP don't map to 2-layer GNNs and
are documented as out of scope.
"""

from graph_odenet_tpu.parallel.mesh import make_mesh, bootstrap_distributed  # noqa: F401
from graph_odenet_tpu.parallel.partition import PartitionedGraph, partition_by_receiver  # noqa: F401
from graph_odenet_tpu.parallel.halo import spmm_sharded  # noqa: F401
from graph_odenet_tpu.parallel.sharded_gat import gat_sharded  # noqa: F401
