"""graph_odenet_tpu — a graph-ODE framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
``phcavelar/graph-odenet`` (companion code to arXiv:1911.09554, "Discrete and
Continuous Deep Residual Learning Over Graphs"): message-passing layers
(GCN / GAT / interaction networks) expressed as sparse gather/scatter,
wrapped as continuous dynamics ``dh/dt = f(h, t)`` and
integrated with jittable fixed-step (euler/midpoint/rk4) and adaptive
(dopri5, PI step-size control) solvers that keep the whole trajectory
on-device under ``lax.scan`` / ``lax.while_loop``.

Design notes (vs. the torch reference, see SURVEY.md):
  * the reference drives its solver loop from host Python
    (torchdiffeq ``Dopri5Solver.integrate``), syncing a scalar per
    accept/reject step; here the entire integration is a single XLA program.
  * neighborhood aggregation is ``segment_sum`` / SpMM instead of
    ``torch.spmm`` / ``scatter_add``.
  * multi-device scaling is edge-partitioning over a ``jax.sharding.Mesh``
    with XLA collectives, not NCCL.

Public surface (mirrors the reference's capability inventory, SURVEY.md §2):

  graph            Graph container: COO edges, normalisation, padding.
  ops              segment_sum/softmax aggregation, SpMM, SDDMM.
  ode              odeint / odeint_adjoint, fixed + adaptive solvers.
  models           GCN, GAT, residual + ODE variants, interaction networks.
  parallel         Mesh construction, edge partitioning, halo exchange.
  data             Planetoid (Cora/Citeseer/Pubmed) loader, n-body simulator.
  train            Full-batch node-classification and physics trainers.
"""

__version__ = "0.1.0"

from graph_odenet_tpu.graph import Graph  # noqa: F401
from graph_odenet_tpu.ode.api import odeint, odeint_adjoint  # noqa: F401
