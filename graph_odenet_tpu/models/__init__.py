"""Model zoo — capability parity with the reference's ``models.py`` and
physics models (SURVEY.md §2 R5/R6/R9/R10):

  discrete:   GCN, GAT (multi-head), residual variants (ResGCN / ResGAT —
              the paper's discrete h ← h + f(h) baseline)
  continuous: ODEBlock + GCNODE / GATODE (dh/dt = gnn(h), integrated with
              any solver from ``graph_odenet_tpu.ode``)
  physics:    InteractionNetwork (Battaglia et al. 2016) and its ODE form.

Every model is a frozen dataclass of hyperparameters over static-shape
``Graph`` pytrees (or a dense Â), with two methods:

  init(key, *inputs) -> params              a plain dict of float32 arrays
  apply(params, *inputs, deterministic=True, rng=None) -> (out, stats)

``stats`` is the ODE solver's statistics (``nfe`` …) for the continuous
models and ``{}`` for the discrete ones.  Layers (``GCNLayer``, ``GATLayer``,
``MLP``, ``InteractionNetwork``) return their output alone.
"""

from graph_odenet_tpu.models.gcn import GCN, GCNLayer, ResGCN  # noqa: F401
from graph_odenet_tpu.models.gat import GAT, GATLayer, ResGAT  # noqa: F401
from graph_odenet_tpu.models.odeblock import ODEBlock, GCNODE, GATODE  # noqa: F401
from graph_odenet_tpu.models.interaction import (  # noqa: F401
    InteractionNetwork,
    INODE,
)
