"""Sparse aggregation ops: the replacement for the reference's
``torch.spmm`` / ``torch.sparse.mm`` / ``scatter_add`` usage (SURVEY.md §2 T5).

  * ``segment.py``  — gather + ``segment_sum``/``segment_softmax``
    (reference semantics; XLA lowers them to gathers and scatter-adds);
  * ``spmm.py``     — ``spmm(adj, x)`` over a sparse ``Graph`` or a dense Â;
  * ``sddmm.py``    — per-edge score computation (GAT attention logits) and
    the SDDMM→softmax→SpMM sandwich;
  * ``dropmask.py`` — counter-based attention-dropout masks.
"""

from graph_odenet_tpu.ops.segment import (  # noqa: F401
    gather,
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
)
from graph_odenet_tpu.ops.spmm import spmm  # noqa: F401
from graph_odenet_tpu.ops.sddmm import edge_scores, attention_aggregate  # noqa: F401
