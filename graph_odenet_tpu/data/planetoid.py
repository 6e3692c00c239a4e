"""Planetoid citation networks — loader + synthetic twin.

Parity: reference ``load_data`` (SURVEY.md §2 R1): parse pygcn-format
``<name>.content`` (id, bag-of-words…, label) and ``<name>.cites`` (cited,
citing) files, build a symmetric self-looped row-normalised adjacency,
row-normalise features, fixed index splits (Cora: 140 train / 300 val /
1000 test starting at 500).

Deltas: features are padded to multiples of 128 and nodes to multiples
of 8, so downstream matmuls need no re-padding; the adjacency is a
static-shape ``Graph``.

``synthetic_planetoid`` generates a deterministic stochastic-block-model
citation graph with class-conditioned sparse bag-of-words features matching
each dataset's published statistics — the golden-fixture strategy of
SURVEY.md §4.3 for environments without the raw files.  A 2-layer GCN
reaches the same accuracy regime on it as on the real data, so end-to-end
training tests are meaningful.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from graph_odenet_tpu.graph import Graph, from_edges, to_dense

__all__ = ["NodeClassificationData", "load_planetoid", "synthetic_planetoid"]

# name → (n_nodes, n_features, n_classes, n_edges_directed) published stats.
_STATS = {
    "cora": (2708, 1433, 7, 5429),
    "citeseer": (3327, 3703, 6, 4732),
    "pubmed": (19717, 500, 3, 44338),
}

# pygcn split convention (SURVEY.md R1).
_SPLITS = {
    "cora": (range(140), range(200, 500), range(500, 1500)),
    "citeseer": (range(120), range(200, 500), range(500, 1500)),
    "pubmed": (range(60), range(200, 500), range(500, 1500)),
}


def _round_up(x, m):
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class NodeClassificationData:
    graph: Graph
    features: jax.Array      # f32[N_pad, F_pad] row-normalised
    labels: jax.Array        # i32[N_pad] (−1 on padding)
    idx_train: jax.Array
    idx_val: jax.Array
    idx_test: jax.Array
    n_class: int
    name: str = ""

    def dense_adj(self) -> jax.Array:
        return to_dense(self.graph)


def _finalize(
    name, features, labels, senders, receivers, n_class, splits=None
) -> NodeClassificationData:
    n = features.shape[0]
    graph = from_edges(
        senders, receivers, n_node=n,
        add_self_loops=True, symmetrize=True, normalize="row",
        node_multiple=128, edge_multiple=1024,
    )
    # Row-normalise features (reference `normalize(features)`).
    rowsum = features.sum(axis=1, keepdims=True)
    features = features / np.maximum(rowsum, 1e-12)
    n_pad = graph.n_node_pad
    f_pad = _round_up(features.shape[1], 128)
    feats = np.zeros((n_pad, f_pad), dtype=np.float32)
    feats[:n, : features.shape[1]] = features
    labs = np.full((n_pad,), -1, dtype=np.int32)
    labs[:n] = labels
    if splits is None:
        splits = _SPLITS[name]
    tr, va, te = (np.asarray(list(s), dtype=np.int32) for s in splits)
    return NodeClassificationData(
        graph=graph,
        features=jnp.asarray(feats),
        labels=jnp.asarray(labs),
        idx_train=jnp.asarray(tr),
        idx_val=jnp.asarray(va),
        idx_test=jnp.asarray(te),
        n_class=int(n_class),
        name=name,
    )


def load_planetoid(name: str, path: str) -> NodeClassificationData:
    """Parse pygcn-format ``<path>/<name>.content`` + ``<name>.cites``."""
    name = name.lower()
    content = np.genfromtxt(
        os.path.join(path, f"{name}.content"), dtype=np.dtype(str)
    )
    ids = content[:, 0]
    features = content[:, 1:-1].astype(np.float32)
    label_names = content[:, -1]
    classes = sorted(set(label_names))
    labels = np.array([classes.index(l) for l in label_names], dtype=np.int32)
    id_to_idx = {j: i for i, j in enumerate(ids)}
    cites = np.genfromtxt(
        os.path.join(path, f"{name}.cites"), dtype=np.dtype(str)
    )
    # Drop edges whose endpoints are outside the content file (citeseer has a
    # few dangling ids — reference behaviour is to skip them).
    keep = np.array([(a in id_to_idx and b in id_to_idx) for a, b in cites])
    cites = cites[keep]
    senders = np.array([id_to_idx[a] for a in cites[:, 0]], dtype=np.int64)
    receivers = np.array([id_to_idx[b] for b in cites[:, 1]], dtype=np.int64)
    return _finalize(name, features, labels, senders, receivers, len(classes))


#: Twin parameters calibrated (scripts/calibrate_twins.py) so BOTH
#: canonical recipes land near their published real-data test accuracies —
#: the 2-layer GCN (config-0 recipe: Kipf & Welling Cora .815, Citeseer
#: .703, Pubmed .790) AND the 8×8-head GAT (Veličković: .830/.725/.790) —
#: making ODE-vs-discrete accuracy comparisons on the twins falsifiable
#: instead of saturated (round-1 twins hit .988).  Round 4: recalibrated
#: jointly for GCN+GAT after the balanced 20-per-class train-split change
#: (the round-3 GAT rows ran 3–11 pts high because attention exploited
#: clean SBM block structure; heavier feature noise + higher homophily
#: closes the GAT–GCN gap to the published ~+1.5 pt).
CALIBRATED = {
    # measured (gcn, gat) twin acc near these knobs vs published targets:
    #   cora ~(.81, .83) / (.815, .830)   citeseer ~(.71, .72) / (.703, .725)
    #   pubmed ~(.80, .79) / (.790, .790)
    "cora": dict(homophily=0.82, class_vocab_frac=0.6, noise_words=46),
    "citeseer": dict(homophily=0.82, class_vocab_frac=0.6, noise_words=19),
    "pubmed": dict(homophily=0.7, class_vocab_frac=0.78, noise_words=27),
}


def synthetic_planetoid(
    name: str = "cora",
    *,
    seed: int = 0,
    scale: float = 1.0,
    homophily: float = 0.9,
    words_per_doc: int = 18,
    class_vocab_frac: float = 0.35,
    noise_words: int | None = None,
    calibrated: bool = False,
) -> NodeClassificationData:
    """Deterministic SBM citation graph with class-correlated features.

    Matches the named dataset's node/feature/class/edge counts (scaled by
    ``scale``); ``homophily`` is the fraction of intra-class edges (real
    citation graphs sit near 0.8–0.93); ``noise_words`` random extra words
    per doc (default ``words_per_doc // 4``).  ``calibrated=True`` swaps in
    the ``CALIBRATED`` difficulty (GCN ≈ published real-data accuracy).
    """
    name = name.lower()
    if calibrated:
        cal = CALIBRATED[name]
        homophily = cal["homophily"]
        class_vocab_frac = cal["class_vocab_frac"]
        noise_words = cal["noise_words"]
    if noise_words is None:
        noise_words = max(words_per_doc // 4, 1)
    n, f, c, e = _STATS[name]
    n, f, e = int(n * scale), int(f * scale) if scale < 1 else f, int(e * scale)
    # zlib.crc32, not hash(): Python string hashing is salted per process,
    # which would make the "deterministic" twin differ between runs.
    import zlib

    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 2**16)

    labels = rng.integers(0, c, size=n).astype(np.int32)
    # Balanced labelled set: the real planetoid splits hold exactly 20
    # training nodes per class (pygcn convention, SURVEY.md §2 R1), but
    # random twin labels make the per-class count over ``range(20·c)``
    # hypergeometric — seeds that draw 13–15 examples of some class score
    # far below published (the round-3 cora seed-2 0.665 outlier).  Force
    # the training range to exactly 20 per class like the real files.
    tr_n = min(20 * c, n)
    balanced = np.repeat(np.arange(c, dtype=np.int32), tr_n // c)
    labels[: len(balanced)] = rng.permutation(balanced)

    # Edges: homophilous pairs via per-class pools, rest uniform.
    n_intra = int(e * homophily)
    by_class = [np.nonzero(labels == k)[0] for k in range(c)]
    cls_of_edge = rng.integers(0, c, size=n_intra)
    s_list, r_list = [], []
    for k in range(c):
        pool = by_class[k]
        m = int((cls_of_edge == k).sum())
        if len(pool) >= 2 and m:
            s_list.append(rng.choice(pool, size=m))
            r_list.append(rng.choice(pool, size=m))
    n_inter = e - sum(len(s) for s in s_list)
    s_list.append(rng.integers(0, n, size=n_inter))
    r_list.append(rng.integers(0, n, size=n_inter))
    senders = np.concatenate(s_list)
    receivers = np.concatenate(r_list)
    ok = senders != receivers
    senders, receivers = senders[ok], receivers[ok]

    # Features: sparse bag-of-words; each class owns a soft topic over a
    # fraction of the vocabulary.
    vocab_per_class = max(int(f * class_vocab_frac), words_per_doc)
    topic_words = np.stack(
        [rng.permutation(f)[:vocab_per_class] for _ in range(c)]
    )
    features = np.zeros((n, f), dtype=np.float32)
    for i in range(n):
        own = rng.choice(topic_words[labels[i]], size=words_per_doc)
        noise = rng.integers(0, f, size=noise_words)
        features[i, own] = 1.0
        features[i, noise] = 1.0

    splits = _SPLITS[name]
    if scale != 1.0:
        tr = int(20 * c)
        va = min(300, max(50, n // 10))
        te = min(1000, n - tr - va)
        splits = (range(tr), range(tr, tr + va), range(n - te, n))
    return _finalize(
        f"{name}-synthetic", features, labels, senders, receivers, c, splits
    )
