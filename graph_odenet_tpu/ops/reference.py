"""Plain float64 references for the aggregation ops, in numpy and scipy.

They share no code with the ops they check: the CPU tests compare
``ops.spmm_segment`` and ``ops.attention_aggregate`` with them at small
sizes, and ``chip_smoke.py`` does the same on the GPU at ogbn-arxiv size.
Each takes a ``Graph`` only for its edge arrays; padding edges are ignored.

  * :func:`spmm_reference` / :func:`spmm_vjp_reference` — ``Â x`` and
    ``Âᵀ g`` through ``scipy.sparse``.
  * :func:`dropmask_reference` — the counter-based attention-dropout hash
    of ``ops.dropmask``, written again with numpy's wrapping ``uint32``.
  * :func:`attention_reference` / :func:`attention_vjp_reference` — the
    per-receiver softmax, the optional post-softmax dropout scale and the
    weighted value sum, and their vector-Jacobian product.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = [
    "rel_err", "spmm_reference", "spmm_vjp_reference",
    "dropmask_reference", "attention_reference", "attention_vjp_reference",
]


def rel_err(got, ref) -> float:
    """``max|got − ref| / max|ref|``."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300))


def _real_edges(g):
    e = g.n_edge
    return (
        np.asarray(g.senders)[:e].astype(np.int64),
        np.asarray(g.receivers)[:e].astype(np.int64),
        np.asarray(g.weight)[:e].astype(np.float64),
    )


def _adjacency(g, values=None):
    """``[n_node_pad, n_node_pad]`` CSR matrix, row = receiver."""
    s, r, w = _real_edges(g)
    w = w if values is None else values
    n = g.n_node_pad
    return sp.csr_matrix((w, (r, s)), shape=(n, n))


def spmm_reference(g, x) -> np.ndarray:
    """``Â x`` in float64."""
    return _adjacency(g) @ np.asarray(x, np.float64)


def spmm_vjp_reference(g, cot) -> np.ndarray:
    """``Âᵀ cot``: the gradient of ``⟨Â x, cot⟩`` with respect to ``x``."""
    return _adjacency(g).T @ np.asarray(cot, np.float64)


# ops.dropmask's constants: murmur3's fmix32 and three odd key multipliers.
_K_SND, _K_RCV, _K_HEAD = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
_F1, _F2 = 0x7FEB352D, 0x846CA68B


def dropmask_reference(seed: int, senders, receivers, heads: int,
                       rate: float) -> np.ndarray:
    """``[E, H]`` float64 post-softmax scale: ``1/(1-rate)`` kept, 0 dropped."""
    u32 = np.uint32
    s = np.asarray(senders).astype(u32) * u32(_K_SND)
    r = np.asarray(receivers).astype(u32) * u32(_K_RCV)
    h = np.arange(heads, dtype=u32) * u32(_K_HEAD)
    x = (s ^ r)[:, None] ^ h[None, :] ^ u32(seed)
    x ^= x >> u32(16)
    x *= u32(_F1)
    x ^= x >> u32(15)
    x *= u32(_F2)
    x ^= x >> u32(16)
    threshold = u32(int(round((1.0 - rate) * (1 << 24))))
    return ((x >> u32(8)) < threshold).astype(np.float64) / (1.0 - rate)


def _softmax(g, logits):
    """Per-receiver softmax over the real edges: ``[E, H]`` float64."""
    _, r, _ = _real_edges(g)
    lg = np.asarray(logits, np.float64)[: g.n_edge]
    # Real edges are receiver-sorted: segments are contiguous runs.
    starts = np.flatnonzero(np.r_[True, r[1:] != r[:-1]])
    seg = np.repeat(np.arange(starts.size), np.diff(np.r_[starts, r.size]))
    m = np.maximum.reduceat(lg, starts, axis=0)
    p = np.exp(lg - m[seg])
    return p / np.add.reduceat(p, starts, axis=0)[seg]


def _heads_of(values):
    v = np.asarray(values, np.float64)
    return v, v.shape[1]


def attention_reference(g, logits, values, drop_scale=None) -> np.ndarray:
    """``out[r, h] = Σ_{e→r} α[e, h]·d[e, h]·values[s_e, h]`` in float64.

    ``drop_scale``: optional ``[E, H]`` post-softmax scale over the real
    edges (:func:`dropmask_reference`).
    """
    v, heads = _heads_of(values)
    a = _softmax(g, logits)
    if drop_scale is not None:
        a = a * drop_scale
    out = np.zeros_like(v)
    for h in range(heads):
        out[:, h, :] = _adjacency(g, a[:, h]) @ v[:, h, :]
    return out


def attention_vjp_reference(g, logits, values, cot, drop_scale=None,
                            chunk: int = 1 << 18):
    """Gradients of ``⟨attention_reference(...), cot⟩``.

    Returns ``(dlogits [E_pad, H], dvalues [N_pad, H, F])``; padding edges
    get zero.  With ``α̃ = α·d``: ``dvalues[s] = Σ_{e: s_e=s} α̃_e·cot[r_e]``,
    ``dα_e = d_e·⟨cot[r_e], values[s_e]⟩`` and the softmax backward
    ``dlogits_e = α_e·(dα_e − Σ_{e'→r_e} α_e'·dα_e')``.
    """
    s, r, _ = _real_edges(g)
    v, heads = _heads_of(values)
    c = np.asarray(cot, np.float64)
    a = _softmax(g, logits)
    d = np.ones_like(a) if drop_scale is None else drop_scale
    dvalues = np.zeros_like(v)
    da = np.empty_like(a)
    for h in range(heads):
        dvalues[:, h, :] = _adjacency(g, a[:, h] * d[:, h]).T @ c[:, h, :]
        for lo in range(0, s.size, chunk):
            hi = lo + chunk
            da[lo:hi, h] = np.einsum(
                "ef,ef->e", c[r[lo:hi], h], v[s[lo:hi], h]
            )
    da *= d
    starts = np.flatnonzero(np.r_[True, r[1:] != r[:-1]])
    seg = np.repeat(np.arange(starts.size), np.diff(np.r_[starts, r.size]))
    mean = np.add.reduceat(a * da, starts, axis=0)[seg]
    dlogits = np.zeros((np.asarray(logits).shape[0], heads))
    dlogits[: g.n_edge] = a * (da - mean)
    return dlogits, dvalues
