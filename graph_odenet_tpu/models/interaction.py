"""Interaction Networks (Battaglia et al. 2016) — discrete and ODE form.

Parity: reference ``InteractionNetwork`` / ``RelationModel`` / ``ObjectModel``
(SURVEY.md §2 R9) and the IN-ODE wrapper (R10).  The reference marshals
object states through dense one-hot incidence matmuls ``O·R_s`` / ``O·R_r``;
for the small fully-connected n-body graphs both that and a gather are
memory-trivial — we use gather + ``segment_sum`` so the exact same code
scales to large sparse relation sets, and ``vmap`` supplies the batch
dimension the reference gets from torch broadcasting.

Defaults follow the published IN sizes the reference uses (SURVEY.md R9):
relation MLP 4×150 → 50-dim effects, object MLP 100 hidden.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import jax
import jax.numpy as jnp

from graph_odenet_tpu.models.common import lecun
from graph_odenet_tpu.ode import odeint, odeint_adjoint
from graph_odenet_tpu.ops.segment import gather, segment_sum


@dataclasses.dataclass(frozen=True)
class MLP:
    """Dense stack: LeCun-normal kernels, zero biases, ``activation``
    between layers and none after the last."""

    hidden: Sequence[int]
    out: int
    activation: str = "relu"

    def init(self, key, x) -> list:
        sizes = [x.shape[-1], *self.hidden, self.out]
        keys = jax.random.split(key, len(sizes) - 1)
        return [
            {"kernel": lecun(k, (a, b)), "bias": jnp.zeros((b,), jnp.float32)}
            for k, a, b in zip(keys, sizes[:-1], sizes[1:])
        ]

    def apply(self, params, x):
        act = getattr(jax.nn, self.activation)
        for layer in params[:-1]:
            x = act(x @ layer["kernel"] + layer["bias"])
        return x @ params[-1]["kernel"] + params[-1]["bias"]


@dataclasses.dataclass(frozen=True)
class InteractionNetwork:
    """effects = φ_R([o_src ‖ o_dst ‖ r_attr]);  out = φ_O([o ‖ Σ effects ‖ ext]).

    ``apply(params, objs[N,Do], senders[E], receivers[E], rel_attr[E,Dr]?,
    ext[N,De]?) -> [N, out_dim]``.  Batch with ``jax.vmap`` over leading
    axes of ``objs``/``rel_attr``/``ext``.
    """

    out_dim: int
    effect_dim: int = 50
    relation_hidden: Sequence[int] = (150, 150, 150, 150)
    object_hidden: Sequence[int] = (100,)

    def _mlps(self):
        return (
            MLP(tuple(self.relation_hidden), self.effect_dim),
            MLP(tuple(self.object_hidden), self.out_dim),
        )

    def init(self, key, objs, senders, receivers, rel_attr=None, ext=None):
        del senders, receivers
        relation, obj = self._mlps()
        k_rel, k_obj = jax.random.split(key)
        d_obj = objs.shape[-1]
        d_rel = 2 * d_obj + (0 if rel_attr is None else rel_attr.shape[-1])
        d_in = d_obj + self.effect_dim + (0 if ext is None else ext.shape[-1])
        return {
            "relation": relation.init(k_rel, jnp.zeros((d_rel,))),
            "object": obj.init(k_obj, jnp.zeros((d_in,))),
        }

    def apply(self, params, objs, senders, receivers, rel_attr=None, ext=None):
        relation, obj = self._mlps()
        n = objs.shape[0]
        rel_in = [gather(objs, senders), gather(objs, receivers)]
        if rel_attr is not None:
            rel_in.append(rel_attr)
        effects = relation.apply(
            params["relation"], jnp.concatenate(rel_in, axis=-1)
        )
        agg = segment_sum(effects, receivers, num_segments=n, sorted_ids=False)
        obj_in = [objs, agg]
        if ext is not None:
            obj_in.append(ext)
        return obj.apply(params["object"], jnp.concatenate(obj_in, axis=-1))


@dataclasses.dataclass(frozen=True)
class INODE:
    """Interaction network as continuous dynamics (SURVEY.md §2 R10).

    State ``y = [N, 2D]`` is position ‖ velocity; the IN predicts
    acceleration from ``[static_attr ‖ pos ‖ vel]`` so the vector field is

        d pos/dt = vel,   d vel/dt = IN(...)

    ``apply(params, y0, ts, static_attr[N,Ds], senders, receivers)``
    integrates over ``ts`` and returns ``(trajectory [T, N, 2D], solver
    stats)`` — the reference's long-span ``odeint(IN_func, state_0,
    t_grid)`` rollout (§3.4).
    """

    dim: int = 2
    effect_dim: int = 50
    relation_hidden: Sequence[int] = (150, 150, 150, 150)
    object_hidden: Sequence[int] = (100,)
    method: str = "dopri5_scan"
    rtol: float = 1e-4
    atol: float = 1e-6
    steps: int = 16
    adjoint: Union[bool, str] = False  # False | True | "checkpoint"
    remat: bool = False         # rematerialise dynamics on backward: without
                                # it the solver scan stores every
                                # relation-MLP activation per step

    def _core(self):
        return InteractionNetwork(
            out_dim=self.dim,
            effect_dim=self.effect_dim,
            relation_hidden=self.relation_hidden,
            object_hidden=self.object_hidden,
        )

    def init(self, key, y0, ts, static_attr, senders, receivers, rel_attr=None):
        del ts
        objs = jnp.concatenate([static_attr, y0], axis=-1)
        return {
            "core": self._core().init(key, objs, senders, receivers, rel_attr)
        }

    def apply(self, params, y0, ts, static_attr, senders, receivers,
              rel_attr=None):
        core = self._core()
        D = self.dim

        def dynamics(t, y, p):
            del t
            pos, vel = y[..., :D], y[..., D:]
            objs = jnp.concatenate([static_attr, pos, vel], axis=-1)
            accel = core.apply(p, objs, senders, receivers, rel_attr)
            return jnp.concatenate([vel, accel], axis=-1)

        if self.remat:
            dynamics = jax.checkpoint(dynamics)
        kw = dict(
            method=self.method, rtol=self.rtol, atol=self.atol,
            steps_per_interval=self.steps, max_steps_per_interval=self.steps,
            return_stats=True,
        )
        if self.adjoint:
            return odeint_adjoint(
                dynamics, y0, ts, params["core"],
                checkpoint=self.adjoint == "checkpoint", **kw,
            )
        return odeint(dynamics, y0, ts, params["core"], **kw)
