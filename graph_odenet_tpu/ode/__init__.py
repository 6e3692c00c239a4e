"""Jittable ODE solvers — the on-device replacement for torchdiffeq.

Capability parity (SURVEY.md §2 T1–T4):
  * ``api.odeint``          ↔ ``torchdiffeq.odeint`` — method dispatch,
    shape/dtype handling, solution at every requested time point.
  * ``fixed.py``            ↔ ``FixedGridODESolver`` (euler/midpoint/rk4) —
    here a single ``lax.scan`` over the step grid, whole trajectory
    on-device.
  * ``adaptive.py``         ↔ ``Dopri5Solver`` — Dormand–Prince 5(4) with
    FSAL, Hairer initial-step selection, PI step-size controller, 4th-order
    dense output, NFE counting — all inside ``lax.while_loop`` (the
    reference runs this loop in host Python, syncing per step).
  * ``adjoint.py``          ↔ ``OdeintAdjointMethod`` — O(1)-memory backward
    via the augmented reverse ODE, as a ``jax.custom_vjp``.
"""

from graph_odenet_tpu.ode.api import odeint, odeint_adjoint  # noqa: F401
from graph_odenet_tpu.ode.api import SOLVERS  # noqa: F401
