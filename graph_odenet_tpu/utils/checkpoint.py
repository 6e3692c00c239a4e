"""Checkpoint / resume (SURVEY.md §5): the reference at best calls
``torch.save(state_dict)`` at best-val; here step-numbered ``.npz`` files
with latest-step restore and deterministic resume.

Kept deliberately thin — a Checkpointer owns one directory and saves a
pytree (params + opt state + step + anything array-like) as one
``step_<n>.npz`` per step, each leaf under its tree path.  A file is
written to a temporary name and renamed into place, so a crash mid-save
leaves the previous checkpoints intact and no partial file under a step
name.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Optional

import jax
import numpy as np

__all__ = ["Checkpointer"]

_NAME = re.compile(r"^step_(\d+)\.npz$")


def _flatten(state):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(state)
    return [jax.tree_util.keystr(p) for p, _ in leaves], [l for _, l in leaves], treedef


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}.npz")

    def steps(self) -> list[int]:
        """Saved steps, oldest first."""
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` as step ``step`` and drop all but the newest
        ``max_to_keep`` steps."""
        paths, leaves, _ = _flatten(jax.device_get(state))
        arrays = {f"leaf_{i:06d}": np.asarray(l) for i, l in enumerate(leaves)}
        arrays["__paths__"] = np.asarray(paths, dtype=str)
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(step))
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        for old in self.steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """Restore ``step`` (default: latest) into the structure of
        ``state_like`` (a pytree with matching tree paths and shapes).
        Leaves come back as host numpy arrays."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        paths, likes, treedef = _flatten(state_like)
        with np.load(self._path(step)) as z:
            saved = {str(p): i for i, p in enumerate(z["__paths__"])}
            if set(saved) != set(paths):
                raise ValueError(
                    f"checkpoint step {step} has tree paths "
                    f"{sorted(set(saved) ^ set(paths))} that do not match"
                )
            leaves = []
            for p, like in zip(paths, likes):
                a = z[f"leaf_{saved[p]:06d}"]
                if a.shape != np.shape(like):
                    raise ValueError(
                        f"checkpoint leaf {p} has shape {a.shape}, "
                        f"expected {np.shape(like)}"
                    )
                leaves.append(a)
        return jax.tree_util.tree_unflatten(treedef, leaves)
