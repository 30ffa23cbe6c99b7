"""State checkpoint/resume.

The reference's only persistent state is model.x plus solver caches
(SURVEY.md section 5); here the scan engine's carry (state, warm starts,
extrapolation origins) is an explicit pytree, so checkpointing is a plain
save/load of arrays.
"""

from __future__ import annotations

import numpy as np

__all__ = ["save_state", "load_state"]


def save_state(path: str, state: dict) -> None:
    """Save a runner state pytree (dict of arrays) to an .npz file."""
    flat = {}

    def walk(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(f"{prefix}{k}/", v)
        elif hasattr(obj, "_fields"):  # NamedTuple (WarmStart) before tuple
            for k in obj._fields:
                walk(f"{prefix}{k}/", getattr(obj, k))
        elif isinstance(obj, (tuple, list)):
            for i, v in enumerate(obj):
                walk(f"{prefix}{i}/", v)
        else:
            flat[prefix.rstrip("/")] = np.asarray(obj)

    walk("", state)
    np.savez(path, **flat)


def load_state(path: str, like: dict) -> dict:
    """Load a state saved by :func:`save_state`, shaped like ``like``
    (a freshly created initial_state)."""
    data = np.load(path if str(path).endswith(".npz") else path + ".npz")

    def walk(prefix, obj):
        if isinstance(obj, dict):
            return {k: walk(f"{prefix}{k}/", v) for k, v in obj.items()}
        if isinstance(obj, tuple) and hasattr(obj, "_fields"):
            return type(obj)(**{k: walk(f"{prefix}{k}/", getattr(obj, k))
                                for k in obj._fields})
        if isinstance(obj, (tuple, list)):
            vals = [walk(f"{prefix}{i}/", v) for i, v in enumerate(obj)]
            return tuple(vals) if isinstance(obj, tuple) else vals
        return data[prefix.rstrip("/")]

    return walk("", like)
