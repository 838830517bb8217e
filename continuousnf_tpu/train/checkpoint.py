"""Parameter/optimizer-state checkpointing.

The reference's documented workflow serializes `(ps, st)` with JLD2
(`/root/reference/README.md:92-95`); here any pytree of arrays round-trips
through one `.npz` file holding its flattened leaves — params, optimizer
state, or both.  The `like` template passed to `load_checkpoint` fixes the
tree structure.
"""

from __future__ import annotations

import os
from typing import Any

import jax
import numpy as np


def save_checkpoint(path: str, pytree: Any) -> None:
    """Save the leaves of a pytree of arrays to `path` (an .npz file)."""
    leaves = jax.tree_util.tree_leaves(pytree)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, *[np.asarray(x) for x in leaves])
    os.replace(tmp, path)  # atomic publish


def load_checkpoint(path: str, like: Any) -> Any:
    """Load a pytree saved by :func:`save_checkpoint`.

    `like` is a template pytree with the target structure/shapes/dtypes
    (e.g. freshly initialized params).  Leaves come back as NumPy arrays.
    """
    like_leaves, treedef = jax.tree_util.tree_flatten(like)
    with np.load(path) as data:
        leaves = [data[f"arr_{i}"] for i in range(len(data.files))]
    if len(leaves) != len(like_leaves):
        raise ValueError(
            f"checkpoint {path!r} holds {len(leaves)} arrays; the template "
            f"has {len(like_leaves)} leaves"
        )
    for i, (got, want) in enumerate(zip(leaves, like_leaves)):
        if got.shape != np.shape(want):
            raise ValueError(
                f"checkpoint leaf {i} has shape {got.shape}; the template "
                f"expects {np.shape(want)}"
            )
    return jax.tree_util.tree_unflatten(
        treedef, [x.astype(np.asarray(w).dtype) for x, w in zip(leaves, like_leaves)]
    )


__all__ = ["save_checkpoint", "load_checkpoint"]
