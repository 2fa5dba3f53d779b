"""Model checkpointing.

Reference parity: the reference serializes models with ``torch.save``
pickles (``.mdl`` files) at creation and per training epoch, and the CLI
``train`` resumes from the latest epoch file (SURVEY.md §5.4).

A beer_tpu model is a pure pytree of arrays + static metadata, so a
checkpoint is an ``np.savez`` archive of the leaves next to a pickled
*skeleton* (the model with arrays stripped) that rebuilds the
structure.  Exact resume is trivial: the conjugate update is
deterministic given statistics.
"""

from __future__ import annotations

import io
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np


class _StrippedLeaf:
    """Skeleton placeholder for an array leaf (picklable sentinel).

    A dedicated class — NOT ``None`` — so optional model fields that are
    genuinely ``None`` (empty subtrees, e.g. ``PhoneLoop.log_exit``)
    survive the round trip instead of being miscounted as leaves.
    """


_LEAF = _StrippedLeaf()


def save_model(model, path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves, treedef = jax.tree.flatten(model)
    skeleton = jax.tree.unflatten(treedef, [_LEAF] * len(leaves))
    arrays = io.BytesIO()
    np.savez(arrays, *[np.asarray(leaf) for leaf in leaves])
    payload = {
        "skeleton": pickle.dumps(skeleton),
        "arrays": arrays.getvalue(),
    }
    with open(path, "wb") as fh:
        pickle.dump(payload, fh)


def load_model(path):
    with open(path, "rb") as fh:
        payload = pickle.load(fh)
    skeleton = pickle.loads(payload["skeleton"])
    leaves, treedef = jax.tree.flatten(
        skeleton, is_leaf=lambda x: isinstance(x, _StrippedLeaf)
    )
    with np.load(io.BytesIO(payload["arrays"])) as arrays:
        values = [arrays[f"arr_{i}"] for i in range(len(leaves))]
    return jax.tree.unflatten(treedef, [jnp.asarray(a) for a in values])


def latest_checkpoint(directory, pattern: str = "epoch*.mdl"):
    """Highest-numbered checkpoint in a directory, or None."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    ckpts = sorted(directory.glob(pattern))
    return ckpts[-1] if ckpts else None
