"""ModelSet protocol: vectorized sets of density models.

Reference parity: ``beer/models/modelset.py`` (ModelSet, and the joint /
repeated composition variants).  Where the reference wraps Python lists of
model objects, a set here is a single model whose Bayesian parameters
carry a leading component axis — so mixtures and HMM emissions evaluate
every component with one (T, P) @ (P, K) contraction instead of a loop.

Contract (consumed by Mixture / HMM):

* ``sufficient_statistics(x)``      → (T, P) or (T, K, P) stats,
* ``expected_log_likelihood(stats)`` → (T, K) per-frame per-component,
* ``accumulate(stats, resps)``       → stats pytree, resps (T, K),
* ``__len__``                        → K.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax.numpy as jnp

from beer_tpu.models.basemodel import Model
from beer_tpu.utils import struct


@struct.dataclass
class ModelSet(Model):
    """Marker base class for vectorized model sets."""

    def __len__(self) -> int:
        raise NotImplementedError


@struct.dataclass
class JointModelSet(ModelSet):
    """Concatenation of model sets evaluated jointly on the same data.

    Reference parity: ``beer/models/modelset.py §JointModelSet`` — a set
    of K₁+K₂+… components drawn from heterogeneous-parameter sets (e.g.
    two NormalSets with different priors).  All member sets must consume
    the same sufficient-statistics layout; ELLH is the column-wise
    concatenation, accumulation splits the responsibilities back.
    """

    modelsets: Tuple[Any, ...]

    @classmethod
    def create(cls, modelsets) -> "JointModelSet":
        sets = tuple(modelsets)
        # All members score the SAME stats array (member 0's layout), so a
        # full-cov + diag-cov mix would be silently wrong — reject any
        # detectable layout mismatch up front.
        sigs = [
            (getattr(s, "cov_type", None), getattr(s, "dim", None))
            for s in sets
        ]
        known = {sig for sig in sigs if any(v is not None for v in sig)}
        if len(known) > 1:
            raise ValueError(
                "JointModelSet members must share one sufficient-statistics "
                f"layout; got (cov_type, dim) signatures {sorted(known)}"
            )
        return cls(modelsets=sets)

    def __len__(self) -> int:
        return sum(len(s) for s in self.modelsets)

    def sufficient_statistics(self, data: jnp.ndarray) -> jnp.ndarray:
        return self.modelsets[0].sufficient_statistics(data)

    def expected_log_likelihood(self, stats: jnp.ndarray) -> jnp.ndarray:
        return jnp.concatenate(
            [s.expected_log_likelihood(stats) for s in self.modelsets],
            axis=-1,
        )

    def infer(self, stats: jnp.ndarray):
        return self.expected_log_likelihood(stats), {}

    def accumulate(self, stats: jnp.ndarray, resps: jnp.ndarray) -> Dict[str, Any]:
        out, off = [], 0
        for s in self.modelsets:
            k = len(s)
            out.append(s.accumulate(stats, resps[..., off : off + k]))
            off += k
        return {"modelsets": tuple(out)}

    def kl_div_posterior_prior(self) -> jnp.ndarray:
        return sum(s.kl_div_posterior_prior() for s in self.modelsets)

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "JointModelSet":
        return self.replace(
            modelsets=tuple(
                s.vb_update(a, lrate)
                for s, a in zip(self.modelsets, acc["modelsets"])
            )
        )


@struct.dataclass
class RepeatedModelSet(ModelSet):
    """A base set of K components repeated R times (parameter sharing).

    Reference parity: ``beer/models/modelset.py §RepeatedModelSet`` —
    R·K virtual components backed by K real parameters (e.g. HMM states
    sharing one emission inventory).  ELLH tiles the base columns;
    accumulation *sums responsibilities across repeats* so every repeat's
    evidence updates the shared parameters.
    """

    modelset: Any
    repeats: int = struct.field(pytree_node=False, default=1)

    @classmethod
    def create(cls, modelset, repeats: int) -> "RepeatedModelSet":
        return cls(modelset=modelset, repeats=repeats)

    def __len__(self) -> int:
        return self.repeats * len(self.modelset)

    def sufficient_statistics(self, data: jnp.ndarray) -> jnp.ndarray:
        return self.modelset.sufficient_statistics(data)

    def expected_log_likelihood(self, stats: jnp.ndarray) -> jnp.ndarray:
        base = self.modelset.expected_log_likelihood(stats)   # (..., K)
        return jnp.tile(base, (1,) * (base.ndim - 1) + (self.repeats,))

    def infer(self, stats: jnp.ndarray):
        return self.expected_log_likelihood(stats), {}

    def accumulate(self, stats: jnp.ndarray, resps: jnp.ndarray) -> Dict[str, Any]:
        k = len(self.modelset)
        folded = resps.reshape(resps.shape[:-1] + (self.repeats, k)).sum(-2)
        return self.modelset.accumulate(stats, folded)

    def kl_div_posterior_prior(self) -> jnp.ndarray:
        return self.modelset.kl_div_posterior_prior()

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "RepeatedModelSet":
        return self.replace(modelset=self.modelset.vb_update(acc, lrate))
