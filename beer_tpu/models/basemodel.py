"""Model protocol.

Reference parity: ``beer/models/basemodel.py`` (Model ABC,
DiscreteLatentModel).  The reference's three-method contract is kept —

* ``sufficient_statistics(data)``   data → stats array,
* ``expected_log_likelihood(stats)`` stats → per-frame log-likelihood,
* ``accumulate(stats, ...)``         stats (+ cache) → stats pytree,

— but models here are frozen **dataclass pytrees**
(:mod:`beer_tpu.utils.struct`), so a whole model jits, vmaps, shards,
and checkpoints as a value.  Training
state never hides inside the object: ``infer`` returns an explicit cache
(responsibilities / state posteriors) that ``accumulate`` consumes, and
``vb_update`` returns a *new* model.

Statistics pytrees are plain dicts mirroring each model's parameter
fields, so they ``jax.tree.map``-add across shards (the psum target of
the data-parallel E-step).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax.numpy as jnp

from beer_tpu.utils import struct


@struct.dataclass
class Model:
    """Base class; concrete models add BayesianParameter / sub-model fields."""

    # -- reference API --------------------------------------------------
    def sufficient_statistics(self, data: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError

    def expected_log_likelihood(self, stats: jnp.ndarray) -> jnp.ndarray:
        return self.infer(stats)[0]

    def accumulate(self, stats: jnp.ndarray, cache: Any) -> Dict[str, Any]:
        """Responsibility-weighted statistics for every Bayesian parameter."""
        raise NotImplementedError

    # -- functional core --------------------------------------------------
    def infer(self, stats: jnp.ndarray) -> Tuple[jnp.ndarray, Any]:
        """Per-frame expected log-likelihood + cache for ``accumulate``."""
        raise NotImplementedError

    def kl_div_posterior_prior(self) -> jnp.ndarray:
        """Total KL(q‖p) over all Bayesian parameters (scalar)."""
        raise NotImplementedError

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "Model":
        """Apply the conjugate natural-parameter step; returns a new model."""
        raise NotImplementedError

    def mean_field_factorization(self):
        """Groups of parameter field names updated jointly (reference API).

        The default single group matches the reference's common case; the
        functional ``vb_update`` applies to all groups at once, which is
        valid VB-EM for the q(z)·Π q(θ_j) factorizations used here.
        """
        return [list(self.__dataclass_fields__)]


@struct.dataclass
class DiscreteLatentModel(Model):
    """Models with a discrete latent (mixtures, HMMs): adds ``posteriors``."""

    def posteriors(self, data: jnp.ndarray) -> jnp.ndarray:
        """Posterior responsibilities of the discrete latent per frame."""
        stats = self.sufficient_statistics(data)
        return self.infer(stats)[1]["resps"]
