"""Bayesian mixture model (GMM when the components are Normals).

Reference parity: ``beer/models/mixture.py`` (Mixture, Mixture.create)
and ``beer/models/mixtureset.py`` (MixtureSet) — see SURVEY.md §3.1 for
the reference VB-EM call stack this reproduces.

``expected_log_likelihood`` = logsumexp_k(component ELLH + E[log w]);
the responsibilities computed on the way are returned in the cache so
``accumulate`` never recomputes them.  The weight model is pluggable:
Dirichlet :class:`~beer_tpu.models.categorical.Categorical` (default) or
the stick-breaking :class:`~beer_tpu.models.categorical.SBCategorical`.
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp

from beer_tpu.models.basemodel import DiscreteLatentModel
from beer_tpu.models.categorical import Categorical
from beer_tpu.models.modelset import ModelSet
from beer_tpu.models.normal import NormalSet
from beer_tpu.utils import struct


@struct.dataclass
class Mixture(DiscreteLatentModel):
    """Mixture of any ModelSet with a Bayesian prior over the weights."""

    categorical: Any
    modelset: Any

    # ------------------------------------------------------------------
    @classmethod
    def create(
        cls,
        modelset: ModelSet,
        prior_strength: float = 1.0,
        weight_model: Any = None,
    ) -> "Mixture":
        if weight_model is None:
            dtype = jax.tree.leaves(modelset)[0].dtype
            weight_model = Categorical.create(len(modelset), prior_strength, dtype)
        return cls(categorical=weight_model, modelset=modelset)

    # ------------------------------------------------------------------
    def sufficient_statistics(self, data: jnp.ndarray) -> jnp.ndarray:
        return self.modelset.sufficient_statistics(data)

    def infer(self, stats: jnp.ndarray, mask: jnp.ndarray | None = None):
        per_comp = self.modelset.expected_log_likelihood(stats)  # (T, K)
        joint = per_comp + self.categorical.expected_log_weights()
        llh = jax.scipy.special.logsumexp(joint, axis=-1)
        resps = jnp.exp(joint - llh[..., None])
        if mask is not None:
            llh = llh * mask
            resps = resps * mask[..., None]
        return llh, {"resps": resps}

    def accumulate(self, stats: jnp.ndarray, cache: Dict[str, Any]) -> Dict[str, Any]:
        resps = cache["resps"]
        counts = resps.reshape(-1, resps.shape[-1]).sum(0)
        return {
            "categorical": self.categorical.accumulate_counts(counts),
            "modelset": self.modelset.accumulate(stats, resps),
        }

    def posteriors(self, data: jnp.ndarray) -> jnp.ndarray:
        """(T, K) responsibilities."""
        stats = self.sufficient_statistics(data)
        per_comp = self.modelset.expected_log_likelihood(stats)
        joint = per_comp + self.categorical.expected_log_weights()
        llh = jax.scipy.special.logsumexp(joint, axis=-1, keepdims=True)
        return jnp.exp(joint - llh)

    def kl_div_posterior_prior(self) -> jnp.ndarray:
        return (
            self.categorical.kl_div_posterior_prior()
            + self.modelset.kl_div_posterior_prior()
        )

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "Mixture":
        return self.replace(
            categorical=self.categorical.vb_update(acc["categorical"], lrate),
            modelset=self.modelset.vb_update(acc["modelset"], lrate),
        )

    def mean_field_factorization(self):
        """Two coordinate-ascent groups: weights, then emissions."""
        return [["categorical"], ["modelset"]]

    # -- convenience ---------------------------------------------------
    def weights(self) -> jnp.ndarray:
        return self.categorical.mean()


@struct.dataclass
class MixtureSet(ModelSet):
    """A set of S mixtures sharing structure (one GMM per HMM state).

    Reference parity: ``beer/models/mixtureset.py``.  The K components of
    every mixture live in one big NormalSet of size S·K; weights are a
    batched Dirichlet of shape (S, K).  ELLH of all S mixtures in one shot:
    logsumexp over each state's K components of (T, S·K) + E[log w].
    """

    weights: Any  # BayesianParameter with posterior (S, K)
    modelset: Any  # NormalSet with S*K components
    nmix: int = struct.field(pytree_node=False, default=1)
    ncomp_per_mix: int = struct.field(pytree_node=False, default=1)

    @classmethod
    def create(
        cls,
        modelset: NormalSet,
        nmix: int,
        prior_strength: float = 1.0,
    ) -> "MixtureSet":
        """Split a NormalSet of size S·K into S mixtures of K components."""
        from beer_tpu import dists
        from beer_tpu.models.parameters import BayesianParameter

        ncomp = len(modelset) // nmix
        fam = dists.Dirichlet(dim=ncomp)
        nat = fam.to_nat(jnp.full((nmix, ncomp), prior_strength))
        weights = BayesianParameter(prior=nat, posterior=nat, family=fam)
        return cls(
            weights=weights, modelset=modelset, nmix=nmix, ncomp_per_mix=ncomp
        )

    def __len__(self) -> int:
        return self.nmix

    def sufficient_statistics(self, data: jnp.ndarray) -> jnp.ndarray:
        return self.modelset.sufficient_statistics(data)

    def expected_log_likelihood(self, stats: jnp.ndarray) -> jnp.ndarray:
        """(T, S): each state's GMM marginal ELLH."""
        per_comp = self.modelset.expected_log_likelihood(stats)  # (T, S*K)
        per_comp = per_comp.reshape(*per_comp.shape[:-1], self.nmix, self.ncomp_per_mix)
        log_w = self.weights.expected_sufficient_statistics()  # (S, K)
        return jax.scipy.special.logsumexp(per_comp + log_w, axis=-1)

    def infer(self, stats: jnp.ndarray):
        return self.expected_log_likelihood(stats), {}

    def accumulate(self, stats: jnp.ndarray, resps: jnp.ndarray) -> Dict[str, Any]:
        """resps (T, S) state responsibilities → per-component stats."""
        per_comp = self.modelset.expected_log_likelihood(stats)
        per_comp = per_comp.reshape(*per_comp.shape[:-1], self.nmix, self.ncomp_per_mix)
        log_w = self.weights.expected_sufficient_statistics()
        joint = per_comp + log_w
        within = jax.nn.softmax(joint, axis=-1)  # (T, S, K)
        comp_resps = within * resps[..., None]
        flat = comp_resps.reshape(*comp_resps.shape[:-2], -1)  # (T, S*K)
        return {
            "weights": comp_resps.reshape(-1, self.nmix, self.ncomp_per_mix).sum(0),
            "modelset": self.modelset.accumulate(stats, flat),
        }

    def kl_div_posterior_prior(self) -> jnp.ndarray:
        return (
            self.weights.kl_div_posterior_prior()
            + self.modelset.kl_div_posterior_prior()
        )

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "MixtureSet":
        return self.replace(
            weights=self.weights.natural_update(acc["weights"], lrate),
            modelset=self.modelset.vb_update(acc["modelset"], lrate),
        )
