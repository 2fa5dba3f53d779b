"""Categorical with Dirichlet prior and stick-breaking (truncated-DP) variant.

Reference parity: ``beer/models/categorical.py`` (Categorical,
SBCategorical, SBCategoricalHyperPrior).  The SBCategorical is the prior
over acoustic units in phone-loop AUD: a truncated stick-breaking process
v_i ~ Beta(1, γ), π_i = v_i Π_{j<i}(1−v_j), whose conjugate posterior
update takes per-unit occupancy counts and their reversed cumulative sums.

Both classes expose the small "weight model" protocol Mixture / PhoneLoop
consume: ``expected_log_weights()``, ``accumulate_counts(counts)``,
``vb_update(acc)``, ``kl_div_posterior_prior()``.
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp

from beer_tpu import dists
from beer_tpu.models.basemodel import Model
from beer_tpu.models.parameters import BayesianParameter
from beer_tpu.utils import struct


@struct.dataclass
class Categorical(Model):
    """Categorical likelihood with a Dirichlet prior over the weights."""

    weights: BayesianParameter
    ncat: int = struct.field(pytree_node=False, default=2)

    @classmethod
    def create(cls, ncat: int, prior_strength: float = 1.0, dtype=jnp.float32):
        fam = dists.Dirichlet(dim=ncat)
        nat = fam.to_nat(jnp.full(ncat, prior_strength, dtype))
        param = BayesianParameter(prior=nat, posterior=nat, family=fam)
        return cls(weights=param, ncat=ncat)

    # -- weight-model protocol -----------------------------------------
    def expected_log_weights(self) -> jnp.ndarray:
        """E[log π], shape (K,)."""
        return self.weights.expected_sufficient_statistics()

    def accumulate_counts(self, counts: jnp.ndarray) -> Dict[str, Any]:
        return {"weights": counts}

    # -- Model API -------------------------------------------------------
    def sufficient_statistics(self, data: jnp.ndarray) -> jnp.ndarray:
        """Integer class ids (T,) → one-hot (T, K)."""
        if data.ndim >= 1 and jnp.issubdtype(data.dtype, jnp.integer):
            return jax.nn.one_hot(data, self.ncat)
        return data

    def infer(self, stats: jnp.ndarray):
        llh = stats @ self.expected_log_weights()
        return llh, {"counts": stats.sum(0)}

    def accumulate(self, stats: jnp.ndarray, cache=None) -> Dict[str, Any]:
        counts = cache["counts"] if cache else stats.sum(0)
        return self.accumulate_counts(counts)

    def kl_div_posterior_prior(self) -> jnp.ndarray:
        return self.weights.kl_div_posterior_prior()

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "Categorical":
        return self.replace(weights=self.weights.natural_update(acc["weights"], lrate))

    def mean(self) -> jnp.ndarray:
        """Posterior expected weights."""
        alpha = self.weights.family.to_std(self.weights.posterior)
        return alpha / alpha.sum(-1, keepdims=True)


@struct.dataclass
class SBCategorical(Model):
    """Truncated stick-breaking (Dirichlet-process) categorical.

    ``sticks`` holds K−1 Beta posteriors as a batched 2-dim Dirichlet
    parameter of shape (K−1, 2).  Weight k uses sticks 0..k:
    E[log π_k] = E[log v_k] + Σ_{j<k} E[log(1−v_j)]   (v_{K−1} ≡ 1).
    """

    sticks: BayesianParameter
    truncation: int = struct.field(pytree_node=False, default=2)

    @classmethod
    def create(cls, truncation: int, concentration: float = 1.0, dtype=jnp.float32):
        fam = dists.Beta()
        alpha = jnp.stack(
            [
                jnp.ones(truncation - 1, dtype),
                jnp.full(truncation - 1, concentration, dtype),
            ],
            axis=-1,
        )
        nat = fam.to_nat(alpha)
        param = BayesianParameter(prior=nat, posterior=nat, family=fam)
        return cls(sticks=param, truncation=truncation)

    # -- weight-model protocol -----------------------------------------
    def expected_log_weights(self) -> jnp.ndarray:
        e = self.sticks.expected_sufficient_statistics()  # (K-1, 2)
        e_log_v, e_log_1mv = e[..., 0], e[..., 1]
        tail = jnp.concatenate([jnp.zeros_like(e_log_1mv[:1]), jnp.cumsum(e_log_1mv)])
        head = jnp.concatenate([e_log_v, jnp.zeros_like(e_log_v[:1])])
        return head + tail

    def accumulate_counts(self, counts: jnp.ndarray) -> Dict[str, Any]:
        """counts (K,) → per-stick Beta statistics (K−1, 2).

        Stick i sees [c_i, Σ_{j>i} c_j] — its own occupancy vs everything
        broken off after it.
        """
        rev_tail = jnp.cumsum(counts[::-1])[::-1]  # tail sums including self
        stick_stats = jnp.stack([counts[:-1], rev_tail[1:]], axis=-1)
        return {"sticks": stick_stats}

    # -- Model API -------------------------------------------------------
    def sufficient_statistics(self, data: jnp.ndarray) -> jnp.ndarray:
        return jax.nn.one_hot(data, self.truncation)

    def infer(self, stats: jnp.ndarray):
        llh = stats @ self.expected_log_weights()
        return llh, {"counts": stats.sum(0)}

    def accumulate(self, stats: jnp.ndarray, cache=None) -> Dict[str, Any]:
        counts = cache["counts"] if cache else stats.sum(0)
        return self.accumulate_counts(counts)

    def kl_div_posterior_prior(self) -> jnp.ndarray:
        return self.sticks.kl_div_posterior_prior()

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "SBCategorical":
        return self.replace(sticks=self.sticks.natural_update(acc["sticks"], lrate))

    def mean(self) -> jnp.ndarray:
        alpha = self.sticks.family.to_std(self.sticks.posterior)  # (K-1, 2)
        e_v = alpha[..., 0] / alpha.sum(-1)
        rest = jnp.concatenate([jnp.ones_like(e_v[:1]), jnp.cumprod(1.0 - e_v)])
        return jnp.concatenate([e_v, jnp.ones_like(e_v[:1])]) * rest



@struct.dataclass
class SBCategoricalHyperPrior(Model):
    """Stick-breaking categorical with a Gamma hyper-prior on γ.

    Reference parity: ``beer/models/categorical.py`` SBCategoricalHyperPrior.
    v_i ~ Beta(1, γ), γ ~ Gamma(a₀, b₀).  Mean-field q(v) q(γ):

    * sticks update against the *expected* prior η̄_p = [0, E[γ] − 1]
      (exact: E_γ[A_Beta(1, γ)] = −E[log γ], so the ELBO stays closed
      form),
    * γ's conjugate statistics per stick are [E[log(1−v_i)], 1].
    """

    sticks: BayesianParameter
    concentration: BayesianParameter
    truncation: int = struct.field(pytree_node=False, default=2)

    @classmethod
    def create(
        cls,
        truncation: int,
        prior_shape: float = 1.0,
        prior_rate: float = 1.0,
        dtype=jnp.float32,
    ):
        beta_fam = dists.Beta()
        gamma_fam = dists.Gamma()
        g_nat = gamma_fam.to_nat(
            jnp.asarray(prior_shape, dtype), jnp.asarray(prior_rate, dtype)
        )
        conc = BayesianParameter(prior=g_nat, posterior=g_nat, family=gamma_fam)
        e_gamma = prior_shape / prior_rate
        alpha = jnp.stack(
            [jnp.ones(truncation - 1, dtype),
             jnp.full(truncation - 1, e_gamma, dtype)],
            axis=-1,
        )
        nat = beta_fam.to_nat(alpha)
        sticks = BayesianParameter(prior=nat, posterior=nat, family=beta_fam)
        return cls(sticks=sticks, concentration=conc, truncation=truncation)

    def _e_gamma(self):
        e = self.concentration.expected_sufficient_statistics()
        return e[..., 0], e[..., 1]  # E[γ], E[log γ]

    def _expected_prior_nat(self):
        e_gamma, _ = self._e_gamma()
        zeros = jnp.zeros(self.truncation - 1, e_gamma.dtype)
        return jnp.stack([zeros, jnp.full_like(zeros, e_gamma - 1.0)], axis=-1)

    # -- weight-model protocol -----------------------------------------
    def expected_log_weights(self) -> jnp.ndarray:
        e = self.sticks.expected_sufficient_statistics()
        e_log_v, e_log_1mv = e[..., 0], e[..., 1]
        tail = jnp.concatenate([jnp.zeros_like(e_log_1mv[:1]), jnp.cumsum(e_log_1mv)])
        head = jnp.concatenate([e_log_v, jnp.zeros_like(e_log_v[:1])])
        return head + tail

    def accumulate_counts(self, counts: jnp.ndarray) -> Dict[str, Any]:
        rev_tail = jnp.cumsum(counts[::-1])[::-1]
        return {"sticks": jnp.stack([counts[:-1], rev_tail[1:]], axis=-1)}

    # -- Model API -------------------------------------------------------
    def sufficient_statistics(self, data: jnp.ndarray) -> jnp.ndarray:
        return jax.nn.one_hot(data, self.truncation)

    def infer(self, stats: jnp.ndarray):
        llh = stats @ self.expected_log_weights()
        return llh, {"counts": stats.sum(0)}

    def accumulate(self, stats: jnp.ndarray, cache=None) -> Dict[str, Any]:
        counts = cache["counts"] if cache else stats.sum(0)
        return self.accumulate_counts(counts)

    def kl_div_posterior_prior(self) -> jnp.ndarray:
        fam = self.sticks.family
        nat_q = self.sticks.posterior
        nat_p = self._expected_prior_nat()
        grad_q = fam.expected_sufficient_statistics(nat_q)
        _, e_log_gamma = self._e_gamma()
        kl_sticks = (
            ((nat_q - nat_p) * grad_q).sum(-1)
            - fam.log_norm(nat_q)
            - e_log_gamma  # = E_γ[−A_Beta(1, γ)], exact
        ).sum()
        return kl_sticks + self.concentration.kl_div_posterior_prior()

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0):
        # sticks against the expected prior
        target = self._expected_prior_nat() + acc["sticks"]
        new_sticks_nat = self.sticks.posterior + lrate * (
            target - self.sticks.posterior
        )
        sticks = self.sticks.replace(posterior=new_sticks_nat)
        # γ from the new stick posteriors: stats = [Σ E log(1−v_i), K−1]
        e = sticks.expected_sufficient_statistics()
        g_stats = jnp.stack([e[..., 1].sum(), jnp.asarray(
            float(self.truncation - 1), e.dtype)])
        conc = self.concentration.natural_update(g_stats, lrate)
        return self.replace(sticks=sticks, concentration=conc)

    def mean(self) -> jnp.ndarray:
        alpha = self.sticks.family.to_std(self.sticks.posterior)
        e_v = alpha[..., 0] / alpha.sum(-1)
        rest = jnp.concatenate([jnp.ones_like(e_v[:1]), jnp.cumprod(1.0 - e_v)])
        return jnp.concatenate([e_v, jnp.ones_like(e_v[:1])]) * rest
