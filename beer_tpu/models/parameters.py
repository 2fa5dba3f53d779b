"""Bayesian parameters: (prior, posterior) conjugate pairs.

Reference parity: ``beer/models/parameters.py`` (BayesianParameter,
ConjugateBayesianParameter, BayesianParameterSet).

The reference harvests accumulated statistics through autograd hooks fired
by ``ELBO.backward()``.  Here a parameter is a frozen pytree; statistics
are explicit arrays living in the *same flat natural-parameter space* as
the prior (see ``beer_tpu/dists``), and the natural-gradient coordinate
ascent step is pure arithmetic:

    posterior ← posterior + lr · (prior + stats − posterior)

which at lr=1 is the textbook closed-form VB-EM M-step.
"""

from __future__ import annotations

import jax.numpy as jnp

from beer_tpu.dists.basedist import ExpFamily
from beer_tpu.utils import struct


@struct.dataclass
class BayesianParameter:
    """A conjugate (prior, posterior) pair over one exponential family.

    ``prior`` / ``posterior`` are flat natural-parameter arrays of shape
    ``(..., P)``; leading axes batch a *set* of parameters (the
    BayesianParameterSet of the reference is just a leading axis here —
    vectorization instead of object lists).
    """

    prior: jnp.ndarray
    posterior: jnp.ndarray
    family: ExpFamily = struct.field(pytree_node=False)

    # -- expectations -------------------------------------------------
    def expected_sufficient_statistics(self) -> jnp.ndarray:
        """E_q[T(θ)] = ∇A(η_post), shape (..., P)."""
        return self.family.expected_sufficient_statistics(self.posterior)

    def expected_natural_parameters(self) -> jnp.ndarray:
        """Reference-API alias for :meth:`expected_sufficient_statistics`."""
        return self.expected_sufficient_statistics()

    # -- ELBO pieces ---------------------------------------------------
    def kl_div_posterior_prior(self) -> jnp.ndarray:
        """Σ KL(q(θ)‖p(θ)) over the whole parameter set (scalar)."""
        return self.family.kl_div(self.posterior, self.prior).sum()

    # -- M-step ---------------------------------------------------------
    def natural_update(self, stats: jnp.ndarray, lrate: float = 1.0):
        """Natural-gradient coordinate-ascent step (stats already scaled)."""
        new_post = self.posterior + lrate * (self.prior + stats - self.posterior)
        return self.replace(posterior=new_post)

    def zero_stats(self) -> jnp.ndarray:
        """A zero statistics array matching this parameter."""
        return jnp.zeros_like(self.posterior)
