"""Exponential-family core.

Reference parity: ``beer/dists/basedist.py`` (ExponentialFamily,
ConjugateLikelihood, kl_div) — reimagined for JAX.  Instead of parameter
"bags" with hand-written expectations, every family here is a *static,
hashable descriptor* (safe to close over under ``jit``) operating on flat
natural-parameter arrays of shape ``(..., P)``:

* ``log_norm(nat)``        — the log-partition A(η), batch-aware,
* ``expected_sufficient_statistics(nat)`` — E[T(θ)] = ∇A(η), obtained with
  ``jax.grad`` (exact: digamma/solve/logdet rules all exist in XLA),
* ``kl_div(nat_q, nat_p)`` — Bregman divergence of A:
  KL(q‖p) = (η_q − η_p)·∇A(η_q) − A(η_q) + A(η_p).

Conjugacy convention (uniform across the library): for a likelihood
``log p(x|θ) = ⟨s(x), T(θ)⟩ + log h(x)`` the *data-side* statistics ``s(x)``
live in the same P-dimensional space as the prior's natural parameters, so

* the VB M-step is plain addition:  ``η_post = η_prior + Σ_t r_t s(x_t)``,
* the expected log-likelihood is one matmul: ``s(X) @ E[T(θ)].T``.

This makes every hot path a dense matrix contraction by construction.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class ExpFamily:
    """Base class for exponential-family descriptors.

    Subclasses are small frozen dataclasses (hence hashable → usable as
    static pytree metadata) that define:

    * ``nat_dim``   — P, the length of the flat natural-parameter vector,
    * ``log_norm``  — A(η) for ``nat`` of shape ``(..., P)`` → ``(...)``.
    """

    @property
    def nat_dim(self) -> int:
        raise NotImplementedError

    def log_norm(self, nat: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError

    # ------------------------------------------------------------------
    # Generic machinery (exact for every family).
    # ------------------------------------------------------------------
    def expected_sufficient_statistics(self, nat: jnp.ndarray) -> jnp.ndarray:
        """E[T(θ)] = ∇_η A(η), for batched ``nat`` of shape (..., P).

        ``log_norm`` maps each batch element independently, so the gradient
        of the *sum* over the batch is the per-element gradient.
        """
        return jax.grad(lambda n: self.log_norm(n).sum())(nat)

    def kl_div(self, nat_q: jnp.ndarray, nat_p: jnp.ndarray) -> jnp.ndarray:
        """KL(q‖p) between two members, batched over leading dims."""
        grad_q = self.expected_sufficient_statistics(nat_q)
        return (
            ((nat_q - nat_p) * grad_q).sum(-1)
            - self.log_norm(nat_q)
            + self.log_norm(nat_p)
        )


# ----------------------------------------------------------------------
# Shared helpers for matrix-variate families.
# ----------------------------------------------------------------------
def sym(mat: jnp.ndarray) -> jnp.ndarray:
    """Symmetrize (guards cholesky/logdet against asymmetric roundoff)."""
    return 0.5 * (mat + jnp.swapaxes(mat, -1, -2))


def logdet_pd(mat: jnp.ndarray) -> jnp.ndarray:
    """log|M| for symmetric positive-definite M via Cholesky (batched)."""
    chol = jnp.linalg.cholesky(sym(mat))
    diag = jnp.diagonal(chol, axis1=-2, axis2=-1)
    return 2.0 * jnp.log(diag).sum(-1)


def vec(mat: jnp.ndarray) -> jnp.ndarray:
    """Flatten the trailing (D, D) matrix dims to D²."""
    return mat.reshape(*mat.shape[:-2], -1)


def unvec(flat: jnp.ndarray, dim: int) -> jnp.ndarray:
    """Inverse of :func:`vec`."""
    return flat.reshape(*flat.shape[:-1], dim, dim)
