"""Bayesian Normal model and vectorized NormalSet.

Reference parity: ``beer/models/normal.py`` (Normal, NormalSet,
``create(mean, cov, cov_type ∈ {full, diagonal, isotropic, shared_*})``).

A ``NormalSet`` is one ``BayesianParameter`` whose posterior has shape
(K, P) — components are an array axis, never a Python list — except for
the ``shared_*`` covariance types where all K components live inside one
Joint* prior of shape (P,) (tied covariance).

Expected log-likelihood of all K components is a single
``stats @ E[T].T`` matmul; accumulation is ``resps.T @ stats``.  Both run under whatever jit context the caller owns.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import jax
import jax.numpy as jnp

from beer_tpu import dists
from beer_tpu.dists import normallik
from beer_tpu.models.modelset import ModelSet
from beer_tpu.models.parameters import BayesianParameter
from beer_tpu.utils import struct

LOG_2PI = math.log(2.0 * math.pi)

# cov_type → (family ctor, data-stats fn). "shared_*" use the Joint families.
_UNSHARED = {
    "full": (dists.NormalWishart, normallik.suff_stats_full),
    "diagonal": (dists.NormalGamma, normallik.suff_stats_diag),
    "isotropic": (dists.IsotropicNormalGamma, normallik.suff_stats_isotropic),
}
_SHARED = {
    "shared_full": (dists.JointNormalWishart, normallik.suff_stats_shared_full),
    "shared_diagonal": (dists.JointNormalGamma, normallik.suff_stats_shared_diag),
    "shared_isotropic": (
        dists.JointIsotropicNormalGamma,
        normallik.suff_stats_shared_isotropic,
    ),
}


def _prior_nat(cov_type: str, mean, cov, prior_strength: float):
    """Build the prior natural parameters for one component (or joint set)."""
    dim = mean.shape[-1]
    k = float(prior_strength)
    if cov_type == "full":
        fam = dists.NormalWishart(dim=dim)
        dof = dim + k
        scale_matrix = jnp.linalg.inv(cov) / dof
        return fam, fam.to_nat(mean, k, scale_matrix, dof)
    if cov_type == "diagonal":
        fam = dists.NormalGamma(dim=dim)
        var = jnp.diagonal(cov, axis1=-2, axis2=-1) if cov.ndim >= 2 else cov
        return fam, fam.to_nat(
            mean, jnp.full_like(mean, k), jnp.full_like(mean, k), k * var
        )
    if cov_type == "isotropic":
        fam = dists.IsotropicNormalGamma(dim=dim)
        var = (jnp.diagonal(cov, axis1=-2, axis2=-1) if cov.ndim >= 2 else cov).mean()
        return fam, fam.to_nat(mean, k, k, k * var)
    raise ValueError(f"unknown cov_type: {cov_type}")


def _shared_prior_nat(cov_type: str, means, cov, prior_strength: float):
    ncomp, dim = means.shape
    k = float(prior_strength)
    if cov_type == "shared_full":
        fam = dists.JointNormalWishart(dim=dim, ncomp=ncomp)
        dof = dim + k
        return fam, fam.to_nat(means, jnp.full(ncomp, k), jnp.linalg.inv(cov) / dof, dof)
    if cov_type == "shared_diagonal":
        fam = dists.JointNormalGamma(dim=dim, ncomp=ncomp)
        var = jnp.diagonal(cov) if cov.ndim == 2 else cov
        return fam, fam.to_nat(
            means, jnp.full((ncomp, dim), k), jnp.full(dim, k), k * var
        )
    if cov_type == "shared_isotropic":
        fam = dists.JointIsotropicNormalGamma(dim=dim, ncomp=ncomp)
        var = (jnp.diagonal(cov) if cov.ndim == 2 else cov).mean()
        return fam, fam.to_nat(means, jnp.full(ncomp, k), k, k * var)
    raise ValueError(f"unknown cov_type: {cov_type}")


@struct.dataclass
class NormalSet(ModelSet):
    """K Bayesian Normals evaluated jointly."""

    means_precisions: BayesianParameter
    cov_type: str = struct.field(pytree_node=False, default="full")
    ncomp: int = struct.field(pytree_node=False, default=1)
    dim: int = struct.field(pytree_node=False, default=1)

    # ------------------------------------------------------------------
    @classmethod
    def create(
        cls,
        mean: jnp.ndarray,
        cov: jnp.ndarray,
        size: int,
        prior_strength: float = 1.0,
        noise_std: float = 0.1,
        cov_type: str = "full",
        key: jax.Array | None = None,
        init_means: jnp.ndarray | None = None,
    ) -> "NormalSet":
        """K components centered on ``mean`` with jittered posterior means.

        Mirrors the reference factory: the prior is centered on the global
        (mean, cov); posterior means get N(0, noise_std²) jitter so VB-EM
        breaks symmetry.  ``init_means`` (K, D) overrides the jittered
        means — e.g. random data frames, which start every component
        inside the data manifold (jitter around a far-away global mean
        lets the first lucky component win all responsibilities and
        collapse the mixture/loop at lrate 1).
        """
        mean = jnp.asarray(mean)
        cov = jnp.asarray(cov)
        dim = mean.shape[-1]
        if cov_type == "shared":  # reference alias for tied full covariance
            cov_type = "shared_full"
        if key is None:
            key = jax.random.PRNGKey(1)
        if init_means is not None:
            post_means = jnp.asarray(init_means, mean.dtype)
        else:
            post_means = mean + noise_std * jax.random.normal(
                key, (size, dim), mean.dtype
            )
        if cov_type in _UNSHARED:
            fam, prior = _prior_nat(cov_type, mean, cov, prior_strength)
            prior = jnp.broadcast_to(prior, (size,) + prior.shape)
            _, post = _prior_nat(cov_type, post_means, cov, prior_strength)
        else:
            means = jnp.broadcast_to(mean, (size, dim))
            fam, prior = _shared_prior_nat(cov_type, means, cov, prior_strength)
            _, post = _shared_prior_nat(cov_type, post_means, cov, prior_strength)
        param = BayesianParameter(prior=prior, posterior=post, family=fam)
        return cls(
            means_precisions=param, cov_type=cov_type, ncomp=size, dim=dim,
        )

    def __len__(self) -> int:
        return self.ncomp

    # ------------------------------------------------------------------
    def sufficient_statistics(self, data: jnp.ndarray) -> jnp.ndarray:
        if self.cov_type == "diagonal":
            # Reduced layout [−½x², x] (2D): the [−½·1, ½·1] constant
            # blocks of the canonical 4D layout contribute a per-frame
            # constant to the ELLH and a pure-count term to the
            # accumulation — both recovered in closed form below.  Halves
            # the hot (T, P) @ (P, K) matmuls and the stats HBM footprint.
            return jnp.concatenate([-0.5 * data**2, data], axis=-1)
        if self.cov_type in _UNSHARED:
            return _UNSHARED[self.cov_type][1](data)
        return _SHARED[self.cov_type][1](data, self.ncomp)

    def infer(self, stats: jnp.ndarray):
        llh = self.expected_log_likelihood(stats)
        return llh, {}

    def expected_log_likelihood(self, stats: jnp.ndarray) -> jnp.ndarray:
        """(T, K) expected log-likelihood of every component."""
        e_stats = self.means_precisions.expected_sufficient_statistics()
        if self.cov_type == "diagonal":
            d = self.dim
            # bias_k = Σ_d (−½ E[λμ²] + ½ E[log λ]) — the constant blocks
            bias = -0.5 * e_stats[:, 2 * d:3 * d].sum(-1) \
                + 0.5 * e_stats[:, 3 * d:].sum(-1)
            llh = jnp.matmul(
                stats, e_stats[:, :2 * d].T,
                precision=jax.lax.Precision.HIGHEST,
            ) + bias
            return llh - 0.5 * d * LOG_2PI
        if self.cov_type in _UNSHARED:
            # (T, P) @ (P, K); HIGHEST: stats have x·xᵀ-scale dynamic range,
            # bf16x3 passes visibly perturb the ELBO (non-monotone VB-EM).
            llh = jnp.matmul(stats, e_stats.T, precision=jax.lax.Precision.HIGHEST)
        else:
            llh = jnp.einsum(
                "...kp,p->...k", stats, e_stats,
                precision=jax.lax.Precision.HIGHEST,
            )
        return llh - 0.5 * self.dim * LOG_2PI

    def accumulate(self, stats: jnp.ndarray, resps: jnp.ndarray) -> Dict[str, Any]:
        """resps (T, K) → natural-space statistics for the parameter."""
        if self.cov_type == "diagonal":
            acc2 = jnp.einsum(
                "...tk,...tp->...kp", resps, stats,
                precision=jax.lax.Precision.HIGHEST,
            )
            counts = resps.sum(-2)[..., None]            # (..., K, 1)
            ones = jnp.ones((self.dim,), stats.dtype)
            acc = jnp.concatenate(
                [acc2, -0.5 * counts * ones, 0.5 * counts * ones], axis=-1
            )
            return {"means_precisions": acc}
        if self.cov_type in _UNSHARED:
            acc = jnp.einsum(
                "...tk,...tp->...kp", resps, stats,
                precision=jax.lax.Precision.HIGHEST,
            )
        else:
            acc = jnp.einsum(
                "...tk,...tkp->...p", resps, stats,
                precision=jax.lax.Precision.HIGHEST,
            )
        return {"means_precisions": acc}

    def kl_div_posterior_prior(self) -> jnp.ndarray:
        return self.means_precisions.kl_div_posterior_prior()

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "NormalSet":
        return self.replace(
            means_precisions=self.means_precisions.natural_update(
                acc["means_precisions"], lrate
            )
        )

    # -- convenience ---------------------------------------------------
    def means(self) -> jnp.ndarray:
        """Posterior expected means, (K, D)."""
        std = self.means_precisions.family.to_std(self.means_precisions.posterior)
        return std[0]


@struct.dataclass
class Normal(NormalSet):
    """A single Bayesian Normal (K = 1 NormalSet with squeezed outputs)."""

    @classmethod
    def create(
        cls,
        mean: jnp.ndarray,
        cov: jnp.ndarray,
        prior_strength: float = 1.0,
        cov_type: str = "full",
        **kw,
    ) -> "Normal":
        out = super().create(
            mean, cov, size=1, prior_strength=prior_strength,
            noise_std=0.0, cov_type=cov_type, **kw,
        )
        return cls(**{f: getattr(out, f) for f in out.__dataclass_fields__})

    def infer(self, stats: jnp.ndarray):
        return self.expected_log_likelihood(stats)[..., 0], {}

    def accumulate(self, stats: jnp.ndarray, cache=None) -> Dict[str, Any]:
        resps = jnp.ones(stats.shape[:-1] + (1,), stats.dtype) \
            if self.cov_type in _UNSHARED else jnp.ones(stats.shape[:-2] + (1,), stats.dtype)
        return super().accumulate(stats, resps)
