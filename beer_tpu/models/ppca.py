"""Probabilistic PCA with variational-Bayes subspace treatment.

Reference parity: ``beer/models/ppca.py`` — VB treatment of the loading
matrix and noise precision (Bishop, "Variational PCA", 1999):

    x = μ + W z + ε,   z ~ N(0, I_Q),   ε ~ N(0, λ⁻¹ I_D)
    q(z_n) q(W) q(λ);  rows of W have prior N(0, I_Q), λ ~ Gamma(a₀, b₀)

All per-frame quantities are batched closed forms (one (N, D) @ (D, Q)
matmul for the latent means, shared (Q, Q) solves), so the whole VB-EM
step is a single XLA program.  The ``accumulate`` → ``vb_update`` split
follows the framework protocol: moments in, coordinate-ascent update out
(order z → W → λ → μ, each exact given the others ⇒ monotone ELBO).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from beer_tpu import dists
from beer_tpu.models.basemodel import Model
from beer_tpu.models.parameters import BayesianParameter
from beer_tpu.utils import struct

LOG_2PI = math.log(2.0 * math.pi)

def _f32_matmuls(fn):
    """Force f32 (HIGHEST) matmul precision inside VB math.

    Default-precision matmuls (single-pass bf16 or TF32, by backend)
    perturb the closed-form coordinate updates enough to break ELBO
    monotonicity (observed ~0.5%/step); these paths are tiny, so full
    precision is free.
    """
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped



@struct.dataclass
class PPCA(Model):
    w_mean: jnp.ndarray        # (D, Q) E[W]
    w_cov: jnp.ndarray         # (Q, Q) shared posterior row covariance
    mean: jnp.ndarray          # (D,) point estimate of μ
    prec: BayesianParameter    # Gamma posterior over λ
    latent_dim: int = struct.field(pytree_node=False, default=2)
    obs_dim: int = struct.field(pytree_node=False, default=2)

    # ------------------------------------------------------------------
    @classmethod
    def create(
        cls,
        obs_dim: int,
        latent_dim: int,
        mean: Optional[jnp.ndarray] = None,
        prior_shape: float = 1.0,
        prior_rate: float = 1.0,
        noise_std: float = 0.5,
        key: Optional[jax.Array] = None,
        dtype=jnp.float32,
    ) -> "PPCA":
        key = key if key is not None else jax.random.PRNGKey(0)
        fam = dists.Gamma()
        nat = fam.to_nat(jnp.asarray(prior_shape, dtype), jnp.asarray(prior_rate, dtype))
        return cls(
            w_mean=noise_std * jax.random.normal(key, (obs_dim, latent_dim), dtype),
            w_cov=jnp.eye(latent_dim, dtype=dtype),
            mean=jnp.zeros(obs_dim, dtype) if mean is None else jnp.asarray(mean, dtype),
            prec=BayesianParameter(prior=nat, posterior=nat, family=fam),
            latent_dim=latent_dim,
            obs_dim=obs_dim,
        )

    # -- expectations ---------------------------------------------------
    def _e_lam(self):
        e = self.prec.expected_sufficient_statistics()
        return e[..., 0], e[..., 1]  # E[λ], E[log λ]

    def _e_wtw(self):
        return self.w_mean.T @ self.w_mean + self.obs_dim * self.w_cov

    # ------------------------------------------------------------------
    def sufficient_statistics(self, data: jnp.ndarray) -> jnp.ndarray:
        return data

    @_f32_matmuls
    def infer(self, stats: jnp.ndarray):
        """q(z_n) and per-frame ELBO contributions."""
        x = stats
        d, q = self.obs_dim, self.latent_dim
        e_lam, e_loglam = self._e_lam()
        e_wtw = self._e_wtw()
        prec_z = jnp.eye(q, dtype=x.dtype) + e_lam * e_wtw
        cov_z = jnp.linalg.inv(prec_z)
        xc = x - self.mean
        m = e_lam * (xc @ self.w_mean) @ cov_z  # (N, Q)

        e_zz = cov_z[None] + m[:, :, None] * m[:, None, :]
        resid = (
            (xc**2).sum(-1)
            - 2.0 * ((xc @ self.w_mean) * m).sum(-1)
            + jnp.einsum("ij,nij->n", e_wtw, e_zz)
        )
        e_logpx = 0.5 * d * (e_loglam - LOG_2PI) - 0.5 * e_lam * resid
        e_logpz = -0.5 * q * LOG_2PI - 0.5 * ((m**2).sum(-1) + jnp.trace(cov_z))
        ent = 0.5 * (q * (1.0 + LOG_2PI) + jnp.linalg.slogdet(cov_z)[1])
        llh = e_logpx + e_logpz + ent
        return llh, {"m": m, "cov_z": cov_z, "resid": resid, "xc": xc}

    @_f32_matmuls
    def accumulate(self, stats: jnp.ndarray, cache: Dict[str, Any]) -> Dict[str, Any]:
        x, m, cov_z = stats, cache["m"], cache["cov_z"]
        n = x.shape[0]
        return {
            "n": jnp.asarray(float(n), x.dtype),
            "sum_x": x.sum(0),
            "sum_m": m.sum(0),
            "sum_sq": (cache["xc"] ** 2).sum(),
            "c": cache["xc"].T @ m,                      # (D, Q)
            "s_z": n * cov_z + m.T @ m,                  # (Q, Q)
        }

    def kl_div_posterior_prior(self) -> jnp.ndarray:
        # KL(q(W)‖p(W)): D iid rows N(m_d, Σ_w) vs N(0, I)
        d, q = self.obs_dim, self.latent_dim
        kl_w = 0.5 * (
            d * jnp.trace(self.w_cov)
            + (self.w_mean**2).sum()
            - d * q
            - d * jnp.linalg.slogdet(self.w_cov)[1]
        )
        return kl_w + self.prec.kl_div_posterior_prior()

    def mean_field_factorization(self):
        """Two coordinate-ascent groups: subspace W (+μ), then noise λ."""
        return [["w_mean", "w_cov", "mean"], ["prec"]]

    @_f32_matmuls
    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0,
                  group=None) -> "PPCA":
        """Coordinate ascent: W (given old λ) → λ (given new W) → μ.

        ``group`` restricts the update to those fields, holding the rest
        at their current values *inside* the computation — so each
        mean-field group step is an exact coordinate update.
        """
        sel = set(group) if group is not None else {"w_mean", "w_cov", "mean", "prec"}
        d, q = self.obs_dim, self.latent_dim
        e_lam, _ = self._e_lam()
        # -- W --
        if "w_mean" in sel:
            w_cov = jnp.linalg.inv(jnp.eye(q, dtype=acc["c"].dtype) + e_lam * acc["s_z"])
            w_mean = e_lam * acc["c"] @ w_cov
            if lrate != 1.0:
                w_mean = self.w_mean + lrate * (w_mean - self.w_mean)
                w_cov = self.w_cov + lrate * (w_cov - self.w_cov)
        else:
            w_mean, w_cov = self.w_mean, self.w_cov
        # -- λ -- (Gamma natural stats: [Σ -residual/2, Σ D/2])
        if "prec" in sel:
            e_wtw = w_mean.T @ w_mean + d * w_cov
            resid_tot = (
                acc["sum_sq"]
                - 2.0 * jnp.trace(w_mean.T @ acc["c"])
                + jnp.einsum("ij,ij->", e_wtw, acc["s_z"])
            )
            lam_stats = jnp.stack([-0.5 * resid_tot, 0.5 * d * acc["n"]])
            prec = self.prec.natural_update(lam_stats, lrate)
        else:
            prec = self.prec
        # -- μ -- (exact minimizer given q(z), q(W))
        if "mean" in sel:
            mean = (acc["sum_x"] - w_mean @ acc["sum_m"]) / acc["n"]
            if lrate != 1.0:
                mean = self.mean + lrate * (mean - self.mean)
        else:
            mean = self.mean
        return self.replace(w_mean=w_mean, w_cov=w_cov, mean=mean, prec=prec)

    # -- convenience ---------------------------------------------------
    @_f32_matmuls
    def transform(self, data: jnp.ndarray) -> jnp.ndarray:
        """Posterior latent means E[z|x], (N, Q)."""
        _, cache = self.infer(self.sufficient_statistics(data))
        return cache["m"]
