"""Probabilistic Linear Discriminant Analysis (VB).

Reference parity: ``beer/models/plda.py`` (PLDA model for embeddings,
speaker-verification style).  Two-level generative model over labeled
embeddings (class i, observation j):

    x_ij = μ + F h_i + ε_ij,   h_i ~ N(0, I_Q),   ε_ij ~ N(0, diag(λ)⁻¹)

with VB posteriors q(h_i) (per class), q(F) (rows f_d ~ N(0, I_Q) prior,
per-row posterior covariance — rows differ because the noise is
per-dimension), and q(λ_d) per-dim Gamma.  All updates are batched
closed forms; scoring uses the standard same/different-class marginal
log-likelihood ratio.
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
class PLDA(Model):
    f_mean: jnp.ndarray        # (D, Q) E[F]
    f_cov: jnp.ndarray         # (D, Q, Q) per-row posterior covariance
    mean: jnp.ndarray          # (D,) point estimate of μ
    prec: BayesianParameter    # per-dim Gamma over λ, posterior (D, 2)
    latent_dim: int = struct.field(pytree_node=False, default=2)
    obs_dim: int = struct.field(pytree_node=False, default=2)

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
    ) -> "PLDA":
        key = key if key is not None else jax.random.PRNGKey(0)
        fam = dists.Gamma()
        nat = fam.to_nat(
            jnp.full(obs_dim, prior_shape, dtype), jnp.full(obs_dim, prior_rate, dtype)
        )
        return cls(
            f_mean=noise_std * jax.random.normal(key, (obs_dim, latent_dim), dtype),
            f_cov=jnp.broadcast_to(
                jnp.eye(latent_dim, dtype=dtype), (obs_dim, latent_dim, latent_dim)
            ),
            mean=jnp.zeros(obs_dim, dtype) if mean is None else jnp.asarray(mean, dtype),
            prec=BayesianParameter(prior=nat, posterior=nat, family=fam),
            latent_dim=latent_dim,
            obs_dim=obs_dim,
        )

    # -- expectations ---------------------------------------------------
    def _e_lam(self):
        e = self.prec.expected_sufficient_statistics()  # (D, 2)
        return e[..., 0], e[..., 1]

    def _e_ftlf(self):
        """E[Fᵀ diag(E[λ]) F] including row-covariance correction, (Q, Q)."""
        e_lam, _ = self._e_lam()
        base = self.f_mean.T @ (e_lam[:, None] * self.f_mean)
        corr = jnp.einsum("d,dij->ij", e_lam, self.f_cov)
        return base + corr

    # ------------------------------------------------------------------
    def sufficient_statistics(self, data: jnp.ndarray) -> jnp.ndarray:
        return data

    @_f32_matmuls
    def infer(self, stats: jnp.ndarray, labels: Optional[jnp.ndarray] = None,
              n_classes: Optional[int] = None):
        """q(h_i) per class; per-frame ELBO contributions.

        ``labels`` (N,) int class ids; defaults to all-one-class.
        """
        x = stats
        n, d = x.shape
        q = self.latent_dim
        if labels is None:
            labels = jnp.zeros(n, jnp.int32)
            n_classes = 1
        e_lam, e_loglam = self._e_lam()
        xc = x - self.mean
        counts = jax.ops.segment_sum(jnp.ones(n, x.dtype), labels, n_classes)
        # per-class posterior: prec_h = I + n_i * E[F' Λ F], one
        # batched inverse over the classes.  (A shared-eigenbasis form —
        # one eigh of E[FᵀΛF] diagonalizing every class at once — would
        # replace it; it is not implemented.  The quadratic-term
        # restructure below is pinned by
        # tests/test_ppca_plda.py::TestPLDAQuadRestructure.)
        e_ftlf = self._e_ftlf()
        prec_h = jnp.eye(q, dtype=x.dtype)[None] + counts[:, None, None] * e_ftlf[None]
        cov_h = jnp.linalg.inv(prec_h)                      # (C, Q, Q)
        proj = xc @ (e_lam[:, None] * self.f_mean)          # (N, Q)
        sum_proj = jax.ops.segment_sum(proj, labels, n_classes)
        m_h = jnp.einsum("cij,cj->ci", cov_h, sum_proj)     # (C, Q)

        e_hh = cov_h + m_h[:, :, None] * m_h[:, None, :]    # (C, Q, Q)
        # tr(E[FᵀΛF] E[hhᵀ]) is constant within a class, so the
        # quadratic resid term is a (C,) einsum + lookup — the naive
        # (N, Q, Q) e_hh[labels] gather (N·Q² floats of pure HBM
        # traffic at bench shape) never exists.
        quad = jnp.einsum("ij,cij->c", e_ftlf, e_hh)        # (C,)
        resid = (
            (e_lam * xc**2).sum(-1)
            - 2.0 * (proj * m_h[labels]).sum(-1)
            + quad[labels]
        )
        e_logpx = 0.5 * (e_loglam.sum() - d * LOG_2PI) - 0.5 * resid
        # per-class prior + entropy terms, spread over the class's frames
        logdet_cov = jnp.linalg.slogdet(cov_h)[1]
        per_class = (
            -0.5 * (jnp.einsum("cii->c", e_hh) + q * LOG_2PI)
            + 0.5 * (q * (1.0 + LOG_2PI) + logdet_cov)
        )
        llh = e_logpx + (per_class / jnp.maximum(counts, 1.0))[labels]
        cache = {
            "m_h": m_h, "xc": xc, "labels": labels, "counts": counts,
            "proj": proj, "e_hh": e_hh,
        }
        return llh, cache

    @_f32_matmuls
    def accumulate(self, stats: jnp.ndarray, cache: Dict[str, Any]) -> Dict[str, Any]:
        xc, labels = cache["xc"], cache["labels"]
        m_per = cache["m_h"][labels]
        s_h = jnp.einsum("c,cij->ij", cache["counts"], cache["e_hh"])
        return {
            "n": jnp.asarray(float(xc.shape[0]), xc.dtype),
            "sum_x": stats.sum(0),
            "sum_m": m_per.sum(0),
            "sum_sq": (xc**2).sum(0),                     # (D,)
            "c": xc.T @ m_per,                             # (D, Q)
            "s_h": s_h,                                    # (Q, Q)
        }

    def kl_div_posterior_prior(self) -> jnp.ndarray:
        logdet = jnp.linalg.slogdet(self.f_cov)[1]        # (D,)
        kl_f = 0.5 * (
            jnp.einsum("dii->d", self.f_cov).sum()
            + (self.f_mean**2).sum()
            - self.obs_dim * self.latent_dim
            - logdet.sum()
        )
        return kl_f + self.prec.kl_div_posterior_prior()

    def mean_field_factorization(self):
        """Two coordinate-ascent groups: subspace F (+μ), then noise λ."""
        return [["f_mean", "f_cov", "mean"], ["prec"]]

    @_f32_matmuls
    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0,
                  group=None) -> "PLDA":
        """``group`` restricts the update (see :meth:`PPCA.vb_update`)."""
        sel = set(group) if group is not None else {"f_mean", "f_cov", "mean", "prec"}
        d, q = self.obs_dim, self.latent_dim
        e_lam, _ = self._e_lam()
        # -- F rows (per-dim cov; batched (D, Q, Q) inverse — see the
        # eigh note in infer for why the shared-eigenbasis form is not
        # used despite being one factorization) --
        if "f_mean" in sel:
            eye = jnp.eye(q, dtype=acc["c"].dtype)
            f_cov = jnp.linalg.inv(eye[None] + e_lam[:, None, None] * acc["s_h"][None])
            f_mean = jnp.einsum(
                "d,dq,dqr->dr", e_lam, acc["c"], f_cov
            )
            if lrate != 1.0:
                f_mean = self.f_mean + lrate * (f_mean - self.f_mean)
                f_cov = self.f_cov + lrate * (f_cov - self.f_cov)
        else:
            f_mean, f_cov = self.f_mean, self.f_cov
        # -- λ per dim --
        if "prec" in sel:
            e_ff = jnp.einsum("di,dj->dij", f_mean, f_mean) + f_cov
            resid = (
                acc["sum_sq"]
                - 2.0 * jnp.einsum("dq,dq->d", f_mean, acc["c"])
                + jnp.einsum("dij,ij->d", e_ff, acc["s_h"])
            )
            lam_stats = jnp.stack(
                [-0.5 * resid, 0.5 * acc["n"] * jnp.ones_like(resid)], axis=-1
            )
            prec = self.prec.natural_update(lam_stats, lrate)
        else:
            prec = self.prec
        # -- μ --
        if "mean" in sel:
            mean = (acc["sum_x"] - f_mean @ acc["sum_m"]) / acc["n"]
            if lrate != 1.0:
                mean = self.mean + lrate * (mean - self.mean)
        else:
            mean = self.mean
        return self.replace(f_mean=f_mean, f_cov=f_cov, mean=mean, prec=prec)

    # -- scoring ---------------------------------------------------------
    @_f32_matmuls
    def llr_score(self, e1: jnp.ndarray, e2: jnp.ndarray) -> jnp.ndarray:
        """log p(e1, e2 | same class) − log p(e1, e2 | different classes).

        Uses point estimates (E[F], E[λ]) — the standard PLDA trial score.
        e1, e2: (N, D) paired trials; returns (N,).
        """
        e_lam, _ = self._e_lam()
        f = self.f_mean
        sigma_w = jnp.diag(1.0 / e_lam)
        sigma_b = f @ f.T
        tot = sigma_b + sigma_w

        def logpdf(x, cov):
            sign, logdet = jnp.linalg.slogdet(cov)
            sol = jnp.linalg.solve(cov, x.T).T
            return -0.5 * ((x * sol).sum(-1) + logdet + x.shape[-1] * LOG_2PI)

        x1 = e1 - self.mean
        x2 = e2 - self.mean
        # same: joint gaussian with cross-cov sigma_b
        joint = jnp.block([[tot, sigma_b], [sigma_b, tot]])
        same = logpdf(jnp.concatenate([x1, x2], axis=-1), joint)
        diff = logpdf(x1, tot) + logpdf(x2, tot)
        return same - diff
