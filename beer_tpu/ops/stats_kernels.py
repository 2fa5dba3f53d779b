"""Full-covariance Gaussian statistics computed from raw frames.

The per-frame full-covariance statistic s(x) = [vec(−½xxᵀ), x, −½, ½]
is O(T·D²) when materialized.  :func:`ellh_full_xla` scores raw frames
against the expected natural parameters without building it;
:func:`accumulate_full_xla` and :func:`gmm_estep_xla` are the
responsibility-weighted statistics and the whole GMM E-step in the same
raw-frame form.  All run at ``HIGHEST`` precision and agree with the
materialized ``NormalSet`` path (tests assert it).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

LOG_2PI = math.log(2.0 * math.pi)


def ellh_full_xla(x, e_stats, dim: int):
    """(T, D) frames → (T, K) expected log-likelihoods, no (T, D²)
    statistics."""
    d = dim
    elam = e_stats[:, : d * d].reshape(-1, d, d)
    elin = e_stats[:, d * d : d * d + d]
    const = -0.5 * e_stats[:, -2] + 0.5 * e_stats[:, -1] - 0.5 * d * LOG_2PI
    quad = jnp.einsum(
        "td,kde,te->tk", x, elam, x, precision=jax.lax.Precision.HIGHEST
    )
    lin = jnp.matmul(x, elin.T, precision=jax.lax.Precision.HIGHEST)
    return -0.5 * quad + lin + const


def accumulate_full_xla(x, resps):
    """(T, D) frames × (T, K) responsibilities → (K, D²+D+2)
    statistics (materializes the (T, P) statistics)."""
    from beer_tpu.dists.normallik import suff_stats_full

    return jnp.einsum(
        "tk,tp->kp", resps, suff_stats_full(x),
        precision=jax.lax.Precision.HIGHEST,
    )


def gmm_estep_xla(x, e_stats, log_w, dim: int, mask=None):
    """One GMM E-step from raw frames: (per-frame log-marginals,
    (K, P) statistics, (K,) counts)."""
    llh_k = ellh_full_xla(x, e_stats, dim)               # (T, K)
    joint = llh_k + log_w
    llh = jax.scipy.special.logsumexp(joint, axis=-1)
    r = jnp.exp(joint - llh[..., None])
    if mask is not None:
        m = mask.reshape(-1).astype(llh.dtype)
        llh = llh * m
        r = r * m[:, None]
    acc = accumulate_full_xla(x, r)
    counts = r.sum(0)
    return llh, acc, counts
