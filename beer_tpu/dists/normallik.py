"""Data-side sufficient statistics for Normal likelihoods.

Reference parity: ``beer/dists/normal.py`` sufficient-statistics layouts
(`[x, vec(xxᵀ), 1, 1]` full / `[x, x², 1, 1]` diag) — reordered here so the
statistic vector lives in the *same flat space as the conjugate prior's
natural parameters* (see each prior module's docstring).  With that
alignment:

* expected log-likelihood = ``stats @ E[T(θ)].T  −  (D/2) log 2π``
  — one dense (T, P) @ (P, K) matmul;
* accumulation = ``resps.T @ stats`` — another matmul;
* VB update = plain addition of the accumulated vector to the prior.

These are the hot O(T·D²) ops of the whole framework (SURVEY.md §3.1); a
fused Pallas accumulation kernel lives in ``beer_tpu/ops/stats_kernels.py``,
with these jnp versions as the always-correct XLA fallback.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

LOG_2PI = math.log(2.0 * math.pi)


def suff_stats_full(x: jnp.ndarray) -> jnp.ndarray:
    """Full-covariance stats s(x) = [vec(−½xxᵀ), x, −½, ½]; (..., D²+D+2)."""
    batch = x.shape[:-1]
    outer = -0.5 * (x[..., :, None] * x[..., None, :])
    ones = jnp.ones(batch + (1,), x.dtype)
    return jnp.concatenate(
        [outer.reshape(*batch, -1), x, -0.5 * ones, 0.5 * ones], axis=-1
    )


def suff_stats_diag(x: jnp.ndarray) -> jnp.ndarray:
    """Diagonal-covariance stats s(x) = [−½x², x, −½·1, ½·1]; (..., 4D)."""
    halves = jnp.full_like(x, 0.5)
    return jnp.concatenate([-0.5 * x**2, x, -halves, halves], axis=-1)


def suff_stats_isotropic(x: jnp.ndarray) -> jnp.ndarray:
    """Isotropic stats s(x) = [−½‖x‖², x, −½, D/2]; (..., D+3)."""
    dim = x.shape[-1]
    sq = -0.5 * (x**2).sum(-1, keepdims=True)
    ones = jnp.ones_like(sq)
    return jnp.concatenate([sq, x, -0.5 * ones, 0.5 * dim * ones], axis=-1)


def suff_stats_shared_full(x: jnp.ndarray, ncomp: int) -> jnp.ndarray:
    """Per-component stats for JointNormalWishart: (..., K, D²+KD+K+1).

    Component k's statistic places x in mean-block k; the vec(xxᵀ) block
    and the log|Λ| slot are shared.  Responsibility-weighted sums over k
    therefore accumulate the shared precision stats with total weight 1
    per frame.
    """
    batch = x.shape[:-1]
    dim = x.shape[-1]
    dtype = x.dtype
    outer = -0.5 * (x[..., :, None] * x[..., None, :]).reshape(*batch, -1)
    eye = jnp.eye(ncomp, dtype=dtype)
    # Broadcast into (..., K, blocks).
    outer_k = jnp.broadcast_to(outer[..., None, :], batch + (ncomp, dim * dim))
    # Block-diagonal placement of x into mean-block k.
    xk = (eye[:, :, None] * x[..., None, None, :]).reshape(*batch, ncomp, ncomp * dim)
    quad = jnp.broadcast_to(-0.5 * eye, batch + (ncomp, ncomp))
    half = jnp.full(batch + (ncomp, 1), 0.5, dtype)
    return jnp.concatenate([outer_k, xk, quad, half], axis=-1)


def suff_stats_shared_diag(x: jnp.ndarray, ncomp: int) -> jnp.ndarray:
    """Per-component stats for JointNormalGamma: (..., K, 2D + 2KD)."""
    batch = x.shape[:-1]
    dim = x.shape[-1]
    dtype = x.dtype
    eye = jnp.eye(ncomp, dtype=dtype)
    sq = jnp.broadcast_to((-0.5 * x**2)[..., None, :], batch + (ncomp, dim))
    xk = (eye[:, :, None] * x[..., None, None, :]).reshape(*batch, ncomp, ncomp * dim)
    quadk = (eye[:, :, None] * jnp.full(batch + (1, 1, dim), -0.5, dtype)).reshape(
        *batch, ncomp, ncomp * dim
    )
    half = jnp.full(batch + (ncomp, dim), 0.5, dtype)
    return jnp.concatenate([sq, xk, quadk, half], axis=-1)


def suff_stats_shared_isotropic(x: jnp.ndarray, ncomp: int) -> jnp.ndarray:
    """Per-component stats for JointIsotropicNormalGamma: (..., K, KD+K+2)."""
    batch = x.shape[:-1]
    dim = x.shape[-1]
    dtype = x.dtype
    eye = jnp.eye(ncomp, dtype=dtype)
    sq = jnp.broadcast_to(
        (-0.5 * (x**2).sum(-1))[..., None, None], batch + (ncomp, 1)
    )
    xk = (eye[:, :, None] * x[..., None, None, :]).reshape(*batch, ncomp, ncomp * dim)
    quad = jnp.broadcast_to(-0.5 * eye, batch + (ncomp, ncomp))
    half = jnp.full(batch + (ncomp, 1), 0.5 * dim, dtype)
    return jnp.concatenate([sq, xk, quad, half], axis=-1)
