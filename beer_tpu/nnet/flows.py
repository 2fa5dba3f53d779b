"""Normalizing-flow blocks for richer VAE posteriors.

Reference parity: ``beer/nnet`` autoregressive/flow components (SURVEY.md
§2, NNet blocks row).  Two classic, jit-friendly flows:

* :class:`PlanarFlow` — z' = z + u·tanh(wᵀz + b) (Rezende & Mohamed '15),
  with the u-constraint reparameterization that keeps the Jacobian
  positive,
* :class:`AffineAutoregressiveFlow` — a masked (MADE-style) single-layer
  IAF step: z'_d = z_d · σ(s_d(z_{<d})) + m_d(z_{<d}).

``flow_rsample`` composes them on top of a diagonal-Normal head and
returns (samples, log q(z)) with the log-det corrections accumulated —
drop-in for the VAE's posterior sampling path.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from beer_tpu import nnet


def _float():
    """JAX's default float: float64 when x64 is enabled, else float32."""
    return jax.dtypes.canonicalize_dtype(jnp.float64)


def _normal(key, path, shape, std):
    return std * jax.random.normal(nnet.param_key(key, path), shape,
                                   _float())


@dataclasses.dataclass(frozen=True)
class PlanarFlow(nnet.Module):
    dim: int

    def init(self, key, z, path=()):
        return {"u": _normal(key, path + (1,), (self.dim,), 0.1),
                "w": _normal(key, path + (2,), (self.dim,), 0.1),
                "b": jnp.zeros((), _float())}

    def apply(self, params, z):
        """Returns (z', log|det ∂z'/∂z|), batched over leading dims."""
        u, w, b = params["u"], params["w"], params["b"]
        # û reparameterization: wᵀû ≥ −1 keeps the flow invertible
        wu = (w * u).sum()
        m = -1.0 + jnp.logaddexp(wu, 0.0)  # m(wu) = -1 + softplus(wu)
        u_hat = u + (m - wu) * w / (w**2).sum()
        lin = z @ w + b
        z_new = z + u_hat * jnp.tanh(lin)[..., None]
        psi = (1.0 - jnp.tanh(lin) ** 2)[..., None] * w
        logdet = jnp.log(jnp.abs(1.0 + psi @ u_hat) + 1e-12)
        return z_new, logdet


@dataclasses.dataclass(frozen=True)
class AffineAutoregressiveFlow(nnet.Module):
    """One masked-affine IAF step with a small MADE conditioner."""

    dim: int
    hidden: int = 32

    def init(self, key, z, path=()):
        d, h, dt = self.dim, self.hidden, _float()
        return {
            "w1": _normal(key, path + (1,), (d, h), 0.1),
            "b1": jnp.zeros((h,), dt),
            "w_m": _normal(key, path + (3,), (h, d), 0.01),
            "w_s": _normal(key, path + (4,), (h, d), 0.01),
            "b_m": jnp.zeros((d,), dt), "b_s": jnp.zeros((d,), dt),
        }

    def apply(self, params, z):
        d = self.dim
        # MADE degrees: inputs 1..d, hidden cycled, outputs 1..d — masks
        # make every output depend only on z_{<d} (autoregressive).
        in_deg = jnp.arange(1, d + 1)
        hid_deg = (jnp.arange(self.hidden) % max(d - 1, 1)) + 1
        out_deg = jnp.arange(1, d + 1)
        m1 = (hid_deg[None, :] >= in_deg[:, None]).astype(jnp.float32)
        m2 = (out_deg[None, :] > hid_deg[:, None]).astype(jnp.float32)

        p = params
        h = jnp.tanh(z @ (p["w1"] * m1) + p["b1"])
        shift = h @ (p["w_m"] * m2) + p["b_m"]
        log_scale = jnp.clip(h @ (p["w_s"] * m2) + p["b_s"], -5.0, 5.0)
        z_new = z * jnp.exp(log_scale) + shift
        return z_new, log_scale.sum(-1)


@dataclasses.dataclass(frozen=True)
class FlowStack(nnet.Module):
    """Compose flows; returns (z_K, Σ log-dets)."""

    dim: int
    n_planar: int = 2
    n_iaf: int = 0

    @property
    def flows(self):
        return ((PlanarFlow(self.dim),) * self.n_planar
                + (AffineAutoregressiveFlow(self.dim),) * self.n_iaf)

    def init(self, key, z, path=()):
        flows = self.flows
        return [f.init(key, z, path + (name,))
                for f, name in zip(flows, nnet.child_names(flows))]

    def apply(self, params, z):
        total = jnp.zeros(z.shape[:-1], z.dtype)
        for flow, p in zip(self.flows, params):
            z, ld = flow.apply(p, z)
            total = total + ld
        return z, total


def flow_rsample(flow_def, flow_params, q_params, key, nsamples: int = 1):
    """Sample z₀ ~ N(mean, var), push through the flow.

    Returns (z_K, log q(z_K)) where
    log q(z_K) = log N(z₀) − Σ log|det| — the corrected posterior density
    for ELBO entropy terms.
    """
    z0 = nnet.normal_rsample(q_params, key, nsamples)
    log_q0 = nnet.normal_log_likelihood(
        jax.tree.map(lambda a: a[None], q_params), z0
    )
    z_k, logdet = flow_def.apply(flow_params, z0)
    return z_k, log_q0 - logdet
