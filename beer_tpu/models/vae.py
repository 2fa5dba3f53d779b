"""(Structured) Variational Autoencoder.

Reference parity: ``beer/models/vae.py`` — encoder nnet →
ProbabilisticLayer posterior → reparameterized samples; **the prior over
latents is any beer model** (Normal → plain VAE, GMM → structured SVAE
over frames, HMM/PhoneLoop → structured SVAE over *sequences*, see
:class:`SequenceVAE`); decoder nnet → data likelihood.  The ELBO mixes
Monte-Carlo terms (reconstruction, q-entropy) with the latent model's
analytic expected log-likelihood and conjugate KL terms, and one
training step feeds BOTH the optax gradient update of the nnet
parameters AND the conjugate natural-parameter update of the latent
model (SURVEY.md §3.4 — the hybrid ``VBOptimizer`` named in BASELINE
config 5).

The posterior can be enriched with normalizing flows
(``beer/nnet`` autoregressive/flow components): pass ``n_flow_planar`` /
``n_flow_iaf`` to :meth:`VAE.create` and q(z|x) becomes a flow-pushed
diagonal Normal whose corrected density replaces the analytic entropy
term.

Functional layout: module *definitions* are static fields; their
parameters live in the ``nnet_params`` pytree so ``jax.grad`` sees them
while the conjugate latent model updates in closed form.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
from beer_tpu import nnet
from beer_tpu.models.basemodel import Model
from beer_tpu.nnet import flows as nnet_flows
from beer_tpu.utils import struct


def _encoder(hidden: tuple, latent_dim: int, residual: bool = False):
    """MLP trunk + diagonal-Normal head."""
    trunk = nnet.ResMLP if residual else nnet.MLP
    return nnet.Sequential((trunk(hidden), nnet.NormalDiagLayer(latent_dim)))


def _decoder(hidden: tuple, obs_dim: int, output: str = "normal",
             residual: bool = False):
    trunk = nnet.ResMLP if residual else nnet.MLP
    head = {"normal": nnet.NormalDiagLayer,
            "normal_iso": nnet.NormalIsoLayer}.get(output, nnet.BernoulliLayer)
    return nnet.Sequential((trunk(hidden), head(obs_dim)))


@struct.dataclass
class VAE(Model):
    nnet_params: Any                       # {"encoder", "decoder"[, "flow"]}
    latent_model: Any                      # beer model prior over z
    encoder_def: Any = struct.field(pytree_node=False, default=None)
    decoder_def: Any = struct.field(pytree_node=False, default=None)
    flow_def: Any = struct.field(pytree_node=False, default=None)
    latent_dim: int = struct.field(pytree_node=False, default=2)
    nsamples: int = struct.field(pytree_node=False, default=1)

    # ------------------------------------------------------------------
    @classmethod
    def create(
        cls,
        obs_dim: int,
        latent_dim: int,
        latent_model,
        hidden=(128, 128),
        nsamples: int = 1,
        output: str = "normal",
        residual: bool = False,
        n_flow_planar: int = 0,
        n_flow_iaf: int = 0,
        key: Optional[jax.Array] = None,
    ) -> "VAE":
        """Encoder/decoder MLPs (plain or residual trunks) with Normal /
        Normal-iso / Bernoulli output heads, optional flow posterior."""
        key = key if key is not None else jax.random.PRNGKey(0)
        k_enc, k_dec, k_flow = jax.random.split(key, 3)
        enc = _encoder(tuple(hidden), latent_dim, residual)
        dec = _decoder(tuple(hidden), obs_dim, output, residual)
        params = {
            "encoder": enc.init(k_enc, jnp.zeros((1, obs_dim))),
            "decoder": dec.init(k_dec, jnp.zeros((1, latent_dim))),
        }
        flow_def = None
        if n_flow_planar or n_flow_iaf:
            flow_def = nnet_flows.FlowStack(
                latent_dim, n_planar=n_flow_planar, n_iaf=n_flow_iaf
            )
            params["flow"] = flow_def.init(k_flow, jnp.zeros((1, latent_dim)))
        return cls(
            nnet_params=params,
            latent_model=latent_model,
            encoder_def=enc,
            decoder_def=dec,
            flow_def=flow_def,
            latent_dim=latent_dim,
            nsamples=nsamples,
        )

    # ------------------------------------------------------------------
    def _sample_posterior(self, q, key):
        """(z, negentropy_term): z (S, ..., dz); the ELBO entropy term.

        Plain head: analytic H(q).  Flow posterior: −E[log q(z_K)] with
        the log-det corrections of the flow stack.
        """
        if self.flow_def is None:
            z = nnet.normal_rsample(q, key, self.nsamples)
            return z, nnet.normal_entropy(q)
        z, log_q = nnet_flows.flow_rsample(
            self.flow_def, self.nnet_params["flow"], q, key, self.nsamples
        )
        return z, -log_q.mean(0)

    def _reconstruction(self, flat_z, x_rep):
        out = self.decoder_def.apply(self.nnet_params["decoder"], flat_z)
        if "logits" in out:
            return nnet.bernoulli_log_likelihood(out, x_rep)
        return nnet.normal_log_likelihood(out, x_rep)

    def elbo_and_stats(
        self, x: jnp.ndarray, key: jax.Array, datasize=None, mask=None
    ):
        """Monte-Carlo ELBO + conjugate statistics of the latent model.

        ELBO = E_q[log p(x|z)] + E_q[E_θ log p(z|θ)] + H(q(z|x))
               − KL(q(θ)‖p(θ))        (θ = latent-model parameters)
        """
        del mask  # frames are i.i.d. here; see SequenceVAE
        n = x.shape[0]
        scale = 1.0 if datasize is None else datasize / n
        q = self.encoder_def.apply(self.nnet_params["encoder"], x)
        z, entropy = self._sample_posterior(q, key)          # (S, N, dz)
        flat_z = z.reshape(-1, self.latent_dim)

        # prior term through the conjugate latent model
        stats = self.latent_model.sufficient_statistics(flat_z)
        prior_llh, cache = self.latent_model.infer(stats)
        prior_llh = prior_llh.reshape(self.nsamples, n).mean(0)

        x_rep = jnp.repeat(x[None], self.nsamples, 0).reshape(-1, x.shape[-1])
        rec = self._reconstruction(flat_z, x_rep)
        rec = rec.reshape(self.nsamples, n).mean(0)

        elbo = scale * (rec + prior_llh + entropy).sum() \
            - self.latent_model.kl_div_posterior_prior()

        acc = self.latent_model.accumulate(stats, cache)
        # average over MC samples (stats were computed on S*N points)
        acc = jax.tree.map(lambda s: scale * s / self.nsamples, acc)
        return elbo, acc

    # -- Model API ------------------------------------------------------
    def sufficient_statistics(self, data: jnp.ndarray) -> jnp.ndarray:
        return data

    def infer(self, stats: jnp.ndarray):
        """Per-frame Monte-Carlo ELBO contributions (fixed PRNG key).

        rec + E_q[prior ELLH] + H(q) per frame — an honest estimate of
        E_q[log p(x, z) − log q(z|x)], the VAE analogue of
        ``expected_log_likelihood`` (KL of the latent-model parameters is
        a model-level constant reported by ``kl_div_posterior_prior``).
        """
        x = stats
        key = jax.random.PRNGKey(0)
        q = self.encoder_def.apply(self.nnet_params["encoder"], x)
        z, entropy = self._sample_posterior(q, key)
        flat_z = z.reshape(-1, self.latent_dim)
        lstats = self.latent_model.sufficient_statistics(flat_z)
        prior_llh, _ = self.latent_model.infer(lstats)
        prior_llh = prior_llh.reshape(self.nsamples, -1).mean(0)
        x_rep = jnp.repeat(x[None], self.nsamples, 0).reshape(-1, x.shape[-1])
        rec = self._reconstruction(flat_z, x_rep)
        rec = rec.reshape(self.nsamples, -1).mean(0)
        return rec + prior_llh + entropy, {"posterior": q}

    def kl_div_posterior_prior(self) -> jnp.ndarray:
        return self.latent_model.kl_div_posterior_prior()

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "VAE":
        return self.replace(latent_model=self.latent_model.vb_update(acc, lrate))

    def mean_field_factorization(self):
        """The conjugate side's groups, addressed through ``latent_model``.

        The nnet parameters are the gradient side of the hybrid update
        (``make_vae_train_step``) and are not part of any conjugate group;
        the latent model's own factorization is exposed with dotted paths
        so ``vb_update_partial`` grafts the right sub-fields.
        """
        return [
            [f"latent_model.{name}" for name in group]
            for group in self.latent_model.mean_field_factorization()
        ]

    # ------------------------------------------------------------------
    def posteriors(self, x: jnp.ndarray):
        """q(z|x) head outputs (mean, logvar)."""
        return self.encoder_def.apply(self.nnet_params["encoder"], x)


@struct.dataclass
class SequenceVAE(VAE):
    """Structured VAE whose latent prior is a *sequence* model.

    Reference parity: ``beer/models/vae.py`` with an HMM latent model —
    the "S" of BASELINE config 5.  Data is (B, T, D) utterances with an
    optional (B, T) mask; the encoder maps frames to latent-space frame
    posteriors, sampled latent *sequences* run through the HMM /
    phone-loop E-step (forward-backward over the latent trajectory), and
    one hybrid step updates the nnets by gradient and the latent sequence
    model by its conjugate update.
    """

    def elbo_and_stats(
        self, x: jnp.ndarray, key: jax.Array, datasize=None, mask=None
    ):
        b, t, _ = x.shape
        if mask is None:
            mask = jnp.ones((b, t), x.dtype)
        scale = 1.0 if datasize is None else datasize / b
        q = self.encoder_def.apply(self.nnet_params["encoder"], x)
        z, entropy = self._sample_posterior(q, key)      # (S, B, T, dz)
        entropy = (entropy * mask).sum(-1)               # (B,)
        s = self.nsamples
        flat_z = z.reshape(s * b, t, self.latent_dim)
        mask_rep = jnp.tile(mask, (s, 1))

        stats = self.latent_model.sufficient_statistics(flat_z)
        log_z, cache = self.latent_model.infer(stats, mask=mask_rep)
        prior_llh = log_z.reshape(s, b).mean(0)          # (B,)

        x_rep = jnp.repeat(x[None], s, 0).reshape(s * b, t, x.shape[-1])
        rec = self._reconstruction(flat_z, x_rep)        # (S*B, T)
        rec = (rec * mask_rep).sum(-1).reshape(s, b).mean(0)

        elbo = scale * (rec + prior_llh + entropy).sum() \
            - self.latent_model.kl_div_posterior_prior()

        acc = self.latent_model.accumulate(stats, cache)
        acc = jax.tree.map(lambda a: scale * a / s, acc)
        return elbo, acc

    def infer(self, stats: jnp.ndarray, mask: Optional[jnp.ndarray] = None):
        """Per-sequence Monte-Carlo ELBO contributions (fixed PRNG key).

        ``mask`` (B, T) restricts the entropy/reconstruction sums and the
        latent-model smoothing to true frames — same convention as
        :meth:`elbo_and_stats` (ragged batches would otherwise count
        padding frames).
        """
        x = stats
        key = jax.random.PRNGKey(0)
        b, t = x.shape[0], x.shape[1]
        if mask is None:
            mask = jnp.ones((b, t), x.dtype)
        q = self.encoder_def.apply(self.nnet_params["encoder"], x)
        z, entropy = self._sample_posterior(q, key)
        entropy = (entropy * mask).sum(-1)
        s = self.nsamples
        flat_z = z.reshape(s * b, t, self.latent_dim)
        mask_rep = jnp.tile(mask, (s, 1))
        lstats = self.latent_model.sufficient_statistics(flat_z)
        log_z, _ = self.latent_model.infer(lstats, mask=mask_rep)
        prior_llh = log_z.reshape(s, b).mean(0)
        x_rep = jnp.repeat(x[None], s, 0).reshape(s * b, t, x.shape[-1])
        rec = (self._reconstruction(flat_z, x_rep) * mask_rep).sum(-1)
        rec = rec.reshape(s, b).mean(0)
        return rec + prior_llh + entropy, {"posterior": q}

    # ------------------------------------------------------------------
    def latent_decode(self, x: jnp.ndarray, mask=None):
        """Viterbi on the latent posterior means; (labels (B, T), scores).

        Uses ``decode_units`` when the latent model is a phone loop
        (unit-level segmentation), plain state Viterbi otherwise.
        """
        q = self.posteriors(x)
        z = q["mean"]
        if hasattr(self.latent_model, "decode_units"):
            return self.latent_model.decode_units(z, mask)
        return self.latent_model.decode(z, mask)


def make_vae_train_step(tx, datasize=None, lrate: float = 1.0):
    """Build the jitted hybrid step: optax on nnets + conjugate on prior.

    Returns ``step(vae, opt_state, x, key, mask=None) ->
    (elbo, vae, opt_state)``; ``mask`` applies to :class:`SequenceVAE`.
    """

    def step(vae: VAE, opt_state, x, key, mask=None):
        def loss_fn(nnet_params):
            elbo, acc = vae.replace(nnet_params=nnet_params).elbo_and_stats(
                x, key, datasize, mask
            )
            return -elbo, acc

        (neg_elbo, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            vae.nnet_params
        )
        updates, opt_state = tx.update(grads, opt_state, vae.nnet_params)
        import optax

        new_params = optax.apply_updates(vae.nnet_params, updates)
        new_vae = vae.replace(
            nnet_params=new_params,
            latent_model=vae.latent_model.vb_update(acc, lrate),
        )
        return -neg_elbo, new_vae, opt_state

    return jax.jit(step)
