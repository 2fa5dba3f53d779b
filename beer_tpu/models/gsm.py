"""Generalized Subspace Model (GSM) — subspace-HMM / H-SHMM.

Reference parity: ``beer/models/gsm.py`` (GSM, AffineTransform,
HierarchicalGSM) — the SHMM (Interspeech'19) / H-SHMM (ICASSP'21) models:
each acoustic unit u gets a low-dimensional embedding e_u whose image
η(e_u) through a (variational) affine map — optionally preceded by a
deterministic MLP trunk, the reference's nnet-transform option —
parameterizes the unit's HMM natural parameters; embeddings and subspace
basis are trained by reparameterization-trick gradient ascent on

    Σ_u E_q[⟨s_u, T(η(e_u))⟩ − counts_u · A_x(η(e_u))]
        − KL(q(e)‖p(e)) − KL(q(W,b)‖p(W,b))

where s_u are the accumulated per-unit sufficient statistics from
phone-loop E-steps (SURVEY.md §3.5) and A_x the *likelihood*
log-normalizer.  The subspace generates the **full per-unit parameter
pytree**:

* diagonal-Normal emission parameters (μ, λ) of every unit state — with
  ``n_comp > 1``, a GMM per state including its **mixture weights**,
* optionally the within-unit **transition** probabilities
  (``learn_transitions``): one self-loop logit per state.

The write-back into a phone loop (:func:`apply_to_phoneloop`) propagates
the *moments of q(η(e_u))* — Monte-Carlo estimates of E[λ], E[λμ],
E[λμ²], E[log λ] (and E[log w], E[log σ]) are moment-matched to
NormalGamma / Dirichlet posteriors — not a point estimate, so subsequent
phone-loop E-steps marginalize the subspace posterior to first order.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Union

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma, polygamma

from beer_tpu.utils import struct

LOG_2PI = math.log(2.0 * math.pi)

# PRNG implementation for the subspace training loop's keys.  The
# reparameterization noise is a large share of the H-SHMM train step.
# MC reparameterization noise does not need threefry's splitting
# guarantees, so ``rbg`` (XLA's RngBitGenerator) is the default for keys
# made by :func:`train_key`; ``BEER_GSM_RNG=threefry`` selects the
# counter-based impl instead (library code is key-type agnostic —
# whatever key you pass in wins).  Neither choice has been timed on a
# GPU yet.
GSM_RNG_IMPL = os.environ.get("BEER_GSM_RNG", "rbg")

# Noise-draw layout for :meth:`GSM._sample_eps`: "block" (default) or
# "flat" — see its docstring for the measured trade.
GSM_EPS_LAYOUT = os.environ.get("BEER_GSM_EPS", "block")


def train_key(seed: int) -> jax.Array:
    """PRNG key for GSM/H-SHMM subspace training (see GSM_RNG_IMPL)."""
    if GSM_RNG_IMPL == "threefry":
        return jax.random.PRNGKey(seed)
    return jax.random.key(seed, impl=GSM_RNG_IMPL)


def _softplus(x):
    return jnp.logaddexp(x, 0.0)


def _log_sigmoid(x):
    return -_softplus(-x)


@struct.dataclass
class GSM:
    """Subspace over the per-unit HMM parameters.

    Variational parameters (all trained by gradient):
      * ``e_mean, e_logvar``   (U, E)  — q(e_u)
      * ``w_mean, w_logvar``   (H+1, out) — q of the affine map (incl.
        bias row) reading the trunk output (or the raw embedding).
      * ``trunk_params``       — deterministic MLP trunk (MAP-trained),
        ``None`` for the plain affine subspace.

    Output layout per unit: ``[P·K·2D emission raw | P·K weight logits
    (K>1) | P self-loop logits (learn_transitions)]``.
    """

    e_mean: jnp.ndarray
    e_logvar: jnp.ndarray
    w_mean: jnp.ndarray
    w_logvar: jnp.ndarray
    trunk_params: Any = None
    trunk_def: Any = struct.field(pytree_node=False, default=None)
    n_units: int = struct.field(pytree_node=False, default=1)
    embed_dim: int = struct.field(pytree_node=False, default=2)
    obs_dim: int = struct.field(pytree_node=False, default=1)
    states_per_unit: int = struct.field(pytree_node=False, default=1)
    n_comp: int = struct.field(pytree_node=False, default=1)
    learn_transitions: bool = struct.field(pytree_node=False, default=False)

    # -- layout helpers --------------------------------------------------
    @property
    def _emis_size(self) -> int:
        return self.states_per_unit * self.n_comp * 2 * self.obs_dim

    @property
    def _weight_size(self) -> int:
        return self.states_per_unit * self.n_comp if self.n_comp > 1 else 0

    @property
    def _trans_size(self) -> int:
        return self.states_per_unit if self.learn_transitions else 0

    @property
    def out_dim(self) -> int:
        return self._emis_size + self._weight_size + self._trans_size

    @classmethod
    def create(
        cls,
        n_units: int,
        embed_dim: int,
        obs_dim: int,
        states_per_unit: int = 1,
        n_comp: int = 1,
        learn_transitions: bool = False,
        trunk: Optional[str] = None,
        key: Optional[jax.Array] = None,
        dtype=jnp.float32,
    ) -> "GSM":
        """``trunk``: optional nnet-transform config string (see
        :func:`beer_tpu.nnet.build_trunk`, e.g. ``"mlp:32,32:tanh"``)."""
        key = key if key is not None else jax.random.PRNGKey(0)
        k1, k2, k3 = jax.random.split(key, 3)
        trunk_def = trunk_params = None
        in_dim = embed_dim
        if trunk is not None:
            from beer_tpu import nnet

            trunk_def = nnet.build_trunk(trunk)
            trunk_params = trunk_def.init(k3, jnp.zeros((1, embed_dim), dtype))
            in_dim = jax.eval_shape(
                lambda p, x: trunk_def.apply(p, x),
                trunk_params, jnp.zeros((1, embed_dim), dtype),
            ).shape[-1]
        self_ = cls(
            e_mean=0.1 * jax.random.normal(k1, (n_units, embed_dim), dtype),
            e_logvar=jnp.full((n_units, embed_dim), -2.0, dtype),
            w_mean=jnp.zeros((1, 1), dtype),  # placeholder, fixed below
            w_logvar=jnp.zeros((1, 1), dtype),
            trunk_params=trunk_params,
            trunk_def=trunk_def,
            n_units=n_units,
            embed_dim=embed_dim,
            obs_dim=obs_dim,
            states_per_unit=states_per_unit,
            n_comp=n_comp,
            learn_transitions=learn_transitions,
        )
        out = self_.out_dim
        return self_.replace(
            w_mean=0.1 * jax.random.normal(k2, (in_dim + 1, out), dtype),
            w_logvar=jnp.full((in_dim + 1, out), -4.0, dtype),
        )

    # ------------------------------------------------------------------
    def _eps_spec(self, nsamples: int):
        """Name → shape of the reparameterization noise blocks."""
        return {"e": (nsamples,) + self.e_mean.shape,
                "w": (nsamples,) + self.w_mean.shape}

    def _sample_eps(self, key, nsamples: int):
        """Parameter-independent reparameterization noise for one step.

        Split out of :meth:`_sample_params` so callers can draw noise
        once and reuse it (``elbo(..., eps=)``).  Two layouts, both
        i.i.d. N(0,1) (the MC estimator needs nothing more, so the
        block structure of the stream is an implementation detail):

        * block (default) — one ``normal`` call per block under split
          subkeys.
        * flat (``BEER_GSM_EPS=flat``) — ONE call for all blocks,
          sliced + reshaped (fewer RNG calls, more relayouts).  Neither
          layout has been timed on a GPU yet.
        """
        spec = self._eps_spec(nsamples)
        dtype = self.e_mean.dtype
        if GSM_EPS_LAYOUT == "flat":
            sizes = {n: math.prod(s) for n, s in spec.items()}
            flat = jax.random.normal(key, (sum(sizes.values()),), dtype)
            out, off = {}, 0
            for name, shape in spec.items():
                out[name] = flat[off:off + sizes[name]].reshape(shape)
                off += sizes[name]
            return out
        keys = jax.random.split(key, len(spec))
        return {name: jax.random.normal(k, shape, dtype)
                for k, (name, shape) in zip(keys, spec.items())}

    def _params_from_eps(self, eps):
        e = self.e_mean[None] + jnp.exp(0.5 * self.e_logvar)[None] * eps["e"]
        w = self.w_mean[None] + jnp.exp(0.5 * self.w_logvar)[None] * eps["w"]
        return e, w

    def _sample_params(self, key, nsamples: int):
        return self._params_from_eps(self._sample_eps(key, nsamples))

    def unit_params(self, e: jnp.ndarray, w: jnp.ndarray) -> Dict[str, Any]:
        """Trunk + affine map + links: embeddings → per-unit parameters.

        Returns a dict with ``mu, lam`` of shape (..., U, P, K, D),
        ``log_w`` (..., U, P, K) (K>1 only) and ``trans_logit``
        (..., U, P) (``learn_transitions`` only).
        """
        h = e
        if self.trunk_def is not None:
            h = self.trunk_def.apply(self.trunk_params, e)
        ones = jnp.ones(h.shape[:-1] + (1,), h.dtype)
        raw = jnp.concatenate([h, ones], axis=-1) @ w
        p, k, d = self.states_per_unit, self.n_comp, self.obs_dim
        em = raw[..., : self._emis_size].reshape(raw.shape[:-1] + (p, k, 2 * d))
        out = {
            "mu": em[..., :d],
            "lam": _softplus(em[..., d:]) + 1e-4,
            "log_w": None,
            "trans_logit": None,
        }
        off = self._emis_size
        if k > 1:
            logits = raw[..., off : off + self._weight_size]
            logits = logits.reshape(raw.shape[:-1] + (p, k))
            out["log_w"] = jax.nn.log_softmax(logits, axis=-1)
            off += self._weight_size
        if self.learn_transitions:
            out["trans_logit"] = raw[..., off : off + p]
        return out

    # ------------------------------------------------------------------
    def _normalize_stats(self, unit_stats) -> Dict[str, Any]:
        """Accept the array form (U, [P,] 4D) or the full stats dict."""
        if isinstance(unit_stats, dict):
            return unit_stats
        s = unit_stats
        if s.ndim == 2:
            s = s[:, None]
        return {"emission": s[..., None, :],  # (U, P, 1, 4D)
                "comp_counts": None, "self": None, "adv": None}

    def expected_llh_of_stats(
        self, unit_stats, unit_counts=None,
        key: Optional[jax.Array] = None, nsamples: int = 4,
        eps=None,
    ) -> jnp.ndarray:
        """Monte-Carlo E_q[Σ_u ⟨s_u, T(η(e_u))⟩ − c_u A_x(η(e_u))].

        ``unit_stats`` is either the emission stats array (U, P, 4D) in
        the diagonal-Normal layout [−½Σx², Σx, −½c, ½c] with
        ``unit_counts`` (U, P), or the dict of
        :func:`accumulate_unit_stats` (emission / comp_counts / self /
        adv entries, covering mixture weights and transitions).
        """
        st = self._normalize_stats(unit_stats)
        emission = st["emission"]                     # (U, P, K, 4D)
        if st.get("comp_counts") is None:
            counts = unit_counts
            if counts is None:
                raise ValueError(
                    "expected_llh_of_stats: the array form of unit_stats "
                    "carries no frame counts — pass unit_counts (U,) or "
                    "(U, P), or pass the accumulate_unit_stats dict"
                )
            if counts.ndim == 1:
                counts = counts[:, None]
            comp_counts = counts[..., None]           # (U, P, 1)
        else:
            comp_counts = st["comp_counts"]
        if eps is None:
            eps = self._sample_eps(key, nsamples)
        params = self.unit_params(*self._params_from_eps(eps))
        mu, lam = params["mu"], params["lam"]         # (S, U, P, K, D)
        d = self.obs_dim
        s_sq = emission[..., :d]                      # Σ −½x² per dim
        s_x = emission[..., d : 2 * d]                # Σ x per dim
        # ⟨s, T(θ)⟩ with T = [λ, λμ, λμ², log λ] and A_x folded in:
        # Σ_t log N(x_t|μ,λ⁻¹) = −½λΣx² + λμΣx − c(½λμ² − ½logλ + ½log2π)
        ll = (
            (s_sq * lam).sum(-1)
            + (s_x * (lam * mu)).sum(-1)
            - comp_counts[None] * (
                0.5 * (lam * mu**2) - 0.5 * jnp.log(lam) + 0.5 * LOG_2PI
            ).sum(-1)
        )                                             # (S, U, P, K)
        if params["log_w"] is not None:
            ll = ll + comp_counts[None] * params["log_w"]
        total = ll.sum(tuple(range(1, ll.ndim)))
        if self.learn_transitions and st.get("self") is not None:
            t = params["trans_logit"]                 # (S, U, P)
            trans_ll = (
                st["self"][None] * _log_sigmoid(t)
                + st["adv"][None] * _log_sigmoid(-t)
            )
            total = total + trans_ll.sum(tuple(range(1, trans_ll.ndim)))
        return total.mean()                           # MC average

    def kl_div_posterior_prior(self) -> jnp.ndarray:
        """KL of q(e) and q(W) vs standard-Normal priors (diagonal).

        The optional trunk is MAP-trained (deterministic, no KL) — the
        reference's nnet transform is likewise a point estimate.
        """

        def kl_diag(mean, logvar):
            return 0.5 * (jnp.exp(logvar) + mean**2 - 1.0 - logvar).sum()

        return kl_diag(self.e_mean, self.e_logvar) + kl_diag(
            self.w_mean, self.w_logvar
        )

    def elbo(self, unit_stats, unit_counts=None, key=None, nsamples: int = 4,
             eps=None):
        return (
            self.expected_llh_of_stats(
                unit_stats, unit_counts, key, nsamples, eps=eps)
            - self.kl_div_posterior_prior()
        )

    # ------------------------------------------------------------------
    def emission_expectations(self):
        """Posterior-mean unit emissions (μ, λ) for quick inspection.

        Shapes (U, P, D) when ``n_comp == 1`` (the historical layout),
        (U, P, K, D) otherwise.  For decoding, prefer the moment-matched
        :func:`apply_to_phoneloop` write-back.
        """
        p = self.unit_params(self.e_mean, self.w_mean)
        mu, lam = p["mu"], p["lam"]
        if self.n_comp == 1:
            mu, lam = mu[..., 0, :], lam[..., 0, :]
        return mu, lam


@struct.dataclass
class HierarchicalGSM(GSM):
    """H-SHMM: per-language embeddings entering the shared affine map.

    η(e_u, l_{g(u)}) = W·[e_u; l_{g(u)}; 1] — each unit u belongs to a
    language g(u); the language embedding shifts all of that language's
    units in parameter space while the subspace W is shared across
    languages (ICASSP'21 H-SHMM: multilingual AUD with a universal
    phonetic subspace).
    """

    lang_mean: jnp.ndarray = struct.field(default=None)     # (L, lang_dim)
    lang_logvar: jnp.ndarray = struct.field(default=None)
    # static unit→language map (tuple: hashable, not a differentiable leaf)
    unit_lang: tuple = struct.field(pytree_node=False, default=())
    lang_dim: int = struct.field(pytree_node=False, default=2)
    n_langs: int = struct.field(pytree_node=False, default=1)

    @classmethod
    def create(
        cls,
        n_units: int,
        embed_dim: int,
        obs_dim: int,
        lang_dim: int = 2,
        n_langs: int = 1,
        unit_lang=None,
        states_per_unit: int = 1,
        n_comp: int = 1,
        learn_transitions: bool = False,
        trunk: Optional[str] = None,
        key: Optional[jax.Array] = None,
        dtype=jnp.float32,
    ) -> "HierarchicalGSM":
        """``unit_lang`` maps each unit to its language (default: all 0)."""
        key = key if key is not None else jax.random.PRNGKey(0)
        k_base, k_lang = jax.random.split(key)
        if unit_lang is None:
            unit_lang = (0,) * n_units
        base = GSM.create(
            n_units, embed_dim + lang_dim, obs_dim,
            states_per_unit=states_per_unit, n_comp=n_comp,
            learn_transitions=learn_transitions, trunk=trunk,
            key=k_base, dtype=dtype,
        )
        # base was built with the *augmented* input width; restore the
        # true per-unit embedding shape
        e_mean = base.e_mean[:, :embed_dim]
        e_logvar = base.e_logvar[:, :embed_dim]
        return cls(
            e_mean=e_mean,
            e_logvar=e_logvar,
            w_mean=base.w_mean,
            w_logvar=base.w_logvar,
            trunk_params=base.trunk_params,
            trunk_def=base.trunk_def,
            lang_mean=0.1 * jax.random.normal(k_lang, (n_langs, lang_dim), dtype),
            lang_logvar=jnp.full((n_langs, lang_dim), -2.0, dtype),
            unit_lang=tuple(int(u) for u in unit_lang),
            n_units=n_units,
            embed_dim=embed_dim,
            obs_dim=obs_dim,
            states_per_unit=states_per_unit,
            n_comp=n_comp,
            learn_transitions=learn_transitions,
            lang_dim=lang_dim,
            n_langs=n_langs,
        )

    def _eps_spec(self, nsamples: int):
        spec = super()._eps_spec(nsamples)
        spec["l"] = (nsamples,) + self.lang_mean.shape
        return spec

    def _params_from_eps(self, eps):
        e = self.e_mean[None] + jnp.exp(0.5 * self.e_logvar)[None] * eps["e"]
        w = self.w_mean[None] + jnp.exp(0.5 * self.w_logvar)[None] * eps["w"]
        lang = (self.lang_mean[None]
                + jnp.exp(0.5 * self.lang_logvar)[None] * eps["l"])
        # each unit gets its own language's embedding
        idx = jnp.asarray(self.unit_lang, jnp.int32)
        lang_per_unit = lang[:, idx, :]              # (S, U, lang_dim)
        return jnp.concatenate([e, lang_per_unit], axis=-1), w

    def emission_expectations(self):
        idx = jnp.asarray(self.unit_lang, jnp.int32)
        e_in = jnp.concatenate([self.e_mean, self.lang_mean[idx]], axis=-1)
        p = self.unit_params(e_in, self.w_mean)
        mu, lam = p["mu"], p["lam"]
        if self.n_comp == 1:
            mu, lam = mu[..., 0, :], lam[..., 0, :]
        return mu, lam

    def kl_div_posterior_prior(self) -> jnp.ndarray:
        def kl_diag(mean, logvar):
            return 0.5 * (jnp.exp(logvar) + mean**2 - 1.0 - logvar).sum()

        return (
            super().kl_div_posterior_prior()
            + kl_diag(self.lang_mean, self.lang_logvar)
        )


def make_gsm_train_step(tx, nsamples: int = 4):
    """Jitted gradient step on the GSM ELBO given accumulated unit stats."""

    def step(gsm, opt_state, unit_stats, unit_counts, key):
        def loss_fn(g):
            return -g.elbo(unit_stats, unit_counts, key, nsamples)

        loss, grads = jax.value_and_grad(loss_fn)(gsm)
        updates, opt_state = tx.update(grads, opt_state, gsm)
        import optax

        gsm = optax.apply_updates(gsm, updates)
        return -loss, gsm, opt_state

    return jax.jit(step)


def make_gsm_train_scan(tx, nsamples: int = 4):
    """N gradient steps on the GSM ELBO compiled into ONE XLA program.

    ``make_gsm_train_step`` pays a host round-trip per step (recipe
    stage 7 runs 600 inner iterations x 6 outer).  Scanning the whole
    inner loop on-device removes it: one dispatch per outer
    iteration.  Returns ``run(gsm, opt_state, unit_stats, unit_counts,
    key, nsteps)`` -> ``(last_elbo, gsm, opt_state)``; ``nsteps`` is
    static (one compile per distinct value).
    """
    import optax

    def run(gsm, opt_state, unit_stats, unit_counts, key, nsteps: int):
        # The reparameterization noise is sampled IN the loop body:
        # presampling all steps' ε outside the scan (the
        # ``elbo(..., eps=)`` hook makes it a two-line change) would
        # stream ~39 MB of noise from HBM instead of generating it in
        # registers beside the contractions.
        def step(carry, k):
            g, opt = carry

            def loss_fn(g):
                return -g.elbo(unit_stats, unit_counts, k, nsamples)

            loss, grads = jax.value_and_grad(loss_fn)(g)
            updates, opt = tx.update(grads, opt, g)
            g = optax.apply_updates(g, updates)
            return (g, opt), -loss

        keys = jax.random.split(key, nsteps)
        (gsm, opt_state), elbos = jax.lax.scan(
            step, (gsm, opt_state), keys)
        return elbos[-1], gsm, opt_state

    return jax.jit(run, static_argnames="nsteps")


# ----------------------------------------------------------------------
# Phone-loop bridge (SHMM training loop, SURVEY §3.5)
# ----------------------------------------------------------------------
def accumulate_unit_stats(loop, data, mask=None, transitions: bool = False):
    """Per-unit-state statistics from a phone-loop E-step.

    Default: (stats (U, P, 4D), counts (U, P)) — the emission-only
    layout :meth:`GSM.expected_llh_of_stats` consumes directly.  With
    ``transitions=True`` returns the full stats dict adding per-state
    expected self-loop and advance/exit counts (``self`` / ``adv``,
    (U, P) each) for the transition subspace, and per-component stats
    when the loop's emissions are a per-state GMM (``MixtureSet``):
    ``emission`` (U, P, K, 4D) + ``comp_counts`` (U, P, K).
    """
    from beer_tpu.dists import normallik
    from beer_tpu.models.mixture import MixtureSet
    from beer_tpu.ops import semiring_scan

    x = data if data.ndim == 3 else data[None]
    b, t_len, d = x.shape
    if mask is None:
        mask = jnp.ones((b, t_len), x.dtype)
    stats = loop.sufficient_statistics(x)
    # this bridge needs the materialized posteriors of the E-step cache
    _, cache = loop.infer(stats, mask=mask)
    post = cache["posteriors"]                      # (B, T, S)
    u, p = loop.n_units, loop.states_per_unit
    s_states = u * p
    diag_stats = normallik.suff_stats_diag(x).reshape(-1, 4 * d)

    is_mixture = isinstance(loop.modelset, MixtureSet)
    if is_mixture:
        inner = loop.modelset
        k = inner.ncomp_per_mix
        comp_stats = inner.modelset.sufficient_statistics(x)
        per_comp = inner.modelset.expected_log_likelihood(comp_stats)
        per_comp = per_comp.reshape(b, t_len, s_states, k)
        log_w = inner.weights.expected_sufficient_statistics()
        within = jax.nn.softmax(per_comp + log_w, axis=-1)
        comp_resps = within * post[..., None]       # (B, T, S, K)
        flat_cr = comp_resps.reshape(-1, s_states * k)
        acc = jnp.einsum(
            "tc,tp->cp", flat_cr, diag_stats,
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(u, p, k, 4 * d)
        comp_counts = flat_cr.sum(0).reshape(u, p, k)
        emission, counts = acc, comp_counts
    else:
        flat_post = post.reshape(-1, s_states)
        acc = jnp.einsum(
            "ts,tp->sp", flat_post, diag_stats,
            precision=jax.lax.Precision.HIGHEST,
        )
        emission = acc.reshape(u, p, 1, 4 * d)
        counts = flat_post.sum(0).reshape(u, p, 1)

    if not transitions:
        if is_mixture:
            return {"emission": emission, "comp_counts": counts,
                    "self": None, "adv": None}, counts.sum(-1)
        return emission[..., 0, :], counts[..., 0]

    fb = cache["fb"]
    graph = cache["graph"]
    xi = semiring_scan.expected_transition_counts_probs(
        fb, graph.log_trans, mask,
    )                                               # (S, S)
    self_counts = jnp.diagonal(xi).reshape(u, p)
    # advance: within-unit forward arcs for non-final states; for final
    # states, exits = loop-backs to any unit start + end-of-sequence mass
    adv = jnp.zeros((s_states,), xi.dtype)
    st = jnp.arange(s_states - 1)
    adv = adv.at[st].set(xi[st, st + 1])
    ends = jnp.arange(u) * p + (p - 1)
    starts = jnp.arange(u) * p
    loopback = xi[ends][:, starts].sum(-1)          # (U,)
    last_idx = jnp.maximum(mask.sum(-1).astype(jnp.int32) - 1, 0)
    gamma_last = post[jnp.arange(b), last_idx]      # (B, S)
    final_mass = (gamma_last * (mask.sum(-1) > 0)[:, None]).sum(0)
    adv = adv.at[ends].set(loopback + final_mass[ends])
    return {
        "emission": emission,
        "comp_counts": counts,
        "self": self_counts,
        "adv": adv.reshape(u, p),
    }, counts.sum(-1)


# ----------------------------------------------------------------------
# Moment-matched posterior write-back
# ----------------------------------------------------------------------
def _inv_digamma(y: jnp.ndarray, iters: int = 15) -> jnp.ndarray:
    """ψ⁻¹(y) by Newton (Minka's init)."""
    x = jnp.where(y >= -2.22, jnp.exp(y) + 0.5, -1.0 / (y - digamma(1.0)))
    for _ in range(iters):
        x = x - (digamma(x) - y) / polygamma(1, x)
        x = jnp.maximum(x, 1e-6)
    return x


def _gamma_from_moments(e_lam, e_loglam, iters: int = 20,
                        max_shape: float = 1e5):
    """(a, b) of a Gamma matching E[λ] and E[log λ] (Newton on
    ψ(a) − log a = E[logλ] − log E[λ]).

    ``max_shape`` bounds the matched pseudo-count: a nearly-deterministic
    subspace posterior drives c → 0⁻ and a → ∞, and natural parameters
    of that magnitude make the f32 Bregman-KL evaluation pure
    cancellation noise (observed as ±1e10 ELBO garbage in float32) without
    changing the induced E[T] measurably."""
    c = jnp.minimum(e_loglam - jnp.log(e_lam), -0.5 / max_shape)
    a = -0.5 / c                                    # ψ(a)−ln a ≈ −1/(2a)
    for _ in range(iters):
        f = digamma(a) - jnp.log(a) - c
        fp = polygamma(1, a) - 1.0 / a
        a = jnp.clip(a - f / fp, a * 0.1, a * 10.0)
        a = jnp.clip(a, 1e-3, max_shape)
    return a, a / e_lam


def _dirichlet_from_elogw(elogw: jnp.ndarray, iters: int = 30) -> jnp.ndarray:
    """Dirichlet α matching E[log w] per row (axis -1).

    Newton on g_k = ψ(α_k) − ψ(α₀) − y_k with the Jacobian's
    diag(ψ'(α_k)) − ψ'(α₀)·11ᵀ structure inverted by Sherman–Morrison
    (Minka's fixed point converges too slowly for a tight match).
    """
    alpha = _inv_digamma(elogw)  # warm start: ignore the shared ψ(α₀)
    for _ in range(iters):
        a0 = alpha.sum(-1, keepdims=True)
        g = digamma(alpha) - digamma(a0) - elogw
        q = polygamma(1, alpha)
        c = polygamma(1, a0)
        gq = (g / q).sum(-1, keepdims=True)
        iq = (1.0 / q).sum(-1, keepdims=True)
        delta = g / q + (c * gq / (1.0 - c * iq)) / q
        alpha = jnp.maximum(alpha - delta, alpha * 0.1)
    return alpha


def induced_posterior_moments(gsm: GSM, key=None, nsamples: int = 64):
    """MC moments of q(η(e_u)): E[λ], E[λμ], E[λμ²], E[log λ]
    (each (U, P, K, D)) + E[log w] (U, P, K) and E[log σ], E[log(1−σ)]
    (U, P) when those heads exist."""
    key = key if key is not None else jax.random.PRNGKey(0)
    p = gsm.unit_params(*gsm._sample_params(key, nsamples))
    mu, lam = p["mu"], p["lam"]
    out = {
        "e_lam": lam.mean(0),
        "e_lam_mu": (lam * mu).mean(0),
        "e_lam_mu2": (lam * mu**2).mean(0),
        "e_log_lam": jnp.log(lam).mean(0),
    }
    if p["log_w"] is not None:
        out["e_log_w"] = p["log_w"].mean(0)
    if p["trans_logit"] is not None:
        t = p["trans_logit"]
        out["e_log_self"] = _log_sigmoid(t).mean(0)
        out["e_log_adv"] = _log_sigmoid(-t).mean(0)
    return out


def apply_to_phoneloop(gsm: GSM, loop, key=None, nsamples: int = 64,
                       confidence: Union[float, None] = None):
    """Write the subspace posterior back into a phone loop.

    Moment matching: the Monte-Carlo moments of q(η(e_u)) (E[λ], E[λμ],
    E[λμ²], E[log λ] per dimension) determine a NormalGamma posterior
    with *identical expected sufficient statistics* — the phone-loop
    E-step's ELLH depends on the emissions only through E[T(θ)], so the
    written-back loop runs the exact subspace-marginalized E-step (to
    MC accuracy).  Mixture weights are Dirichlet-matched from E[log w];
    learned transitions land in ``base_log_trans`` / ``log_exit`` as
    expected log-probabilities (VB geometric-mean parameters).

    ``confidence`` (legacy): if given, skip moment matching and write
    sharp posteriors at the posterior-mean point estimate.
    """
    from beer_tpu.models.mixture import MixtureSet

    d = gsm.obs_dim
    if confidence is not None:
        mu, lam = gsm.emission_expectations()
        mu, lam = mu.reshape(-1, d), lam.reshape(-1, d)
        m1 = lam
        a = jnp.full_like(lam, confidence)
        b = a / lam
        kappa = jnp.full_like(lam, confidence)
        m = mu
    else:
        mom = induced_posterior_moments(gsm, key, nsamples)
        m1 = mom["e_lam"].reshape(-1, d)
        m2 = mom["e_lam_mu"].reshape(-1, d)
        m3 = mom["e_lam_mu2"].reshape(-1, d)
        m4 = mom["e_log_lam"].reshape(-1, d)
        a, b = _gamma_from_moments(m1, m4)
        m = m2 / m1
        # 1/κ; the 1e-5 floor caps κ at 1e5 — sharper pseudo-counts only
        # feed f32 log-norm cancellation (see _gamma_from_moments)
        var_term = jnp.maximum(m3 - m2**2 / m1, 1e-5)
        kappa = 1.0 / var_term

    modelset = loop.modelset
    is_mixture = isinstance(modelset, MixtureSet)
    nset = modelset.modelset if is_mixture else modelset
    fam = nset.means_precisions.family
    nat = fam.to_nat(m, kappa, a, b)
    nset = nset.replace(
        means_precisions=nset.means_precisions.replace(posterior=nat)
    )
    if is_mixture:
        modelset = modelset.replace(modelset=nset)
        if gsm.n_comp > 1 and confidence is None:
            alpha = _dirichlet_from_elogw(
                mom["e_log_w"].reshape(modelset.nmix, gsm.n_comp)
            )
            wfam = modelset.weights.family
            modelset = modelset.replace(
                weights=modelset.weights.replace(posterior=wfam.to_nat(alpha))
            )
    else:
        modelset = nset
    loop = loop.replace(modelset=modelset)

    if gsm.learn_transitions and confidence is None:
        u, p = gsm.n_units, gsm.states_per_unit
        e_self = mom["e_log_self"].reshape(u * p)
        e_adv = mom["e_log_adv"].reshape(u * p)
        base = loop.base_log_trans
        st = jnp.arange(u * p)
        base = base.at[st, st].set(e_self)
        nonfinal = jnp.asarray(
            [s for s in range(u * p) if (s % p) != p - 1], jnp.int32
        )
        if nonfinal.size:
            base = base.at[nonfinal, nonfinal + 1].set(e_adv[nonfinal])
        ends = jnp.arange(u) * p + (p - 1)
        log_exit = e_adv[ends] - math.log(2.0)       # split loop/final
        loop = loop.replace(base_log_trans=base, log_exit=log_exit)
    return loop
