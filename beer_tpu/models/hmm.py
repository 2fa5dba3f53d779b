"""Bayesian HMM.

Reference parity: ``beer/models/hmm.py`` (HMM, HMM.create(graph,
modelset), forward-backward E-step, ``decode``/best_path Viterbi) — see
SURVEY.md §3.2 for the reference call stack.  The E-step here is the
batched scan of :mod:`beer_tpu.ops.semiring_scan` (whole padded batch in
one XLA program) instead of a per-utterance Python loop.

Transition probabilities may be fixed by the compiled graph or given a
per-row Dirichlet treatment over each state's *allowed* arcs
(``learn_transitions=True``): the E-step then uses E[log A] (digammas)
and ``accumulate`` adds the expected ξ transition counts — the
reference's "pairwise posteriors → Dirichlet stats per state" path.
Bayesian treatment of the *unit* transitions of a phone loop is layered
on by :class:`beer_tpu.models.phoneloop.PhoneLoop`.

Conventions: data (B, T, D) + mask (B, T); single sequences (T, D) are
auto-promoted.  ``infer`` returns per-*sequence* expected
log-likelihoods (the forward log-normalizer), matching the reference's
``datasize`` = number of utterances convention.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
from jax.scipy.special import digamma, gammaln

from beer_tpu.models.basemodel import DiscreteLatentModel
from beer_tpu.models.graph import LOG_ZERO, CompiledGraph, Graph
from beer_tpu.ops import semiring_scan
from beer_tpu.utils import struct


def _promote(x: jnp.ndarray) -> jnp.ndarray:
    return x[None] if x.ndim == 2 else x


@struct.dataclass
class HMM(DiscreteLatentModel):
    """HMM with any ModelSet as tied-state emissions."""

    graph: CompiledGraph
    modelset: Any
    # per-row Dirichlet over allowed arcs (None = fixed graph transitions)
    trans_alpha_prior: Optional[jnp.ndarray] = None   # (S, S), 0 = forbidden
    trans_alpha_post: Optional[jnp.ndarray] = None

    @classmethod
    def create(
        cls, graph, modelset,
        learn_transitions: bool = False,
        trans_prior_strength: float = 1.0,
    ) -> "HMM":
        if isinstance(graph, Graph):
            graph = graph.compile()
        prior = post = None
        if learn_transitions:
            # prior concentration ∝ the graph's arc probabilities (scaled),
            # zero on forbidden arcs
            probs = jnp.exp(graph.log_trans)
            prior = jnp.where(
                graph.log_trans > LOG_ZERO / 2, trans_prior_strength * probs, 0.0
            )
            post = prior
        return cls(
            graph=graph, modelset=modelset,
            trans_alpha_prior=prior, trans_alpha_post=post,
        )

    # -- Bayesian transitions -------------------------------------------
    def _effective_log_trans(self) -> jnp.ndarray:
        if self.trans_alpha_post is None:
            return self.graph.log_trans
        a = self.trans_alpha_post
        allowed = self.trans_alpha_prior > 0
        row_sum = jnp.where(allowed, a, 0.0).sum(-1, keepdims=True)
        e_log = digamma(jnp.where(allowed, a, 1.0)) - digamma(
            jnp.maximum(row_sum, 1e-30)
        )
        return jnp.where(allowed, e_log, LOG_ZERO)

    def _trans_kl(self) -> jnp.ndarray:
        """Σ_rows KL(Dir(α_post)‖Dir(α_prior)) over each row's allowed arcs."""
        if self.trans_alpha_post is None:
            return jnp.asarray(0.0)
        a_q, a_p = self.trans_alpha_post, self.trans_alpha_prior
        allowed = a_p > 0
        aq = jnp.where(allowed, a_q, 1.0)
        ap = jnp.where(allowed, a_p, 1.0)
        q_sum = jnp.where(allowed, a_q, 0.0).sum(-1)
        p_sum = jnp.where(allowed, a_p, 0.0).sum(-1)
        has_arcs = q_sum > 0
        dig = digamma(aq) - digamma(jnp.maximum(q_sum, 1e-30))[:, None]
        per_row = (
            gammaln(jnp.maximum(q_sum, 1e-30))
            - jnp.where(allowed, gammaln(aq), 0.0).sum(-1)
            - gammaln(jnp.maximum(p_sum, 1e-30))
            + jnp.where(allowed, gammaln(ap), 0.0).sum(-1)
            + (jnp.where(allowed, (a_q - a_p) * dig, 0.0)).sum(-1)
        )
        return jnp.where(has_arcs, per_row, 0.0).sum()

    # ------------------------------------------------------------------
    def sufficient_statistics(self, data: jnp.ndarray) -> jnp.ndarray:
        return self.modelset.sufficient_statistics(_promote(data))

    def _state_llh(self, stats: jnp.ndarray) -> jnp.ndarray:
        per_pdf = self.modelset.expected_log_likelihood(stats)  # (B, T, n_pdfs)
        return self.graph.expand_llh(per_pdf)

    def infer(self, stats: jnp.ndarray, mask: Optional[jnp.ndarray] = None):
        log_trans = self._effective_log_trans()
        llh_states = self._state_llh(stats)
        fb = semiring_scan.forward_backward_probs(
            llh_states,
            log_trans,
            self.graph.log_init,
            self.graph.log_final,
            mask,
        )
        log_z = fb.log_z
        if mask is not None:
            # fully-padded utterances (minibatch tail padding) contribute 0
            log_z = log_z * (mask.sum(-1) > 0)
        return log_z, {
            "posteriors": fb.posteriors,
            "fb": fb,
            "llh_states": llh_states,
            "mask": mask,
            "log_trans": log_trans,
        }

    def accumulate(self, stats: jnp.ndarray, cache: Dict[str, Any]) -> Dict[str, Any]:
        post = cache["posteriors"]  # (B, T, S)
        # state → pdf posteriors (states sharing a pdf sum together)
        one_hot = jax.nn.one_hot(self.graph.pdf_ids, self.graph.n_pdfs, dtype=post.dtype)
        if one_hot.ndim == 3:  # per-utterance graphs: (B, S, n_pdfs)
            # HIGHEST: a default-precision pass bf16-rounds the posteriors
            pdf_post = jnp.einsum("bts,bsp->btp", post, one_hot,
                                  precision=jax.lax.Precision.HIGHEST)
        else:
            pdf_post = post @ one_hot  # (B, T, n_pdfs)
        flat_resps = pdf_post.reshape(-1, self.graph.n_pdfs)
        flat_stats = stats.reshape((-1,) + stats.shape[2:])
        acc = {"modelset": self.modelset.accumulate(flat_stats, flat_resps)}
        if self.trans_alpha_post is not None:
            acc["trans"] = semiring_scan.expected_transition_counts_probs(
                cache["fb"], cache["log_trans"], cache["mask"],
            )
        return acc

    def kl_div_posterior_prior(self) -> jnp.ndarray:
        return self.modelset.kl_div_posterior_prior() + self._trans_kl()

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "HMM":
        new = self.replace(
            modelset=self.modelset.vb_update(acc["modelset"], lrate)
        )
        if self.trans_alpha_post is not None and "trans" in acc:
            counts = jnp.where(self.trans_alpha_prior > 0, acc["trans"], 0.0)
            target = self.trans_alpha_prior + counts
            new_post = self.trans_alpha_post + lrate * (
                target - self.trans_alpha_post
            )
            new = new.replace(trans_alpha_post=new_post)
        return new

    def mean_field_factorization(self):
        """Coordinate-ascent groups: emissions, then transitions (if
        Bayesian) — the reference's q(θ_emis)·q(A) factorization."""
        if self.trans_alpha_post is None:
            return [["modelset"]]
        return [["modelset"], ["trans_alpha_post"]]

    # ------------------------------------------------------------------
    def posteriors(self, data: jnp.ndarray,
                   mask: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        """Per-frame state occupancies γ (B, T, S).

        Diagnostic entry point (reference `DiscreteLatentModel.posteriors`)."""
        stats = self.sufficient_statistics(data)
        fb = semiring_scan.forward_backward_probs(
            self._state_llh(stats),
            self._effective_log_trans(),
            self.graph.log_init,
            self.graph.log_final,
            mask,
        )
        return fb.posteriors

    def expected_transition_counts(self, cache: Dict[str, Any]) -> jnp.ndarray:
        """E[#transitions i→j] summed over the batch, (S, S)."""
        # use the cache's effective log-trans (includes the learned
        # Dirichlet posterior when learn_transitions=True) — ξ must be
        # computed under the same matrix that produced the fb cache
        return semiring_scan.expected_transition_counts_probs(
            cache["fb"], cache.get("log_trans", self.graph.log_trans),
            cache["mask"],
        )

    def decode(self, data: jnp.ndarray, mask: Optional[jnp.ndarray] = None):
        """Viterbi best state path; returns (paths (B, T), scores (B,))."""
        stats = self.sufficient_statistics(data)
        llh_states = self._state_llh(stats)
        log_trans = self._effective_log_trans()
        if (getattr(self.graph, "l2r_banded", False)
                and log_trans.ndim == 2 and log_trans.shape[0] >= 64):
            # shared left-to-right graph (forced alignment): the matrix
            # is diagonal + first superdiagonal — decode through the
            # banded (max,+) route (O(B·S) per step instead of a
            # (B, S, S) candidate tensor) with an empty loop-back
            # family.  Exact: learned transitions only reweight the
            # existing arcs.  Small graphs keep the dense scan.
            s = log_trans.shape[0]
            ids = jnp.arange(s - 1)
            a_self = jnp.exp(jnp.diagonal(log_trans))
            a_adv = jnp.concatenate(
                [jnp.exp(log_trans[ids, ids + 1]),
                 jnp.zeros(1, log_trans.dtype)])
            zeros = jnp.zeros(s, log_trans.dtype)
            return semiring_scan.viterbi_banded(
                llh_states, (a_self, a_adv, zeros, zeros),
                self.graph.log_init, self.graph.log_final, mask,
            )
        return semiring_scan.viterbi(
            llh_states,
            log_trans,
            self.graph.log_init,
            self.graph.log_final,
            mask,
        )
