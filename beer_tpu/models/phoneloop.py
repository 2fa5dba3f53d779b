"""Phone-loop model for acoustic unit discovery (AUD).

Reference parity: ``beer/models/phoneloop.py`` (PhoneLoop,
PhoneLoop.create) — the flagship use case (SURVEY.md §0, §3.3, BASELINE
config 4): a loop over N left-to-right unit HMMs with a Bayesian
(truncated stick-breaking / Dirichlet) prior over units, trained
unsupervised, decoded to unit transcriptions.

Design: the within-unit topology is a *fixed* compiled graph; the
unit-level language model enters the transition matrix dynamically each
E-step as exp(E[log π]) (VB geometric-mean parameters):

* ``log_init[start_v]             = E[log π_v]``
* ``log_trans[end_u, start_v]     = log((1−sl)/2) + E[log π_v]``
* ``log_final[end_u]              = log((1−sl)/2)``

so the conjugate update of the unit prior consumes exact expected unit
counts: first-frame occupancy of each unit's start state + the ξ-counts
of all loop-back arcs (overflow-safe chunked computation in
:func:`beer_tpu.ops.semiring_scan.expected_transition_counts`).

State/pdf layout: unit u owns states and pdfs [u·P, (u+1)·P).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import jax.numpy as jnp
import numpy as np

from beer_tpu.models.basemodel import DiscreteLatentModel
from beer_tpu.models.categorical import SBCategorical
from beer_tpu.models.graph import LOG_ZERO, CompiledGraph
from beer_tpu.ops import semiring_scan
from beer_tpu.utils import struct


def _promote(x: jnp.ndarray) -> jnp.ndarray:
    return x[None] if x.ndim == 2 else x


@struct.dataclass
class PhoneLoop(DiscreteLatentModel):
    """Loop of left-to-right unit HMMs with a Bayesian unit prior."""

    modelset: Any                  # emissions over U*P pdfs
    unit_prior: Any                # SBCategorical / Categorical over U units
    base_log_trans: jnp.ndarray    # (S, S) within-unit transitions only
    # per-unit E[log exit] of each end state (set by the GSM transition
    # write-back); None = derive from the static self_loop as created
    log_exit: Optional[jnp.ndarray] = None
    n_units: int = struct.field(pytree_node=False, default=1)
    states_per_unit: int = struct.field(pytree_node=False, default=1)
    self_loop: float = struct.field(pytree_node=False, default=0.5)

    # ------------------------------------------------------------------
    @classmethod
    def create(
        cls,
        n_units: int,
        states_per_unit: int,
        modelset,
        unit_prior=None,
        concentration: float = 1.0,
        self_loop: float = 0.5,
        dtype=jnp.float32,
    ) -> "PhoneLoop":
        if unit_prior is None:
            unit_prior = SBCategorical.create(n_units, concentration, dtype)
        s = n_units * states_per_unit
        base = np.full((s, s), LOG_ZERO)
        log_sl = math.log(self_loop)
        log_adv = math.log(1.0 - self_loop)
        for u in range(n_units):
            for i in range(states_per_unit):
                st = u * states_per_unit + i
                base[st, st] = log_sl
                if i + 1 < states_per_unit:
                    base[st, st + 1] = log_adv
        return cls(
            modelset=modelset,
            unit_prior=unit_prior,
            base_log_trans=jnp.asarray(base, dtype),
            n_units=n_units,
            states_per_unit=states_per_unit,
            self_loop=self_loop,
        )

    # -- structural indices (static shapes) -----------------------------
    @property
    def _starts(self) -> jnp.ndarray:
        return jnp.arange(self.n_units, dtype=jnp.int32) * self.states_per_unit

    @property
    def _ends(self) -> jnp.ndarray:
        return self._starts + self.states_per_unit - 1

    @property
    def n_states(self) -> int:
        return self.n_units * self.states_per_unit

    def _log_exit(self) -> float:
        # An end state leaves with (1−sl), split evenly: loop vs stop.
        return math.log((1.0 - self.self_loop) * 0.5)

    def _effective_graph(self) -> CompiledGraph:
        dtype = self.base_log_trans.dtype
        elogw = self.unit_prior.expected_log_weights().astype(dtype)  # (U,)
        if self.log_exit is not None:
            log_exit = self.log_exit.astype(dtype)            # (U,)
        else:
            log_exit = jnp.full(self.n_units, self._log_exit(), dtype)
        loop_block = log_exit[:, None] + elogw[None, :]
        trans = self.base_log_trans.at[
            self._ends[:, None], self._starts[None, :]
        ].set(loop_block)
        init = jnp.full(self.n_states, LOG_ZERO, dtype).at[self._starts].set(elogw)
        final = (
            jnp.full(self.n_states, LOG_ZERO, dtype)
            .at[self._ends]
            .set(log_exit)
        )
        return CompiledGraph(
            log_init=init,
            log_final=final,
            log_trans=trans,
            pdf_ids=jnp.arange(self.n_states, dtype=jnp.int32),
            n_states=self.n_states,
            n_pdfs=self.n_states,
        )

    def _structured_trans(self, dtype):
        """Band + rank-1 probability-space factorization of the
        effective transition matrix: (a_self, a_adv, exit, w) with
        ``semiring_scan.bands_to_dense(...) == exp(log_trans)`` exactly
        (tested).  Lets Viterbi decoding run in O(S) per step instead of
        building a (B, S, S) candidate tensor."""
        p = self.states_per_unit
        s = self.n_states
        # Bands come from base_log_trans, NOT the scalar self_loop: the
        # subspace write-back (gsm.apply_to_phoneloop with learned
        # transitions) stores PER-STATE self/advance log-probs there,
        # and the scalar would silently misroute every banded decode
        # afterwards (banded Viterbi scores 17 log-units off on a
        # trained H-SHMM loop).
        if p == 1:
            # the dense builder *overwrites* every (end, start) entry —
            # with P == 1 that is the whole matrix, bands are empty
            a_self = jnp.zeros(s, dtype)
            a_adv = jnp.zeros(s, dtype)
        else:
            a_self = jnp.exp(jnp.diagonal(self.base_log_trans)).astype(dtype)
            ids = jnp.arange(s - 1)
            sup = jnp.exp(self.base_log_trans[ids, ids + 1])
            a_adv = jnp.concatenate(
                [sup, jnp.zeros(1, self.base_log_trans.dtype)]
            ).astype(dtype)
            # (end, start) entries are overwritten by the loop block in
            # the dense builder; mirror that here
            a_adv = a_adv.at[self._ends].set(0.0)
        elogw = self.unit_prior.expected_log_weights().astype(dtype)
        if self.log_exit is not None:
            exit_u = jnp.exp(self.log_exit.astype(dtype))
        else:
            exit_u = jnp.full(self.n_units, math.exp(self._log_exit()), dtype)
        exit_scat = jnp.zeros(s, dtype).at[self._ends].set(exit_u)
        w_scat = jnp.zeros(s, dtype).at[self._starts].set(jnp.exp(elogw))
        return (a_self, a_adv, exit_scat, w_scat)

    # ------------------------------------------------------------------
    def sufficient_statistics(self, data: jnp.ndarray) -> jnp.ndarray:
        return self.modelset.sufficient_statistics(_promote(data))

    def infer(self, stats: jnp.ndarray, mask: Optional[jnp.ndarray] = None):
        """E-step with materialized posteriors in the cache (also the
        entry point for consumers that need per-frame posteriors, e.g.
        the GSM stats bridge)."""
        graph = self._effective_graph()
        llh_states = self.modelset.expected_log_likelihood(stats)
        fb = semiring_scan.forward_backward_probs(
            llh_states, graph.log_trans, graph.log_init, graph.log_final,
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
            "graph": graph,
        }

    def _unit_counts(self, cache: Dict[str, Any]) -> jnp.ndarray:
        """Expected number of times each unit is selected."""
        fb = cache["fb"]
        graph = cache["graph"]
        xi = semiring_scan.expected_transition_counts_probs(
            fb, graph.log_trans, cache["mask"],
            rows=self._ends, cols=self._starts,
        )
        loop_counts = xi.sum(0)
        init_counts = fb.posteriors[:, 0, :][:, self._starts].sum(0)
        return loop_counts + init_counts

    def accumulate(self, stats: jnp.ndarray, cache: Dict[str, Any]) -> Dict[str, Any]:
        post = cache["posteriors"]  # (B, T, S); pdf_ids are the identity here
        flat_resps = post.reshape(-1, self.n_states)
        flat_stats = stats.reshape((-1,) + stats.shape[2:])
        return {
            "modelset": self.modelset.accumulate(flat_stats, flat_resps),
            "unit_prior": self.unit_prior.accumulate_counts(self._unit_counts(cache)),
        }

    def kl_div_posterior_prior(self) -> jnp.ndarray:
        return (
            self.modelset.kl_div_posterior_prior()
            + self.unit_prior.kl_div_posterior_prior()
        )

    def vb_update(self, acc: Dict[str, Any], lrate: float = 1.0) -> "PhoneLoop":
        return self.replace(
            modelset=self.modelset.vb_update(acc["modelset"], lrate),
            unit_prior=self.unit_prior.vb_update(acc["unit_prior"], lrate),
        )

    def mean_field_factorization(self):
        """Coordinate-ascent groups: emissions, then the unit prior —
        the q(θ_emis)·q(π) mean-field split of the AUD papers."""
        return [["modelset"], ["unit_prior"]]

    # ------------------------------------------------------------------
    def decode(self, data: jnp.ndarray, mask: Optional[jnp.ndarray] = None):
        """Viterbi: returns (state paths (B, T), scores (B,)).

        Runs through the band + rank-1 factorization
        (:func:`semiring_scan.viterbi_banded`): O(B·S) per step instead
        of the dense path's (B, S, S) candidate tensor — the loop
        topology guarantees the factorization is exact
        (:meth:`_structured_trans`)."""
        graph = self._effective_graph()
        stats = self.sufficient_statistics(data)
        llh_states = self.modelset.expected_log_likelihood(stats)
        bands = self._structured_trans(llh_states.dtype)
        return semiring_scan.viterbi_banded(
            llh_states, bands, graph.log_init, graph.log_final, mask
        )

    def decode_units(self, data: jnp.ndarray, mask: Optional[jnp.ndarray] = None):
        """Per-frame unit labels (B, T) = state path // states_per_unit."""
        paths, scores = self.decode(data, mask)
        return paths // self.states_per_unit, scores
