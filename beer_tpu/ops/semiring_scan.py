"""HMM recursions as batched scans in the log semiring.

Reference parity: ``beer/models/hmm.py`` forward/backward/viterbi — but
where the reference runs a Python ``for t in range(T)`` loop of
``logsumexp`` steps per utterance (its single biggest performance sin,
SURVEY.md §3.2), these are whole-batch XLA programs:

* :func:`forward_backward` — the **scaled** recursions: carries are
  normalized probabilities plus a per-sequence log-scale, one (B, S) @
  (S, S) product per step, exp(llh) is hoisted out of the scan, and the
  only in-step transcendental is one log on the (B, 1) normalizer.
  :func:`forward_backward_probs` (the training path) runs the whole
  T-loop as one Pallas kernel on a GPU (:mod:`beer_tpu.ops.triton_scan`);
  per-utterance-graph batches use the ``lax.scan`` path.  Posteriors are per-frame softmaxes of α+β and
  ξ-counts use per-frame-normalized factors — both independent of any
  probability floor the scaled carries introduce.
* :func:`forward_assoc` — ``lax.associative_scan`` over log-transition
  operators (O(log T) depth, per "Temporal Parallelization of Inference
  in HMMs", arXiv:2102.05743) for few-long-sequences workloads.
* :func:`viterbi` — (max, +) scan with backpointers and a reverse-scan
  backtrace, fully jittable.

Ragged batches use pad-and-mask: masked steps are identity (carry passes
through), so the final carry equals the value at each sequence's true
length — no gather needed.

Conventions: ``llh`` (B, T, S) frame log-likelihoods; ``log_trans``
(S, S) with [i, j] = log p(j | i) — or (B, S, S) for *per-utterance*
graphs (supervised training on transcription-specific graphs);
``log_init`` / ``log_final`` (S,) or (B, S); ``mask`` (B, T) 1.0 for
real frames.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from beer_tpu.ops import triton_scan

_NEG_INF = -1e30  # avoids (-inf) - (-inf) = nan in masked/unreachable states


class FBResult(NamedTuple):
    log_alpha: jnp.ndarray   # (B, T, S)
    log_beta: jnp.ndarray    # (B, T, S)
    log_z: jnp.ndarray       # (B,)
    posteriors: jnp.ndarray  # (B, T, S), zero on padded frames


class FBProbs(NamedTuple):
    """Probability-space smoothing result (the training hot path).

    All fields come straight out of the scaled forward pass and the
    fused v-space backward/smoothing pass — **no (B, T, S) log/exp
    passes and no log_α/log_β materialization**:

      posteriors γ_t = α̂_t·β̂_t / Σ_s α̂_t·β̂_t   (≡ softmax(logα+logβ))
      ξ_t ∝ outer(α̂_t, probs_w_{t+1}) ⊙ A        with the exact uᵀAw
            normalizer recovered from (fwd_log_scales, post_norm,
            w_sums) — see :func:`expected_transition_counts_probs`.
    """

    probs_fwd: jnp.ndarray   # (B, T, S) α̂ (per-frame normalized)
    posteriors: jnp.ndarray  # (B, T, S) γ, zero on padded frames
    probs_w: jnp.ndarray     # (B, T, S) normalize(e_llh·β̂) per frame
    w_sums: jnp.ndarray      # (B, T) Σ_s e_llh_t(s)·β̂_t(s)
    post_norm: jnp.ndarray   # (B, T) Σ_s α̂_t(s)·β̂_t(s) (pre-mask)
    fwd_log_scales: jnp.ndarray  # (B, T) cumulative log-scale of α̂
    log_z: jnp.ndarray       # (B,)


def _clamp(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.maximum(x, _NEG_INF)


def forward(
    llh: jnp.ndarray,
    log_trans: jnp.ndarray,
    log_init: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched forward recursion (log-carry variant).

    Returns (log_alpha (B, T, S), final carry (B, S)).  The scaled
    variant :func:`forward_scaled` is the fast path used by
    :func:`forward_backward`; this one is kept as the readable reference
    (tests assert they match).
    """
    b, t_len, s = llh.shape
    if mask is None:
        mask = jnp.ones((b, t_len), llh.dtype)
    trans = jnp.exp(log_trans)  # probabilities in [0, 1] — safe to exp
    batched_trans = trans.ndim == 3  # per-utterance graphs (B, S, S)
    alpha0 = _clamp(log_init + llh[:, 0]) * mask[:, 0:1] + (1 - mask[:, 0:1]) * 0.0

    def step(carry, inp):
        llh_t, m_t = inp  # (B, S), (B, 1)
        shift = jnp.max(carry, axis=-1, keepdims=True)
        scaled = jnp.exp(carry - shift)
        if batched_trans:
            prod = jnp.einsum(
                "bs,bst->bt", scaled, trans,
                precision=jax.lax.Precision.HIGHEST,
            )
        else:
            prod = jnp.matmul(scaled, trans, precision=jax.lax.Precision.HIGHEST)
        prop = jnp.log(jnp.maximum(prod, jnp.finfo(llh.dtype).tiny))
        new = _clamp(llh_t + shift + prop)
        carry = m_t * new + (1 - m_t) * carry
        return carry, carry

    carry, alphas = jax.lax.scan(
        step,
        alpha0,
        (jnp.swapaxes(llh[:, 1:], 0, 1), jnp.swapaxes(mask[:, 1:, None], 0, 1)),
    )
    log_alpha = jnp.concatenate(
        [alpha0[:, None], jnp.swapaxes(alphas, 0, 1)], axis=1
    )
    return log_alpha, carry


def backward(
    llh: jnp.ndarray,
    log_trans: jnp.ndarray,
    log_final: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Batched backward recursion; returns log_beta (B, T, S).

    With masking, padded positions (t beyond a sequence's length) carry
    the *final-state* vector backwards unchanged, so β at the last real
    frame equals log_final exactly as in the unpadded recursion.
    """
    b, t_len, s = llh.shape
    if mask is None:
        mask = jnp.ones((b, t_len), llh.dtype)
    trans_t = jnp.swapaxes(jnp.exp(log_trans), -1, -2)
    batched_trans = trans_t.ndim == 3
    beta_last = jnp.broadcast_to(_clamp(log_final), (b, s)).astype(llh.dtype)

    def step(carry, inp):
        llh_t1, m_t1 = inp  # llh at t+1, mask at t+1
        v = _clamp(llh_t1 + carry)
        shift = jnp.max(v, axis=-1, keepdims=True)
        scaled = jnp.exp(v - shift)
        if batched_trans:
            prod = jnp.einsum(
                "bs,bst->bt", scaled, trans_t,
                precision=jax.lax.Precision.HIGHEST,
            )
        else:
            prod = jnp.matmul(scaled, trans_t, precision=jax.lax.Precision.HIGHEST)
        prop = jnp.log(jnp.maximum(prod, jnp.finfo(llh.dtype).tiny))
        new = _clamp(shift + prop)
        carry = m_t1 * new + (1 - m_t1) * carry
        return carry, carry

    _, betas = jax.lax.scan(
        step,
        beta_last,
        (jnp.swapaxes(llh[:, 1:], 0, 1), jnp.swapaxes(mask[:, 1:, None], 0, 1)),
        reverse=True,
    )
    return jnp.concatenate([jnp.swapaxes(betas, 0, 1), beta_last[:, None]], axis=1)


def _scaled_pass(e_llh, trans, init_vec, mask, reverse: bool):
    """Shared scaled recursion: carries normalized probabilities + log-scale.

    The classic scaled forward/backward: per step one (B, S) @ (S, S)
    matmul, a row-sum, and a single log on the (B,) normalizer — the
    per-element exp/log of the log-domain step are hoisted out of the
    scan entirely (exp(llh) precomputed, log taken once on the outputs).
    """
    b, t_len, s = e_llh.shape
    tiny = jnp.finfo(e_llh.dtype).tiny
    batched = trans.ndim == 3

    if reverse:
        prob0 = init_vec  # unnormalized final vector (already exp'd)
    else:
        prob0 = init_vec * e_llh[:, 0]
    norm0 = jnp.maximum(prob0.sum(-1, keepdims=True), tiny)
    carry0 = (prob0 / norm0, jnp.log(norm0[..., 0]))

    def step(carry, inp):
        prob, logc = carry
        e_t, m_t = inp
        if reverse:
            v = prob * e_t
            if batched:
                raw = jnp.einsum("bs,bst->bt", v,
                                 jnp.swapaxes(trans, -1, -2),
                                 precision=jax.lax.Precision.HIGHEST)
            else:
                raw = jnp.matmul(v, trans.T,
                                 precision=jax.lax.Precision.HIGHEST)
        else:
            if batched:
                raw = jnp.einsum("bs,bst->bt", prob, trans,
                                 precision=jax.lax.Precision.HIGHEST)
            else:
                raw = jnp.matmul(prob, trans,
                                 precision=jax.lax.Precision.HIGHEST)
            raw = raw * e_t
        norm = jnp.maximum(raw.sum(-1, keepdims=True), tiny)
        new = (raw / norm, logc + jnp.log(norm[..., 0]))
        prob_out = m_t * new[0] + (1 - m_t) * prob
        logc_out = m_t[..., 0] * new[1] + (1 - m_t[..., 0]) * logc
        return (prob_out, logc_out), (prob_out, logc_out)

    xs = (
        jnp.swapaxes(e_llh[:, 1:], 0, 1),
        jnp.swapaxes(mask[:, 1:, None], 0, 1),
    )
    carry, (probs, logcs) = jax.lax.scan(step, carry0, xs, reverse=reverse)
    if reverse:
        probs = jnp.concatenate([probs, carry0[0][None]], axis=0)
        logcs = jnp.concatenate([logcs, carry0[1][None]], axis=0)
    else:
        probs = jnp.concatenate([carry0[0][None], probs], axis=0)
        logcs = jnp.concatenate([carry0[1][None], logcs], axis=0)
    probs = jnp.swapaxes(probs, 0, 1)          # (B, T, S)
    logcs = jnp.swapaxes(logcs, 0, 1)          # (B, T)
    return probs, logcs, carry


def _smoothing_scan(e_llh, trans, final_vec, mask, a_probs):
    """Fused backward + smoothing pass as a ``lax.scan``.

    v-space backward recursion (carry v̂_t ∝ e_t·β_t, normalized) with
    the smoothing outputs computed in-step; the semantics of
    ``triton_scan.smoothing_pass`` (tests assert agreement).  Handles
    per-utterance (B, S, S) transition matrices via einsum.
    """
    b, t_len, s = e_llh.shape
    tiny = jnp.finfo(e_llh.dtype).tiny
    batched = trans.ndim == 3
    trans_t = jnp.swapaxes(trans, -1, -2)
    final = jnp.broadcast_to(final_vec, (b, s)).astype(e_llh.dtype)
    mask_next = jnp.concatenate(
        [mask[:, 1:], jnp.zeros((b, 1), mask.dtype)], axis=1
    )
    v0 = final / jnp.maximum(final.sum(-1, keepdims=True), tiny)

    def step(v_hat, inp):
        e_t, a_t, m_t, mn_t = inp
        is_last = m_t * (1.0 - mn_t)
        if batched:
            u1 = jnp.einsum("bs,bst->bt", v_hat, trans_t,
                            precision=jax.lax.Precision.HIGHEST)
        else:
            u1 = jnp.matmul(v_hat, trans_t,
                            precision=jax.lax.Precision.HIGHEST)
        u1 = is_last * final + (1.0 - is_last) * u1
        nu = jnp.maximum(u1.sum(-1, keepdims=True), tiny)
        b_hat = u1 / nu
        ab = a_t * b_hat
        pn = ab.sum(-1, keepdims=True)
        gamma = (ab / jnp.maximum(pn, tiny)) * m_t
        v = e_t * u1
        sv = jnp.maximum(v.sum(-1, keepdims=True), tiny)
        w = v / sv
        v_new = m_t * w + (1.0 - m_t) * v_hat
        return v_new, (gamma, w, (sv / nu)[..., 0], pn[..., 0])

    xs = (
        jnp.swapaxes(e_llh, 0, 1),
        jnp.swapaxes(a_probs, 0, 1),
        jnp.swapaxes(mask[..., None], 0, 1),
        jnp.swapaxes(mask_next[..., None], 0, 1),
    )
    _, (gamma, w, wsum, pnorm) = jax.lax.scan(step, v0, xs, reverse=True)
    return (
        jnp.swapaxes(gamma, 0, 1),
        jnp.swapaxes(w, 0, 1),
        jnp.swapaxes(wsum, 0, 1),
        jnp.swapaxes(pnorm, 0, 1),
    )


def bands_to_dense(bands) -> jnp.ndarray:
    """(a_self, a_adv, exit, w) → the dense (S, S) probability matrix
    ``diag(a_self) + superdiag(a_adv) + outer(exit, w)``."""
    a_self, a_adv, exit_v, w_v = bands
    s = a_self.shape[0]
    return (
        jnp.diag(a_self)
        + jnp.diag(a_adv[:-1], 1)
        + exit_v[:, None] * w_v[None, :]
    )


def _with_scan_vjp(kernel, reference):
    """``kernel`` forward, the VJP of the plain scan ``reference`` as its
    backward (Pallas kernels have no autodiff rule)."""
    run = jax.custom_vjp(kernel)
    run.defvjp(lambda *args: (run(*args), args),
               lambda args, ct: jax.vjp(reference, *args)[1](ct))
    return run


# the GPU kernel pair, differentiable through the plain scans
_KERNEL_FWD = _with_scan_vjp(
    triton_scan.forward_pass,
    lambda e, t, v, m: _scaled_pass(e, t, v, m, reverse=False)[:2])
_KERNEL_SMOOTH = _with_scan_vjp(triton_scan.smoothing_pass, _smoothing_scan)


def forward_backward(
    llh: jnp.ndarray,
    log_trans: jnp.ndarray,
    log_init: jnp.ndarray,
    log_final: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
) -> FBResult:
    """Full smoothing pass: α, β, log Z, and per-frame state posteriors.

    Uses the scaled recursion (probability carries, one log per step on
    the normalizer); log-space α/β for downstream ξ-counts are recovered
    with a single vectorized log over the stored scan outputs.
    """
    b, t_len, s = llh.shape
    if mask is None:
        mask = jnp.ones((b, t_len), llh.dtype)
    tiny = jnp.finfo(llh.dtype).tiny
    # exp(llh - per-frame max): hoisted out of the scans, one shot over T
    m_llh = jnp.max(llh, axis=-1, keepdims=True)
    e_llh = jnp.exp(llh - m_llh) * mask[..., None] + (1 - mask[..., None]) * 1.0
    # cumulative per-frame shifts enter the log-scales
    shift_fwd = jnp.cumsum(m_llh[..., 0] * mask, axis=1)

    trans = jnp.exp(log_trans)
    init_vec = jnp.broadcast_to(jnp.exp(_clamp(log_init)), (b, s)).astype(llh.dtype)
    a_probs, a_logcs, (a_last, a_logc_last) = _scaled_pass(
        e_llh, trans, init_vec, mask, reverse=False
    )
    log_alpha = jnp.log(jnp.maximum(a_probs, tiny)) + (
        a_logcs + shift_fwd
    )[..., None]

    final_vec = jnp.broadcast_to(jnp.exp(_clamp(log_final)), (b, s)).astype(llh.dtype)
    # backward pass consumes e_llh at t+1; shift bookkeeping mirrors fwd
    b_probs, b_logcs, _ = _scaled_pass(
        e_llh, trans, final_vec, mask, reverse=True
    )
    # shift for beta_t: sum of m_llh over (t+1 .. T-1) on valid frames
    total_shift = shift_fwd[:, -1:]
    shift_bwd = total_shift - shift_fwd
    log_beta = jnp.log(jnp.maximum(b_probs, tiny)) + (
        b_logcs + shift_bwd
    )[..., None]

    log_z = a_logc_last + shift_fwd[:, -1] + jnp.log(
        jnp.maximum((a_last * final_vec).sum(-1), tiny)
    )
    # Per-frame softmax: γ_t ∝ α_t·β_t normalized over states.  Exact in
    # exact arithmetic and — unlike exp(α+β−logZ) — immune to the
    # probability floor of the scaled passes (floored states sit ~e^-87
    # below the per-frame max and softmax to ~0 instead of overflowing).
    posteriors = jax.nn.softmax(log_alpha + log_beta, axis=-1) * mask[..., None]
    return FBResult(log_alpha, log_beta, log_z, posteriors)


def forward_backward_probs(
    llh: jnp.ndarray,
    log_trans: jnp.ndarray,
    log_init: jnp.ndarray,
    log_final: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
) -> FBProbs:
    """Probability-space smoothing — the training hot path.

    Same recursions as :func:`forward_backward`, but the (B, T, S)
    log/exp/softmax recovery passes are skipped entirely: the scaled
    carries α̂/β̂ are already per-frame normalized, so

      γ_t = α̂_t·β̂_t / Σ_s α̂_t(s)·β̂_t(s)

    is *exactly* ``softmax(log_alpha + log_beta)`` (the per-(b, t)
    log-scale constants cancel in the normalization).  The backward
    recursion runs fused with the smoothing (γ, ξ-factors, and their
    normalizers emitted in-step).  ξ-counts come from
    :func:`expected_transition_counts_probs` on the same by-products.
    Tests assert agreement with the log path; :class:`FBResult` remains
    available via :func:`forward_backward` for log-domain consumers.

    On a GPU with one shared (S, S) matrix both passes run as Pallas
    kernels (:mod:`beer_tpu.ops.triton_scan`); elsewhere, and for
    per-utterance (B, S, S) matrices, as ``lax.scan``.
    """
    b, t_len, s = llh.shape
    if mask is None:
        mask = jnp.ones((b, t_len), llh.dtype)
    tiny = jnp.finfo(llh.dtype).tiny
    m_e = mask[..., None]
    m_llh = jnp.max(llh, axis=-1, keepdims=True)
    e_llh = jnp.exp(llh - m_llh) * m_e + (1 - m_e) * 1.0
    shift_total = (m_llh[..., 0] * mask).sum(1)

    trans = jnp.exp(log_trans)
    init_vec = jnp.broadcast_to(jnp.exp(_clamp(log_init)), (b, s)).astype(llh.dtype)
    final_vec = jnp.broadcast_to(jnp.exp(_clamp(log_final)), (b, s)).astype(llh.dtype)
    if triton_scan.use_kernel(trans, llh.dtype):
        a_probs, a_logcs = _KERNEL_FWD(e_llh, trans, init_vec, mask)
        # masked steps copy the carry, so the last row is the last valid one
        a_last, a_logc_last = a_probs[:, -1], a_logcs[:, -1]
        gamma, w, wsum, pnorm = _KERNEL_SMOOTH(
            e_llh, trans, final_vec, mask, a_probs
        )
    else:
        a_probs, a_logcs, (a_last, a_logc_last) = _scaled_pass(
            e_llh, trans, init_vec, mask, reverse=False
        )
        gamma, w, wsum, pnorm = _smoothing_scan(
            e_llh, trans, final_vec, mask, a_probs
        )
    log_z = a_logc_last + shift_total + jnp.log(
        jnp.maximum((a_last * final_vec).sum(-1), tiny)
    )
    return FBProbs(a_probs, gamma, w, wsum, pnorm, a_logcs, log_z)


def expected_transition_counts_probs(
    fbp: FBProbs,
    log_trans: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    rows: Optional[jnp.ndarray] = None,
    cols: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """ξ-counts from the probability-space carries of
    :func:`forward_backward_probs` — the fast path of
    :func:`expected_transition_counts`.

    ``u_t = softmax(log_alpha_t)`` is exactly the per-frame-normalized
    forward carry α̂_t (no softmax needed), and ``w_t =
    softmax(llh_t + log_beta_t)`` is ``normalize(e_llh_t · β̂_t)`` (the
    per-frame max shift of e_llh and the β̂ log-scale are constants that
    cancel).

    The per-frame normalizer uᵀAw — a full (B, T, S²) contraction in the
    log-space formula — is recovered *for free* from pass by-products:
    substituting α̂_{t+1} = (α̂_t A) ⊙ e_{t+1} / c_{t+1} (the forward
    recursion, c = the per-step scale) gives the exact identity

        u_tᵀ A w_{t+1} = c_{t+1} · Σ_j α̂_{t+1}(j) β̂_{t+1}(j)
                                  / Σ_j e_{t+1}(j) β̂_{t+1}(j)

    where c_{t+1} = exp(logc_{t+1} − logc_t) and Σ α̂β̂ is the posterior
    normalizer — both already computed.  (Masked steps copy the carries,
    so c = 1 there; their weight is zeroed by the mask anyway.)
    """
    tiny = jnp.finfo(fbp.probs_fwd.dtype).tiny
    logcs = fbp.fwd_log_scales
    b, t_len = fbp.w_sums.shape
    u = fbp.probs_fwd[:, :-1]                      # (B, T-1, S)
    w = fbp.probs_w[:, 1:]
    step_norm = jnp.exp(logcs[:, 1:] - logcs[:, :-1])   # c_{t+1}
    denom = step_norm * fbp.post_norm[:, 1:] / jnp.maximum(
        fbp.w_sums[:, 1:], tiny
    )
    m_tail = jnp.ones((b, t_len - 1), u.dtype) if mask is None \
        else mask[:, 1:]
    weight = jnp.where(denom > 1e-30, m_tail / jnp.maximum(denom, 1e-30), 0.0)
    return _xi_outer(u, w, weight, jnp.exp(log_trans), rows, cols)


def _xi_outer(u, w, weight, trans_prob, rows, cols):
    """Σ_t weight_t · outer(u_t, w_t) ⊙ A, optionally restricted.

    Restriction uses one-hot selection *matmuls* (one (B·T, S) @ (S, n)
    contraction) rather than a strided gather along the minor axis.  The
    (batch, time) axes are contracted in place (no reshape — an explicit
    flatten of the sliced operands forces full-size copies XLA otherwise
    fuses away).
    """
    if rows is not None:
        s = u.shape[-1]
        sel_r = jax.nn.one_hot(rows, s, dtype=u.dtype)     # (n_r, S)
        sel_c = jax.nn.one_hot(cols, s, dtype=u.dtype)     # (n_c, S)
        u = jnp.matmul(u, sel_r.T, precision=jax.lax.Precision.HIGHEST)
        w = jnp.matmul(w, sel_c.T, precision=jax.lax.Precision.HIGHEST)
        # the (S, S) block restriction stays a *gather* — it is tiny, and
        # a selection matmul at default precision rounds the transition
        # probabilities (bf16 or TF32 by backend: ~0.3% ξ bias, caught
        # against an f64 brute-force forward-backward oracle)
        trans_prob = trans_prob[rows][:, cols]
    outer = jnp.einsum(
        "bti,btj,bt->ij", u, w, weight,
        precision=jax.lax.Precision.HIGHEST,
    )
    return outer * trans_prob


def expected_transition_counts(
    log_alpha: jnp.ndarray,
    log_beta: jnp.ndarray,
    llh: jnp.ndarray,
    log_trans: jnp.ndarray,
    log_z: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    chunk: int = 16,
    rows: Optional[jnp.ndarray] = None,
    cols: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Σ_t ξ_t summed over the batch: E[#transitions i→j], (S, S).

    ξ_t(i, j) = exp(α_t(i) + log A(i, j) + llh_{t+1}(j) + β_{t+1}(j) − log Z).

    Computed from *per-frame-normalized* α and (llh+β) factors with the
    exact per-frame normalizer Σ_ij (a much cheaper matvec), so the
    result is independent of any absolute scale/floor the recursions
    carry and no exponential can overflow:

        ξ_t = outer(u_t, w_t) ⊙ A / (u_tᵀ A w_t),  u, w per-frame softmaxed.

    The accumulation over (b, t) is one einsum contraction; no
    (T, S, S) tensor is ever materialized.

    ``rows``/``cols`` (int arrays) restrict the *output* to the sub-block
    ξ[rows, cols] — e.g. the phone loop only needs the (unit-ends ×
    unit-starts) arcs — while the normalizer still runs over all arcs.
    """
    del chunk  # kept for API compatibility; no longer needed
    b, t_len, s = llh.shape
    if mask is None:
        mask = jnp.ones((b, t_len), llh.dtype)
    alpha = log_alpha[:, :-1]                          # (B, T-1, S)
    v = _clamp(llh[:, 1:] + log_beta[:, 1:])           # (B, T-1, S)
    u = jax.nn.softmax(alpha, axis=-1)
    w = jax.nn.softmax(v, axis=-1)
    trans_prob = jnp.exp(log_trans)
    denom = jnp.einsum(
        "bti,ij,btj->bt", u, trans_prob, w,
        precision=jax.lax.Precision.HIGHEST,
    )
    weight = jnp.where(denom > 1e-30, mask[:, 1:] / jnp.maximum(denom, 1e-30), 0.0)
    return _xi_outer(u, w, weight, trans_prob, rows, cols)


# ----------------------------------------------------------------------
# Associative-scan variant (O(log T) depth)
# ----------------------------------------------------------------------
def _semiring_matmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(logsumexp, +) matrix product of batched (..., S, S) log-matrices."""
    a_shift = jnp.max(a, axis=-1, keepdims=True)  # rows of a
    b_shift = jnp.max(b, axis=-2, keepdims=True)  # cols of b
    prod = jnp.einsum(
        "...ik,...kj->...ij", jnp.exp(a - a_shift), jnp.exp(b - b_shift),
        precision=jax.lax.Precision.HIGHEST,
    )
    return _clamp(a_shift + b_shift + jnp.log(jnp.maximum(prod, 1e-37)))


def forward_assoc(
    llh: jnp.ndarray,
    log_trans: jnp.ndarray,
    log_init: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    chunk: Optional[int] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """log_alpha via ``lax.associative_scan`` over transition operators.

    ``chunk=None`` materializes (B, T, S, S) operators — fine for
    moderate T·S².  ``chunk=C`` bounds memory at (B, C, S, S) (SURVEY §7
    "blockwise scan": sequential ``lax.scan`` over T/C blocks, O(log C)
    associative scan within each block) — the long-sequence /
    small-state CP analogue of SURVEY §5.7.
    """
    b, t_len, s = llh.shape
    if mask is None:
        mask = jnp.ones((b, t_len), llh.dtype)
    eye = jnp.where(jnp.eye(s, dtype=bool), 0.0, _NEG_INF).astype(llh.dtype)

    if chunk is None or chunk >= t_len:
        # Operator for step t>0: M_t[i, j] = log A[i, j] + llh[t, j];
        # padded steps use the identity operator (0 diag, -inf off-diag).
        ops = log_trans[None, None] + llh[:, :, None, :]
        ops = jnp.where(mask[:, :, None, None] > 0, ops, eye[None, None])
        # Fold the init into the t=0 operator: row i -> alpha_0 (constant).
        alpha0 = _clamp(log_init + llh[:, 0])  # (B, S)
        ops = ops.at[:, 0].set(jnp.broadcast_to(alpha0[:, None, :], (b, s, s)))
        prefix = jax.lax.associative_scan(_semiring_matmul, ops, axis=1)
        # alpha_t = prefix_t[i, :] for any i (t=0 row was constant in i).
        log_alpha = prefix[:, :, 0, :]
    else:
        n_chunks = -(-t_len // chunk)
        pad = n_chunks * chunk - t_len
        llh_p = jnp.pad(llh, ((0, 0), (0, pad), (0, 0)))
        mask_p = jnp.pad(mask, ((0, 0), (0, pad)))
        # t=0 is handled by a rows-constant operator + a carry whose
        # logsumexp is 0 (−log S per state), so alpha_0 comes out exact.
        alpha0 = _clamp(log_init + llh_p[:, 0])
        carry0 = jnp.full((b, s), -math.log(s), llh.dtype)

        llh_c = llh_p.reshape(b, n_chunks, chunk, s).swapaxes(0, 1)
        mask_c = mask_p.reshape(b, n_chunks, chunk).swapaxes(0, 1)
        first = jnp.broadcast_to(alpha0[:, None, :], (b, s, s))

        def block(carry, inp):
            i, llh_b, m_b = inp              # (B, C, S), (B, C)
            ops = log_trans[None, None] + llh_b[:, :, None, :]
            ops = jnp.where(m_b[:, :, None, None] > 0, ops, eye[None, None])
            ops = jnp.where(
                (i == 0) & (jnp.arange(chunk) == 0)[None, :, None, None],
                first[:, None], ops,
            )
            prefix = jax.lax.associative_scan(_semiring_matmul, ops, axis=1)
            # alpha within block: carry ⊗ prefix (log mat-vec per t)
            alpha_b = jax.scipy.special.logsumexp(
                carry[:, None, :, None] + prefix, axis=2
            )
            return alpha_b[:, -1], alpha_b

        _, blocks = jax.lax.scan(
            block, carry0,
            (jnp.arange(n_chunks), llh_c, mask_c),
        )                                     # (nc, B, C, S)
        log_alpha = blocks.swapaxes(0, 1).reshape(b, n_chunks * chunk, s)
        log_alpha = log_alpha[:, :t_len]

    last = (mask.sum(1) - 1).astype(jnp.int32)
    alpha_last = jnp.take_along_axis(
        log_alpha, last[:, None, None].repeat(s, -1), axis=1
    )[:, 0]
    return log_alpha, alpha_last


# ----------------------------------------------------------------------
# Viterbi
# ----------------------------------------------------------------------
def viterbi(
    llh: jnp.ndarray,
    log_trans: jnp.ndarray,
    log_init: jnp.ndarray,
    log_final: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched best-path decoding.

    Returns (paths (B, T) int32 — state ids, valid where mask=1 —, and
    best-path log-probability (B,)).
    """
    b, t_len, s = llh.shape
    if mask is None:
        mask = jnp.ones((b, t_len), llh.dtype)
    score0 = _clamp(log_init + llh[:, 0])
    ids = jnp.arange(s, dtype=jnp.int32)
    lt = log_trans if log_trans.ndim == 3 else log_trans[None]

    def fwd_step(carry, inp):
        llh_t, m_t = inp
        cand = carry[:, :, None] + lt  # (B, S_prev, S_next)
        best_prev = jnp.argmax(cand, axis=1).astype(jnp.int32)  # (B, S)
        new = _clamp(llh_t + jnp.max(cand, axis=1))
        carry_new = m_t * new + (1 - m_t) * carry
        bp = jnp.where(m_t > 0, best_prev, ids[None, :])  # identity on pads
        return carry_new, bp

    score_last, bps = jax.lax.scan(
        fwd_step,
        score0,
        (jnp.swapaxes(llh[:, 1:], 0, 1), jnp.swapaxes(mask[:, 1:, None], 0, 1)),
    )  # bps: (T-1, B, S)
    best_last = jnp.argmax(score_last + log_final, axis=-1).astype(jnp.int32)
    best_score = jnp.max(score_last + log_final, axis=-1)

    def back_step(state, bp_t):
        prev = jnp.take_along_axis(bp_t, state[:, None], axis=1)[:, 0]
        return prev, prev

    _, path_rev = jax.lax.scan(back_step, best_last, bps, reverse=True)
    paths = jnp.concatenate([path_rev, best_last[None]], axis=0)  # (T, B)
    return jnp.swapaxes(paths, 0, 1), best_score


def viterbi_banded(
    llh: jnp.ndarray,
    bands,
    log_init: jnp.ndarray,
    log_final: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Best-path decoding through the band + rank-1 factorization.

    ``bands = (a_self, a_adv, exit, w)`` probability-space vectors with
    ``bands_to_dense(bands) == exp(log_trans)`` exactly and NO
    overlapping contributions (the phone-loop guarantee,
    ``PhoneLoop._structured_trans``).  Per step this is O(B*S) work
    — the dense :func:`viterbi` builds a (B, S, S) candidate tensor —
    and the backtrace state is 1 int8 choice per (t, b, s) plus one
    exit argmax per (t, b) instead of an int32 backpointer per state.

    Returns ``(paths (B, T) int32, best log-prob (B,))``; identical to
    the dense path (score ties aside, which are measure-zero for float
    inputs).
    """
    a_self, a_adv, exit_scat, w_scat = bands
    b, t_len, s = llh.shape
    dt = llh.dtype
    if mask is None:
        mask = jnp.ones((b, t_len), dt)

    def logv(v):
        return jnp.where(v > 0, jnp.log(jnp.maximum(v, 1e-37)), _NEG_INF)

    ls, la, le, lw = (logv(v.astype(dt)) for v in
                      (a_self, a_adv, exit_scat, w_scat))

    neg = jnp.full((b, 1), _NEG_INF, dt)

    def fwd_step(alpha, inp):
        llh_t, m_t = inp
        c_self = alpha + ls
        c_adv = jnp.concatenate([neg, (alpha + la)[:, :-1]], axis=1)
        ex = alpha + le
        ex_arg = jnp.argmax(ex, axis=-1).astype(jnp.int32)   # (B,)
        c_loop = jnp.max(ex, axis=-1, keepdims=True) + lw
        stacked = jnp.stack([c_self, c_adv, c_loop])         # (3, B, S)
        choice = jnp.argmax(stacked, axis=0).astype(jnp.int8)
        new = _clamp(llh_t + jnp.max(stacked, axis=0))
        alpha_new = m_t * new + (1 - m_t) * alpha
        choice = jnp.where(m_t > 0, choice, jnp.int8(0))     # pads: stay
        ex_arg = jnp.where(m_t[:, 0] > 0, ex_arg, 0)
        return alpha_new, (choice, ex_arg)

    alpha_last, (choices, ex_args) = jax.lax.scan(
        fwd_step,
        _clamp(log_init + llh[:, 0]),
        (jnp.swapaxes(llh[:, 1:], 0, 1),
         jnp.swapaxes(mask[:, 1:, None], 0, 1)),
    )
    best_last = jnp.argmax(alpha_last + log_final, axis=-1).astype(jnp.int32)
    best_score = jnp.max(alpha_last + log_final, axis=-1)

    def back_step(state, inp):
        ch_t, exarg_t = inp
        c = jnp.take_along_axis(ch_t, state[:, None], axis=1)[:, 0]
        prev = jnp.where(
            c == 0, state, jnp.where(c == 1, state - 1, exarg_t))
        return prev, prev

    _, path_rev = jax.lax.scan(
        back_step, best_last, (choices, ex_args), reverse=True)
    paths = jnp.concatenate([path_rev, best_last[None]], axis=0)
    return jnp.swapaxes(paths, 0, 1), best_score
