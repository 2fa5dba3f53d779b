"""Sequence-parallel HMM inference (the context-parallel analogue).

SURVEY.md §5.7 / §2.10: the reference processes one utterance at a time
in a Python loop; utterances longer than one chip's memory have no story
at all.  Here time itself is sharded over a mesh axis and the forward
recursion runs as a *blockwise* temporal parallelization (the
prefix-product formulation of arXiv:2102.05743, distributed):

1. each device folds its local time chunk into transition operators and
   takes their inclusive log-semiring prefix with
   ``lax.associative_scan`` (O(log T_local) depth),
2. block operators are combined *across devices* with a Hillis-Steele
   scan over ``lax.ppermute`` rounds (O(log n_dev) interconnect hops),
3. the exclusive device-prefix seeds each device's local alphas with one
   batched semiring product.

Work is O(T·S³/n_dev) per device versus O(T·S²) sequential — the classic
span/work trade of temporal parallelization; use when T is huge or the
sequential scan's T-step latency dominates.

The same machinery runs backwards (suffix products with the final vector
folded in as a column-constant operator), so the full smoothing pass —
α, β, log Z, posteriors — is available time-sharded
(:func:`forward_backward_time_sharded`), composable with data parallelism
on a 2-D (data × seq) mesh (see tests/test_seq_parallel.py and
``__graft_entry__.dryrun_multichip``).

All functions here run INSIDE ``shard_map`` with ``llh`` sharded on its
time axis; ``make_sharded_forward`` / ``make_sharded_forward_backward``
build the wrapped jitted callers.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from beer_tpu.ops.semiring_scan import _NEG_INF, _clamp, _semiring_matmul


def _identity_op(s: int, dtype) -> jnp.ndarray:
    return jnp.where(jnp.eye(s, dtype=bool), 0.0, _NEG_INF).astype(dtype)


def forward_time_sharded(
    llh: jnp.ndarray,
    log_trans: jnp.ndarray,
    log_init: jnp.ndarray,
    mask: jnp.ndarray,
    axis_name: str,
):
    """Distributed forward; returns (local log_alpha (B, Tl, S), carry).

    ``llh``/``mask`` are the local time chunk; the returned ``carry`` is
    the final alpha (valid on every device — it is the last device's
    value, broadcast by the scan structure on the devices that own
    padding only).
    """
    b, t_local, s = llh.shape
    n_dev = jax.lax.axis_size(axis_name)
    dev = jax.lax.axis_index(axis_name)
    eye = _identity_op(s, llh.dtype)

    # transition operators for local steps; global step 0 lives on dev 0
    ops = log_trans[None, None] + llh[:, :, None, :]
    ops = jnp.where(mask[:, :, None, None] > 0, ops, eye[None, None])
    alpha0 = _clamp(log_init + llh[:, 0])
    first_op = jnp.where(
        dev == 0, jnp.broadcast_to(alpha0[:, None, :], (b, s, s)), ops[:, 0]
    )
    ops = jnp.concatenate([first_op[:, None], ops[:, 1:]], axis=1)

    # 1. local inclusive prefix (O(log T_local) depth)
    prefix = jax.lax.associative_scan(_semiring_matmul, ops, axis=1)
    block = prefix[:, -1]  # (B, S, S): product of this device's chunk

    # 2. inclusive scan over devices: Hillis-Steele with ppermute rounds
    incl = block
    shift = 1
    while shift < n_dev:
        perm = [(i, (i + shift) % n_dev) for i in range(n_dev)]
        recv = jax.lax.ppermute(incl, axis_name, perm)
        incl = jnp.where(dev >= shift, _semiring_matmul(recv, incl), incl)
        shift *= 2
    # exclusive prefix: previous device's inclusive value, identity on dev 0
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    excl = jax.lax.ppermute(incl, axis_name, perm)
    excl = jnp.where(dev == 0, eye[None], excl)

    # 3. seed local alphas: row extraction works because the dev-0 first
    # operator has constant rows, making every downstream product
    # row-constant.
    full_prefix = _semiring_matmul(excl[:, None], prefix)
    log_alpha = full_prefix[:, :, 0, :]
    return log_alpha, log_alpha[:, -1]


def backward_time_sharded(
    llh: jnp.ndarray,
    log_trans: jnp.ndarray,
    log_final: jnp.ndarray,
    mask: jnp.ndarray,
    axis_name: str,
):
    """Distributed backward; returns local log_beta (B, Tl, S).

    Mirror image of :func:`forward_time_sharded`: suffix products of the
    backward operators N_t[i, j] = log A[i, j] + llh_{t+1}(j), with the
    final-vector operator folded in as a *column-constant* matrix on the
    global last step (so every suffix product has constant columns and
    β_t is any column).  Device-level suffix scan = Hillis-Steele over
    ppermute rounds from the right.
    """
    b, t_local, s = llh.shape
    n_dev = jax.lax.axis_size(axis_name)
    dev = jax.lax.axis_index(axis_name)
    eye = _identity_op(s, llh.dtype)

    # operator at local position t applies between t and t+1: needs llh at
    # t+1 — shift left across the device boundary with a ppermute.
    llh_next = jnp.concatenate([llh[:, 1:], llh[:, :1]], axis=1)
    mask_next = jnp.concatenate([mask[:, 1:], mask[:, :1]], axis=1)
    first_next = jax.lax.ppermute(
        llh[:, 0], axis_name, [(i, (i - 1) % n_dev) for i in range(n_dev)]
    )
    first_mask = jax.lax.ppermute(
        mask[:, 0], axis_name, [(i, (i - 1) % n_dev) for i in range(n_dev)]
    )
    llh_next = llh_next.at[:, -1].set(first_next)
    mask_next = mask_next.at[:, -1].set(first_mask)

    ops = log_trans[None, None] + llh_next[:, :, None, :]
    ops = jnp.where(mask_next[:, :, None, None] > 0, ops, eye[None, None])
    # column-constant final operator on the global last step
    final_op = jnp.broadcast_to(
        _clamp(log_final)[None, :, None], (b, s, s)
    ).astype(llh.dtype)
    is_global_last = dev == n_dev - 1
    last_op = jnp.where(is_global_last, final_op, ops[:, -1])
    ops = jnp.concatenate([ops[:, :-1], last_op[:, None]], axis=1)

    # local inclusive suffix products IN ORDER x_t ⊙ x_{t+1} ⊙ …:
    # associative_scan(reverse=True) combines in reversed order for
    # non-commutative ops, so run it on transposes ((A⊙B)ᵀ = Bᵀ⊙Aᵀ).
    ops_t = jnp.swapaxes(ops, -1, -2)
    suffix_t = jax.lax.associative_scan(
        _semiring_matmul, ops_t, axis=1, reverse=True
    )
    suffix = jnp.swapaxes(suffix_t, -1, -2)
    block = suffix[:, 0]  # product of this device's chunk

    incl = block
    shift = 1
    while shift < n_dev:
        perm = [(i, (i - shift) % n_dev) for i in range(n_dev)]
        recv = jax.lax.ppermute(incl, axis_name, perm)
        incl = jnp.where(dev < n_dev - shift, _semiring_matmul(incl, recv), incl)
        shift *= 2
    perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    excl = jax.lax.ppermute(incl, axis_name, perm)
    excl = jnp.where(dev == n_dev - 1, eye[None], excl)

    full_suffix = _semiring_matmul(suffix, excl[:, None])
    return full_suffix[:, :, :, 0]


def forward_backward_time_sharded(
    llh: jnp.ndarray,
    log_trans: jnp.ndarray,
    log_init: jnp.ndarray,
    log_final: jnp.ndarray,
    mask: jnp.ndarray,
    axis_name: str,
):
    """Full time-sharded smoothing (runs inside shard_map).

    Returns (log_alpha, log_beta, log_z, posteriors) for the local time
    chunk — the sequence-parallel equivalent of
    :func:`beer_tpu.ops.semiring_scan.forward_backward`.
    """
    log_alpha, _ = forward_time_sharded(llh, log_trans, log_init, mask, axis_name)
    log_beta = backward_time_sharded(llh, log_trans, log_final, mask, axis_name)
    n_dev = jax.lax.axis_size(axis_name)
    dev = jax.lax.axis_index(axis_name)
    contrib = jnp.where(
        dev == n_dev - 1,
        log_alpha[:, -1] + jnp.broadcast_to(_clamp(log_final), log_alpha[:, -1].shape),
        _NEG_INF,
    )
    final_joint = jax.lax.pmax(contrib, axis_name)
    log_z = jax.scipy.special.logsumexp(final_joint, axis=-1)
    log_post = log_alpha + log_beta - log_z[:, None, None]
    posteriors = jnp.exp(jnp.minimum(log_post, 0.0)) * mask[..., None]
    return log_alpha, log_beta, log_z, posteriors


def make_sharded_forward_backward(mesh: Mesh, axis_name: str = "seq"):
    """Jitted full smoothing with llh/mask time-sharded over ``axis_name``."""

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, axis_name), P(), P(), P(), P(None, axis_name)),
        out_specs=(
            P(None, axis_name), P(None, axis_name), P(), P(None, axis_name)
        ),
        check_vma=False,
    )
    def fn(llh, log_trans, log_init, log_final, mask):
        return forward_backward_time_sharded(
            llh, log_trans, log_init, log_final, mask, axis_name
        )

    return fn


def make_sharded_forward(mesh: Mesh, axis_name: str = "seq"):
    """Jitted caller: llh (B, T, S) time-sharded over ``axis_name``.

    Returns ``fn(llh, log_trans, log_init, log_final, mask) ->
    (log_alpha (B, T, S), log_z (B,))``.
    """

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, axis_name), P(), P(), P(), P(None, axis_name)),
        out_specs=(P(None, axis_name), P()),
        check_vma=False,
    )
    def fn(llh, log_trans, log_init, log_final, mask):
        log_alpha, _ = forward_time_sharded(
            llh, log_trans, log_init, mask, axis_name
        )
        # log Z: every sequence's last *valid* frame equals the carried
        # value because padded steps are identity operators; the global
        # last chunk therefore holds the final alpha.  Reduce with a max
        # over devices after masking non-final chunks.
        local_final = log_alpha[:, -1]
        n_dev = jax.lax.axis_size(axis_name)
        dev = jax.lax.axis_index(axis_name)
        contrib = jnp.where(dev == n_dev - 1, local_final, _NEG_INF)
        final_alpha = jax.lax.pmax(contrib, axis_name)
        log_z = jax.scipy.special.logsumexp(final_alpha + log_final, axis=-1)
        return log_alpha, log_z

    return fn
