"""Data-parallel VB-EM: shard_map over a ``data`` mesh axis + psum of stats.

The E-step is embarrassingly parallel over utterances; the statistics
pytree is a fixed small size (O(components · stats_dim)), so one ``psum``
over the device interconnect per step replaces the reference's
stats-file reduce exactly
(same sum, different wire).  After the psum every shard applies the same
deterministic conjugate update, so parameters stay replicated without a
broadcast.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
from jax.sharding import Mesh, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devices), (axis_name,))


def shard_batch(x, n_shards: int):
    """Pad the leading (batch) axis to a multiple of n_shards.

    Returns (padded_x, pad_mask (B',)) — padded entries get mask 0 so they
    contribute nothing to statistics.
    """
    import numpy as np

    b = x.shape[0]
    b_pad = -(-b // n_shards) * n_shards
    pad = b_pad - b
    x_p = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)]) if pad else x
    valid = np.concatenate([np.ones(b, x.dtype), np.zeros(pad, x.dtype)])
    return x_p, valid


def data_parallel_elbo_and_stats(
    model, x, mask, axis_name: str = "data", datascale: float = 1.0
):
    """Runs INSIDE shard_map: local E-step, psum of (llh, stats) over the mesh.

    ``mask`` zeroes padded utterances *and* padded frames.  The KL term is
    computed once from the (replicated) parameters — outside the psum.
    """
    stats = model.sufficient_statistics(x)
    llh, cache = model.infer(stats, mask=mask)
    # zero out contributions of padded utterances (all-zero masks)
    seq_valid = (mask.sum(-1) > 0).astype(llh.dtype)
    llh_sum = jax.lax.psum((llh * seq_valid).sum(), axis_name)
    acc = model.accumulate(stats, cache)
    acc = jax.lax.psum(acc, axis_name)
    elbo = datascale * llh_sum - model.kl_div_posterior_prior()
    if datascale != 1.0:
        acc = jax.tree.map(lambda s: datascale * s, acc)
    return elbo, acc


def make_vb_train_step(
    mesh: Mesh,
    axis_name: str = "data",
    lrate: float = 1.0,
    datascale: float = 1.0,
):
    """Build the jitted data-parallel VB-EM step.

    Usage::

        mesh = make_mesh()
        step = make_vb_train_step(mesh)
        x, valid = shard_batch(data, mesh.devices.size)   # (B', T, D)
        mask = mask * valid[:, None]
        for epoch in range(E):
            elbo, model = step(model, x, mask)

    Model parameters are replicated (spec ``P()``); the batch is sharded
    on its leading axis.  The conjugate update runs identically on every
    shard after the psum, so the output model is replicated by
    construction.
    """

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis_name), P(axis_name)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def step(model, x, mask):
        elbo, acc = data_parallel_elbo_and_stats(
            model, x, mask, axis_name, datascale
        )
        new_model = model.vb_update(acc, lrate)
        return elbo, new_model

    return step


def make_vb_minibatch_step(
    mesh: Mesh,
    axis_name: str = "data",
    lrate: float = 1.0,
):
    """Data-parallel *stochastic* VB step with a traced datasize scale.

    Like :func:`make_vb_train_step`, but the ``datasize / n_valid``
    statistics scale enters as a traced scalar so ragged tail batches
    (fewer valid utterances than the padded batch size) do not
    recompile.  Returns ``step(model, x, mask, datascale) ->
    (elbo, new_model)``; pass ``datascale = 1.0`` and ``lrate = 1.0``
    for exact full-batch semantics on a single batch.
    """

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis_name), P(axis_name), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def step(model, x, mask, datascale):
        stats = model.sufficient_statistics(x)
        llh, cache = model.infer(stats, mask=mask)
        seq_valid = (mask.sum(-1) > 0).astype(llh.dtype)
        llh_sum = jax.lax.psum((llh * seq_valid).sum(), axis_name)
        acc = jax.lax.psum(model.accumulate(stats, cache), axis_name)
        elbo = datascale * llh_sum - model.kl_div_posterior_prior()
        acc = jax.tree.map(lambda s: datascale * s, acc)
        return elbo, model.vb_update(acc, lrate)

    return step


def make_vb_estep(mesh: Mesh, axis_name: str = "data"):
    """Data-parallel E-step only: ``estep(model, x, mask) -> (elbo, acc)``.

    The psum'd statistics come back replicated, so the caller can
    accumulate them across minibatches on one device and apply a single
    conjugate update per epoch (exact full-batch VB streamed through
    minibatches — the ``--accumulate-batches`` path).
    """

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis_name), P(axis_name)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def estep(model, x, mask):
        return data_parallel_elbo_and_stats(model, x, mask, axis_name)

    return estep


def make_supervised_vb_train_step(
    mesh: Mesh,
    axis_name: str = "data",
    lrate: float = 1.0,
):
    """Data-parallel supervised training with per-utterance graphs.

    The per-utterance graph fields shard with the batch while the
    emission parameters stay replicated; the psum of the statistics
    pytree is unchanged.  Usage::

        step = make_supervised_vb_train_step(mesh)
        elbo, emissions = step(emissions, graphs, x, mask)

    where ``graphs = transcription_graphs(...)`` with per-utterance
    leading axes divisible by the mesh size.  Both graph forms work:
    the default *shared* form (one (S, S) transition matrix + (S,) init
    replicated; per-utterance ``log_final``/``pdf_ids`` sharded) and the
    fully-batched ``shared=False`` form (every field sharded).  The
    per-field sharding is derived from the graph's array ranks on first
    call (one compiled step per graph form).
    """
    import jax.tree_util as jtu

    from beer_tpu.models.hmm import HMM

    # graph field → rank in the *batched* (per-utterance) form
    batched_rank = {"log_init": 2, "log_final": 2, "log_trans": 3, "pdf_ids": 2}
    cache = {}

    def build(graph_spec):
        @jax.jit
        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(), graph_spec, P(axis_name), P(axis_name)),
            out_specs=(P(), P()),
            check_vma=False,
        )
        def step(emissions, graphs, x, mask):
            model = HMM(graph=graphs, modelset=emissions)
            elbo, acc = data_parallel_elbo_and_stats(model, x, mask, axis_name)
            new_model = model.vb_update(acc, lrate)
            return elbo, new_model.modelset

        return step

    def call(emissions, graphs, x, mask):
        leaves, treedef = jtu.tree_flatten_with_path(graphs)
        specs = [
            P(axis_name)
            if leaf.ndim == batched_rank.get(path[-1].name, -1)
            else P()
            for path, leaf in leaves
        ]
        key = (treedef, tuple(specs))
        if key not in cache:
            cache[key] = build(jtu.tree_unflatten(treedef, specs))
        return cache[key](emissions, graphs, x, mask)

    return call
