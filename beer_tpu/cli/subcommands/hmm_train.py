"""Train a model with VB-EM (reference: ``beer hmm train``).

Stage-gated like the reference recipes: checkpoints ``epochN.mdl`` per
epoch in the output directory; rerunning resumes from the latest.
Utterances are padded into one batch (bucketing by length would be the
next refinement) and the whole epoch runs as one jitted data-parallel
step when more than one device is available.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np


def setup(parser):
    parser.add_argument("model", help="input model (.mdl)")
    parser.add_argument("feats", help="feature archive (.npz)")
    parser.add_argument("outdir", help="output/checkpoint directory")
    parser.add_argument("--epochs", type=int, default=30)
    parser.add_argument("--lrate", type=float, default=1.0)
    parser.add_argument("--single-device", action="store_true")
    parser.add_argument(
        "--batch-size", type=int, default=0,
        help="stochastic VB: train on shuffled minibatches of this many "
        "utterances (0 = full batch). Statistics are scaled by "
        "datasize/batch (the reference's datasize convention); use "
        "--lrate < 1 for stable stochastic updates.",
    )
    parser.add_argument(
        "--buckets", type=int, default=1,
        help="length buckets for minibatch padding (each bucket pads to "
        "its own rounded maximum -> that many compiled shapes instead "
        "of corpus-max padding everywhere)",
    )
    parser.add_argument(
        "--accumulate-batches", action="store_true",
        help="exact full-batch VB streamed through minibatches: "
        "accumulate statistics over the whole epoch, then one conjugate "
        "update — identical math to full batch, but the corpus never "
        "has to fit in one padded array (requires --batch-size)",
    )
    parser.add_argument(
        "--nan-guard", action="store_true",
        help="guard the training step: any non-finite value in the "
        "updated parameters or ELBO raises with location info instead of "
        "silently corrupting the run (checkify on single-device paths; "
        "an output-side finite check on data-parallel steps, where "
        "checkify cannot wrap shard_map collectives)",
    )
    parser.add_argument(
        "--transcriptions", default=None,
        help="supervised training: 'uttid ph1 ph2 ...' per line; the input "
        "model must be mkphones emissions (BASELINE config 3)",
    )
    parser.add_argument(
        "--max-padded-gb", type=float, default=4.0,
        help="if padding the whole corpus into one (B, T_max, D) array "
        "would exceed this many GB, automatically switch to exact "
        "streamed full-batch VB (bucketed minibatches + statistics "
        "accumulation, one conjugate update per epoch) instead of "
        "materializing the monolith — scalable by default",
    )


def pad_archive(path_or_npz):
    """Accepts a path (.bar native archive or .npz) or an opened npz."""
    from beer_tpu import io as bio

    if isinstance(path_or_npz, (str, Path)):
        return bio.load_padded(path_or_npz)
    archive = path_or_npz
    keys = list(archive.files)
    lengths = [archive[k].shape[0] for k in keys]
    t_max = max(lengths)
    d = archive[keys[0]].shape[-1]
    data = np.zeros((len(keys), t_max, d), np.float32)
    mask = np.zeros((len(keys), t_max), np.float32)
    for i, k in enumerate(keys):
        feats = archive[k]
        data[i, : len(feats)] = feats
        mask[i, : len(feats)] = 1
    return keys, data, mask


def _train_minibatch(args, model, outdir, start_epoch=0):
    """Stochastic VB: fixed-shape shuffled minibatches via io.BatchLoader.

    One compile (fixed (B, T_max) shapes), background batch prefetch
    overlapping device compute, per-epoch checkpoints.  The tail batch is
    padded with zero-mask utterances; statistics are scaled by
    ``datasize / n_valid`` (``datasize`` enters the jitted step as a
    traced scalar so the varying valid count does not recompile).
    """
    import time as _time

    import jax
    import jax.numpy as jnp

    from beer_tpu import io as bio
    from beer_tpu.utils import MetricsLogger, save_model
    from beer_tpu.vbi import elbo_and_stats, vb_step

    if args.feats.endswith(".bar"):
        archive = bio.Archive(args.feats)
    else:  # convert once next to the npz for mmap'd minibatch reads
        bar_path = args.feats + ".bar"
        if not Path(bar_path).exists():
            bio.convert_npz(args.feats, bar_path)
        archive = bio.Archive(bar_path)
    n_utts = len(archive)
    # data parallel composes with minibatches: the batch rows shard over
    # the mesh, statistics psum over the mesh, every device applies the same
    # update.  Batch size is rounded up so shards stay equal.
    n_dev = len(jax.devices())
    use_dp = n_dev > 1 and not args.single_device
    if use_dp:
        from beer_tpu import parallel

        args.batch_size = -(-args.batch_size // n_dev) * n_dev
        mesh = parallel.make_mesh()
        dp_step = parallel.make_vb_minibatch_step(mesh, lrate=args.lrate)
        dp_estep = parallel.make_vb_estep(mesh)
        print(f"minibatch data-parallel over {n_dev} devices")

        def step(m, x, msk, ds):
            return dp_step(m, x, msk, ds / x.shape[0])

        def estep(m, x, msk):
            return dp_estep(m, x, msk)

        if args.nan_guard:
            # checkify cannot wrap shard_map collectives; guard the step
            # outputs instead (same semantics: the checkify path also
            # only validates outputs).
            from beer_tpu.utils.debug import guard_finite_outputs

            check = guard_finite_outputs("vb_step[dp]")
            dp_raw = step

            def step(m, x, msk, ds):
                out = dp_raw(m, x, msk, ds)
                check(out)
                return out
    else:
        step = jax.jit(
            lambda m, x, msk, ds: vb_step(
                m, x, datasize=ds, lrate=args.lrate, mask=msk
            )
        )
        estep = jax.jit(lambda m, x, msk: elbo_and_stats(m, x, mask=msk))
    if args.nan_guard and not use_dp:
        from beer_tpu.utils.debug import nan_guard

        guarded = jax.jit(nan_guard(
            lambda m, x, msk, ds: vb_step(
                m, x, datasize=ds, lrate=args.lrate, mask=msk
            ), "vb_step",
        ))

        def step(m, x, msk, ds):
            err, out = guarded(m, x, msk, ds)
            err.throw()
            return out
    loader = bio.BatchLoader(archive, args.batch_size, seed=0,
                             buckets=args.buckets)
    logger = MetricsLogger(outdir / "log", stdout=False)
    for epoch in range(start_epoch + 1, args.epochs + 1):
        t0 = _time.time()
        total_frames, n_batches = 0.0, 0
        batch_elbos = []  # device scalars: forcing per batch would
        # serialize H2D upload against compute; keeping them lazy lets
        # jax's async dispatch overlap the next batch's transfer with
        # the current step
        epoch_acc = None
        for data, mask in loader:
            n_valid = data.shape[0]
            if n_valid < args.batch_size:  # keep shapes static
                pad = args.batch_size - n_valid
                data = np.concatenate([data, np.zeros((pad,) + data.shape[1:],
                                                      data.dtype)])
                mask = np.concatenate([mask, np.zeros((pad,) + mask.shape[1:],
                                                      mask.dtype)])
            x, msk = jnp.asarray(data), jnp.asarray(mask)
            if args.accumulate_batches:
                # exact full-batch VB: sum statistics, update once/epoch
                elbo, acc = estep(model, x, msk)
                epoch_acc = acc if epoch_acc is None else jax.tree.map(
                    jnp.add, epoch_acc, acc
                )
            else:
                # scale = datasize/B inside vb_step; feed datasize' so
                # the effective scale is n_utts/n_valid (padded rows
                # carry 0 stats)
                ds = jnp.float32(n_utts * args.batch_size / n_valid)
                elbo, model = step(model, x, msk, ds)
            batch_elbos.append(elbo)
            total_frames += float(mask.sum())
            n_batches += 1
        total_elbo = float(sum(float(e) for e in batch_elbos))
        if args.accumulate_batches:
            kl = float(model.kl_div_posterior_prior())
            model = model.vb_update(epoch_acc, args.lrate)
            # per-batch elbos each subtract the KL once; keep it once
            total_elbo += kl * (n_batches - 1)
            per_frame = total_elbo / max(total_frames, 1)
        else:
            # each batch ELBO estimates the full-corpus ELBO; report the
            # mean estimate normalized by the corpus frame count
            per_frame = total_elbo / max(n_batches, 1) / max(total_frames, 1)
        dt = _time.time() - t0
        print(f"epoch {epoch}: elbo/frame = {per_frame:.6f}")
        logger.log(epoch, elbo_per_frame=per_frame,
                   frames_per_sec=total_frames / dt)
        save_model(model, outdir / f"epoch{epoch:04d}.mdl")
    logger.close()
    save_model(model, outdir / "final.mdl")
    print(f"wrote {outdir / 'final.mdl'}")


def main(args):
    import jax
    import jax.numpy as jnp

    from beer_tpu import parallel
    from beer_tpu.utils import latest_checkpoint, load_model, save_model
    from beer_tpu.vbi import vb_step

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    ckpt = latest_checkpoint(outdir)
    start_epoch = 0
    if ckpt is not None:
        model = load_model(ckpt)
        start_epoch = int(re.search(r"epoch(\d+)", ckpt.name).group(1))
        print(f"resuming from {ckpt} (epoch {start_epoch})")
    else:
        model = load_model(args.model)

    if not args.transcriptions:
        if args.batch_size:
            _train_minibatch(args, model, outdir, start_epoch=start_epoch)
            return
        # Scalable by default: if the padded corpus monolith would blow
        # past --max-padded-gb, stream it instead — bucketed minibatches
        # with statistics accumulated over the epoch and one conjugate
        # update (identical math to full batch, bounded host memory).
        from beer_tpu import io as bio

        n, t_max, d, _ = bio.archive_geometry(args.feats)
        padded_gb = n * t_max * d * 4 / 2**30
        if padded_gb > args.max_padded_gb:
            bytes_per_utt = max(t_max * d * 4, 1)
            budget = args.max_padded_gb * 2**30 / 4
            args.batch_size = int(min(max(budget / bytes_per_utt, 1), 1024))
            args.accumulate_batches = True
            args.buckets = max(args.buckets, 8)
            print(
                f"corpus pads to {padded_gb:.1f} GB > "
                f"--max-padded-gb {args.max_padded_gb:g}; streaming exact "
                f"full-batch VB (batch-size {args.batch_size}, "
                f"{args.buckets} buckets, accumulate-batches)"
            )
            _train_minibatch(args, model, outdir, start_epoch=start_epoch)
            return

    keys, data, mask = pad_archive(args.feats)

    if args.transcriptions:
        import json

        from beer_tpu.models.graph import transcription_graphs
        from beer_tpu.models.hmm import HMM
        from beer_tpu.cli.subcommands.hmm_mkphones import read_transcriptions

        meta = json.loads(Path(args.model + ".phones.json").read_text())
        phone_idx = {p: i for i, p in enumerate(meta["phones"])}
        trans = read_transcriptions(args.transcriptions)
        seqs = [[phone_idx[p] for p in trans[k]] for k in keys]
        graphs = transcription_graphs(
            seqs, len(meta["phones"]), meta["states_per_phone"]
        )
        n_dev = len(jax.devices())
        n_frames = float(mask.sum())
        if n_dev > 1 and not args.single_device:
            # data-parallel supervised: graphs shard with the batch
            emissions = load_model(ckpt) if ckpt is not None else model
            mesh = parallel.make_mesh()
            data, valid = parallel.shard_batch(data, n_dev)
            mask, _ = parallel.shard_batch(mask, n_dev)
            mask = mask * valid[:, None]
            pad = data.shape[0] - len(seqs)
            if pad:  # replicate a graph for padded (zero-mask) utterances
                graphs = jax.tree.map(
                    lambda a: jnp.concatenate(
                        [a, jnp.repeat(a[:1], pad, axis=0)]
                    ) if hasattr(a, "ndim") and a.ndim and a.shape[0] == len(seqs) else a,
                    graphs,
                )
            step = parallel.make_supervised_vb_train_step(mesh, lrate=args.lrate)
            x, m = jnp.asarray(data), jnp.asarray(mask)
            print(f"supervised data-parallel over {n_dev} devices")
            for epoch in range(start_epoch + 1, args.epochs + 1):
                elbo, emissions = step(emissions, graphs, x, m)
                print(f"epoch {epoch}: elbo/frame = {float(elbo) / n_frames:.6f}")
                save_model(emissions, outdir / f"epoch{epoch:04d}.mdl")
            final_emissions = emissions
        else:
            # checkpoints hold the *emissions* modelset in both the
            # single-device and data-parallel branches (the graph is
            # rebuilt from the transcriptions), so a run may resume
            # under a different device count.
            emissions = load_model(ckpt) if ckpt is not None else model
            model = HMM.create(graphs, emissions)
            step = jax.jit(
                lambda m, x, msk: vb_step(m, x, lrate=args.lrate, mask=msk)
            )
            x, m = jnp.asarray(data), jnp.asarray(mask)
            for epoch in range(start_epoch + 1, args.epochs + 1):
                elbo, model = step(model, x, m)
                print(f"epoch {epoch}: elbo/frame = {float(elbo) / n_frames:.6f}")
                save_model(model.modelset, outdir / f"epoch{epoch:04d}.mdl")
            final_emissions = model.modelset
        # final artifact = the trained *emissions* (graph is per-corpus)
        save_model(final_emissions, outdir / "final.mdl")
        import shutil

        shutil.copy(args.model + ".phones.json",
                    outdir / "final.mdl.phones.json")
        print(f"wrote {outdir / 'final.mdl'}")
        return

    n_dev = len(jax.devices())
    if n_dev > 1 and not args.single_device:
        mesh = parallel.make_mesh()
        data, valid = parallel.shard_batch(data, n_dev)
        mask, _ = parallel.shard_batch(mask, n_dev)
        mask = mask * valid[:, None]
        step = parallel.make_vb_train_step(mesh, lrate=args.lrate)
        print(f"data-parallel over {n_dev} devices")
        if args.nan_guard:
            from beer_tpu.utils.debug import guard_finite_outputs

            check = guard_finite_outputs("vb_step[dp]")
            dp_raw = step

            def step(m, x, msk):
                out = dp_raw(m, x, msk)
                check(out)
                return out
    elif args.nan_guard:
        from beer_tpu.utils.debug import nan_guard

        guarded = jax.jit(nan_guard(
            lambda m, x, msk: vb_step(m, x, lrate=args.lrate, mask=msk),
            "vb_step",
        ))

        def step(m, x, msk):
            err, out = guarded(m, x, msk)
            err.throw()
            return out
    else:
        step = jax.jit(
            lambda m, x, msk: vb_step(m, x, lrate=args.lrate, mask=msk)
        )

    from beer_tpu.utils import MetricsLogger

    x, m = jnp.asarray(data), jnp.asarray(mask)
    n_frames = float(mask.sum())
    logger = MetricsLogger(outdir / "log", stdout=False)
    import time as _time

    for epoch in range(start_epoch + 1, args.epochs + 1):
        t0 = _time.time()
        elbo, model = step(model, x, m)
        elbo_val = float(elbo)  # forces completion before timing
        dt = _time.time() - t0
        print(f"epoch {epoch}: elbo/frame = {elbo_val / n_frames:.6f}")
        logger.log(epoch, elbo_per_frame=elbo_val / n_frames,
                   frames_per_sec=n_frames / dt)
        save_model(model, outdir / f"epoch{epoch:04d}.mdl")
    logger.close()
    save_model(model, outdir / "final.mdl")
    print(f"wrote {outdir / 'final.mdl'}")
