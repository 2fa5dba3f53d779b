"""Benchmark: VB E-step throughput (the BASELINE primary metric).

Covers all five BASELINE configs (BASELINE.md "Measurement protocol"):

* config 1 — Bayesian GMM VB-EM (full covariance, K components),
* config 2 — plain Bayesian HMM E-step (shared ergodic graph),
* config 3 — supervised HMM recognizer (per-utterance transcription
  graphs, MixtureSet emissions),
* config 4 — phone-loop AUD E-step (the headline metric): sufficient
  statistics → ELLH → forward-backward → accumulation on a realistic
  AUD shape (39-dim MFCC+Δ+Δ², 50 units × 3 states),
* config 5 — structured sequence VAE (phone-loop latent prior): the
  hybrid reparameterization + conjugate natural-step update.

Numerator: beer_tpu jitted steps on the GPU (the script refuses to run
without one).  Denominator, when PyTorch is installed: the same
algorithm in CPU PyTorch the way the reference runs it (vectorized ELLH;
per-utterance sequential ``for t in range(T)`` recursions for the HMM
configs — SURVEY.md §3.2), measured on a subset and scaled per-frame.

Prints the device record, then ONE JSON line.  The headline metric stays
the phone-loop E-step; the per-config results (value, vs_baseline) ride
in the ``configs`` field:

  {"metric": ..., "value": N, "unit": "frames/s", "vs_baseline": N,
   "configs": {"gmm": {...}, "hmm": {...}, "recognizer": {...},
               "phone_loop": {...}}}
"""

import argparse
import json
import os
import sys
import time

import numpy as np

B, T, D = 512, 500, 39
N_UNITS, STATES_PER_UNIT = 50, 3
S = N_UNITS * STATES_PER_UNIT
SEED = 0


def make_data(b=None, t=None, d=None):
    b, t, d = b or B, t or T, d or D
    rng = np.random.default_rng(SEED)
    data = rng.normal(size=(b, t, d)).astype(np.float32)
    lengths = rng.integers(t // 2, t + 1, size=b)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    return data, mask


N_SLOPES = 5


def _time_epochs(make_epochs, model, x, m, outer, frames_per_epoch, inner):
    """Device time per epoch via the SLOPE between two chained-epoch
    counts.

    Timing calls at `inner` and at `inner // 4` chained epochs and
    taking the slope cancels the per-call constant (dispatch, host
    fetch).  ``make_epochs(n)`` returns the jitted n-epoch trainer.

    Takes ``N_SLOPES`` INDEPENDENT slope measurements (each one
    big-chain call minus one small-chain call, interleaved so load
    drift hits both ends of a pair) and returns the MEDIAN throughput
    plus a spread dict.
    """
    n_small = max(1, inner // 4)

    def one_call(fn):
        t0 = time.time()
        m2, elbo = fn(model, x, m)
        e = float(elbo)
        return time.time() - t0, e

    def measure(big, small):
        fn_big, fn_small = make_epochs(big), make_epochs(small)
        _, elbo = one_call(fn_big)        # compile + warm
        one_call(fn_small)
        slopes = []
        for _ in range(max(N_SLOPES, outer)):
            t_big, _ = one_call(fn_big)
            t_small, _ = one_call(fn_small)
            slopes.append((t_big - t_small) / (big - small))
        return slopes, elbo

    slopes, elbo = measure(inner, n_small)
    # When the measured big-small span is under ~150 ms the single-pair
    # slopes are noise-dominated — rescale the chain lengths so the span
    # dominates the per-call jitter, and re-measure.  One extra compile per rescaled count; scan
    # compile time is ~length-independent.
    med_diff = float(np.median(slopes)) * (inner - n_small)
    if med_diff < 0.15:
        scale = min(64, max(2, int(np.ceil(0.3 / max(med_diff, 1e-3)))))
        slopes, elbo = measure(inner * scale, n_small * scale)
    rates = sorted(frames_per_epoch / dt for dt in slopes)
    spread = {
        "median": round(float(np.median(rates)), 1),
        "min": round(rates[0], 1),
        "max": round(rates[-1], 1),
        "n_slopes": len(rates),
    }
    return float(np.median(rates)), elbo, spread


# ----------------------------------------------------------------------
# config 4: phone-loop AUD E-step (headline)
# ----------------------------------------------------------------------
def bench_phone_loop(data, mask, outer=4, inner=20):
    import jax
    import jax.numpy as jnp

    import beer_tpu
    from beer_tpu.models.phoneloop import PhoneLoop
    from beer_tpu.vbi import vb_step

    nset = beer_tpu.NormalSet.create(
        jnp.zeros(D), jnp.ones(D), size=S, cov_type="diagonal",
        noise_std=0.5, key=jax.random.PRNGKey(1),
    )
    loop = PhoneLoop.create(N_UNITS, STATES_PER_UNIT, nset)
    x, m = jnp.asarray(data), jnp.asarray(mask)

    # `inner` full VB-EM epochs chained in one jitted scan so host
    # round-trip latency is amortized over real training work; each
    # call fetches the final ELBO to the host.
    def make_epochs(n):
        @jax.jit
        def train_epochs(model, x, mask):
            def body(model, _):
                elbo, model = vb_step(model, x, mask=mask)
                return model, elbo
            model, elbos = jax.lax.scan(body, model, None, length=n)
            return model, elbos[-1]
        return train_epochs

    return _time_epochs(
        make_epochs, loop, x, m, outer, float(mask.sum()), inner
    )


def torch_phone_loop(data, mask, n_utts=8):
    """The reference algorithm in CPU torch: per-utterance sequential loop."""
    import torch

    torch.set_num_threads(max(torch.get_num_threads(), 4))
    rng = np.random.default_rng(1)
    # diag-cov expected stats layout [lam, lam*mu, lam*mu^2, log lam] per dim
    e_lam = np.abs(rng.normal(1.0, 0.1, size=(S, D)))
    e_mu = rng.normal(size=(S, D))
    e_stats = np.concatenate(
        [e_lam, e_lam * e_mu, e_lam * e_mu**2, np.log(e_lam)], axis=1
    ).astype(np.float32)
    e_stats_t = torch.tensor(e_stats)

    # phone-loop transition structure (same as beer_tpu graph)
    lt = torch.full((S, S), -1e30)
    for u in range(N_UNITS):
        for i in range(STATES_PER_UNIT):
            st = u * STATES_PER_UNIT + i
            lt[st, st] = np.log(0.5)
            if i + 1 < STATES_PER_UNIT:
                lt[st, st + 1] = np.log(0.5)
    starts = torch.arange(N_UNITS) * STATES_PER_UNIT
    ends = starts + STATES_PER_UNIT - 1
    lt[ends[:, None], starts[None, :]] = np.log(0.25 / N_UNITS)
    li = torch.full((S,), -1e30)
    li[starts] = -np.log(N_UNITS)
    lf = torch.full((S,), -1e30)
    lf[ends] = np.log(0.25)
    return _torch_fb_loop(data, mask, e_stats_t, lt, li, lf, n_utts)


def _torch_fb_loop(data, mask, e_stats_t, lt, li, lf, n_utts):
    import torch

    s = lt.shape[0]
    d = data.shape[-1]
    total_frames = 0
    t0 = time.time()
    for b in range(n_utts):
        ln = int(mask[b].sum())
        x = torch.tensor(data[b, :ln])
        stats = torch.cat(
            [-0.5 * x**2, x, -0.5 * torch.ones_like(x), 0.5 * torch.ones_like(x)],
            dim=1,
        )
        llh = stats @ e_stats_t.T - 0.5 * d * np.log(2 * np.pi)
        log_alpha = torch.empty(ln, s)
        log_beta = torch.empty(ln, s)
        log_alpha[0] = li + llh[0]
        for t in range(1, ln):
            log_alpha[t] = llh[t] + torch.logsumexp(
                log_alpha[t - 1][:, None] + lt, dim=0
            )
        log_beta[-1] = lf
        for t in range(ln - 2, -1, -1):
            log_beta[t] = torch.logsumexp(
                lt + (llh[t + 1] + log_beta[t + 1])[None, :], dim=1
            )
        log_z = torch.logsumexp(log_alpha[-1] + lf, dim=0)
        post = torch.exp(log_alpha + log_beta - log_z)
        _ = post.T @ stats  # accumulate emission stats
        total_frames += ln
    dt = time.time() - t0
    return total_frames / dt


# ----------------------------------------------------------------------
# config 1: Bayesian GMM VB-EM (full covariance)
# ----------------------------------------------------------------------
GMM_K = 64


def bench_gmm(data, outer=4, inner=10):
    import jax
    import jax.numpy as jnp

    import beer_tpu
    from beer_tpu.vbi import vb_step

    flat = data.reshape(-1, D)
    nset = beer_tpu.NormalSet.create(
        jnp.zeros(D), jnp.eye(D), size=GMM_K, cov_type="full",
        noise_std=0.5, key=jax.random.PRNGKey(2),
    )
    gmm = beer_tpu.Mixture.create(nset)
    x = jnp.asarray(flat)

    def make_epochs(n):
        @jax.jit
        def train_epochs(model, x, _unused):
            def body(model, _):
                elbo, model = vb_step(model, x)
                return model, elbo
            model, elbos = jax.lax.scan(body, model, None, length=n)
            return model, elbos[-1]
        return train_epochs

    return _time_epochs(
        make_epochs, gmm, x, None, outer, float(flat.shape[0]), inner
    )


def torch_gmm(data, n_frames=32768):
    """Reference GMM VB-EM epoch in CPU torch — the REAL loop, not a
    stylized E-step: NormalWishart expectations (digamma, logdet),
    ELLH, responsibilities, and the closed-form conjugate M-step, via
    the same independent implementation the parity tests trust
    (tests/torch_ref.TorchVBGMM), in f32 like the reference default."""
    import os
    import sys

    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
    from torch_ref import TorchVBGMM

    rng = np.random.default_rng(2)
    flat = torch.tensor(data.reshape(-1, D)[:n_frames])
    n = flat.shape[0]
    mean = flat.mean(0)
    cov = torch.tensor(np.cov(flat.numpy().T).astype(np.float32))
    dof0 = D + 1.0
    w0 = torch.linalg.inv(cov) / dof0
    post_means = mean + 0.5 * torch.tensor(
        rng.normal(size=(GMM_K, D)).astype(np.float32))
    ref = TorchVBGMM(mean, 1.0, w0, dof0, torch.ones(GMM_K), post_means,
                     dtype=torch.float32)
    _, resps = ref.estep(flat)
    ref.mstep(flat, resps)  # warm epoch
    t0 = time.time()
    _, resps = ref.estep(flat)
    ref.mstep(flat, resps)
    dt = time.time() - t0
    return n / dt


# ----------------------------------------------------------------------
# config 2: plain Bayesian HMM E-step (shared ergodic graph)
# ----------------------------------------------------------------------
HMM_S = 30


def bench_hmm(data, mask, outer=4, inner=20):
    import jax
    import jax.numpy as jnp

    import beer_tpu
    from beer_tpu.models.graph import ergodic
    from beer_tpu.models.hmm import HMM
    from beer_tpu.vbi import vb_step

    g = ergodic(HMM_S)
    nset = beer_tpu.NormalSet.create(
        jnp.zeros(D), jnp.ones(D), size=HMM_S, cov_type="diagonal",
        noise_std=0.5, key=jax.random.PRNGKey(3),
    )
    hmm = HMM.create(g, nset, learn_transitions=True)
    x, m = jnp.asarray(data), jnp.asarray(mask)

    def make_epochs(n):
        @jax.jit
        def train_epochs(model, x, mask):
            def body(model, _):
                elbo, model = vb_step(model, x, mask=mask)
                return model, elbo
            model, elbos = jax.lax.scan(body, model, None, length=n)
            return model, elbos[-1]
        return train_epochs

    return _time_epochs(
        make_epochs, hmm, x, m, outer, float(mask.sum()), inner
    )


def torch_hmm(data, mask, n_utts=8):
    import torch

    rng = np.random.default_rng(3)
    e_lam = np.abs(rng.normal(1.0, 0.1, size=(HMM_S, D)))
    e_mu = rng.normal(size=(HMM_S, D))
    e_stats = torch.tensor(np.concatenate(
        [e_lam, e_lam * e_mu, e_lam * e_mu**2, np.log(e_lam)], axis=1
    ).astype(np.float32))
    lt = torch.full((HMM_S, HMM_S), float(np.log(1.0 / HMM_S)))
    li = torch.full((HMM_S,), float(-np.log(HMM_S)))
    lf = torch.zeros(HMM_S)
    return _torch_fb_loop(data, mask, e_stats, lt, li, lf, n_utts)


# ----------------------------------------------------------------------
# config 3: supervised recognizer (per-utterance graphs)
# ----------------------------------------------------------------------
REC_B, REC_T = 128, 300
REC_PHONES, REC_SPP = 10, 3


def bench_recognizer(outer=4, inner=10):
    import jax
    import jax.numpy as jnp

    import beer_tpu
    from beer_tpu.models.graph import transcription_graphs
    from beer_tpu.models.hmm import HMM
    from beer_tpu.vbi import vb_step

    rng = np.random.default_rng(4)
    data = rng.normal(size=(REC_B, REC_T, D)).astype(np.float32)
    mask = np.ones((REC_B, REC_T), np.float32)
    seqs = [list(rng.integers(REC_PHONES, size=6)) for _ in range(REC_B)]
    graphs = transcription_graphs(seqs, REC_PHONES, REC_SPP)
    nset = beer_tpu.NormalSet.create(
        jnp.zeros(D), jnp.ones(D), size=REC_PHONES * REC_SPP,
        cov_type="diagonal", noise_std=0.5, key=jax.random.PRNGKey(4),
    )
    hmm = HMM.create(graphs, nset)
    x, m = jnp.asarray(data), jnp.asarray(mask)

    def make_epochs(n):
        @jax.jit
        def train_epochs(model, x, mask):
            def body(model, _):
                elbo, model = vb_step(model, x, mask=mask)
                return model, elbo
            model, elbos = jax.lax.scan(body, model, None, length=n)
            return model, elbos[-1]
        return train_epochs

    rate, _elbo, spread = _time_epochs(
        make_epochs, hmm, x, m, outer, float(mask.sum()), inner
    )
    return rate, spread, data, mask, graphs


def torch_recognizer(data, mask, n_utts=8):
    import torch

    rng = np.random.default_rng(4)
    npdf = REC_PHONES * REC_SPP
    e_lam = np.abs(rng.normal(1.0, 0.1, size=(npdf, D)))
    e_mu = rng.normal(size=(npdf, D))
    e_stats = torch.tensor(np.concatenate(
        [e_lam, e_lam * e_mu, e_lam * e_mu**2, np.log(e_lam)], axis=1
    ).astype(np.float32))
    # left-to-right 6-phone graph per utterance (fresh matrix per utt —
    # the reference builds per-utterance alignment graphs)
    s = 6 * REC_SPP
    lt = torch.full((s, s), -1e30)
    for i in range(s):
        lt[i, i] = np.log(0.5)
        if i + 1 < s:
            lt[i, i + 1] = np.log(0.5)
    li = torch.full((s,), -1e30); li[0] = 0.0
    lf = torch.full((s,), -1e30); lf[-1] = np.log(0.5)
    # reuse the first s pdf rows as the per-state emissions
    return _torch_fb_loop(data, mask, e_stats[:s], lt, li, lf, n_utts)


# ----------------------------------------------------------------------
# config 5: structured sequence VAE (hybrid reparam + conjugate step)
# ----------------------------------------------------------------------
SVAE_DZ, SVAE_H = 16, 128
SVAE_UNITS, SVAE_SPU = 10, 3
SVAE_B, SVAE_T = 256, 250


def bench_svae(data, mask, outer=4, inner=10):
    """BASELINE config 5: SequenceVAE with a phone-loop latent prior —
    optax Adam on encoder/decoder + conjugate natural step on the prior
    in ONE jitted hybrid update (SURVEY.md §3.4)."""
    import jax
    import jax.numpy as jnp
    import optax

    import beer_tpu
    from beer_tpu.models.phoneloop import PhoneLoop
    from beer_tpu.models.vae import SequenceVAE, make_vae_train_step

    s = SVAE_UNITS * SVAE_SPU
    nset = beer_tpu.NormalSet.create(
        jnp.zeros(SVAE_DZ), jnp.ones(SVAE_DZ), size=s, cov_type="diagonal",
        noise_std=0.5, key=jax.random.PRNGKey(7),
    )
    loop = PhoneLoop.create(SVAE_UNITS, SVAE_SPU, nset)
    svae = SequenceVAE.create(
        obs_dim=D, latent_dim=SVAE_DZ, latent_model=loop,
        hidden=(SVAE_H, SVAE_H), nsamples=1, key=jax.random.PRNGKey(8),
    )
    tx = optax.adam(1e-3)
    opt_state = tx.init(svae.nnet_params)
    step_fn = make_vae_train_step(tx)

    x = jnp.asarray(data[:SVAE_B, :SVAE_T])
    m = jnp.asarray(mask[:SVAE_B, :SVAE_T])

    def make_epochs(n):
        @jax.jit
        def train_epochs(model, x, mask):
            def body(carry, _):
                vae, opt_state, key = carry
                key, sub = jax.random.split(key)
                elbo, vae, opt_state = step_fn(vae, opt_state, x, sub, mask)
                return (vae, opt_state, key), elbo
            vae, opt_state = model
            (vae, opt_state, _), elbos = jax.lax.scan(
                body, (vae, opt_state, jax.random.PRNGKey(99)), None,
                length=n,
            )
            return (vae, opt_state), elbos[-1]
        return train_epochs

    return _time_epochs(
        make_epochs, (svae, opt_state), x, m, outer, float(np.asarray(m).sum()),
        inner,
    )


def torch_svae(data, mask, n_utts=2):
    """Reference SVAE step in CPU torch (SURVEY.md §3.4): encoder MLP →
    rsample → per-utterance sequential forward for the phone-loop prior
    llh → decoder MLP → one `elbo.backward()` + Adam step."""
    import torch

    s = SVAE_UNITS * SVAE_SPU
    torch.manual_seed(0)
    enc = torch.nn.Sequential(
        torch.nn.Linear(D, SVAE_H), torch.nn.Tanh(),
        torch.nn.Linear(SVAE_H, SVAE_H), torch.nn.Tanh(),
        torch.nn.Linear(SVAE_H, 2 * SVAE_DZ),
    )
    dec = torch.nn.Sequential(
        torch.nn.Linear(SVAE_DZ, SVAE_H), torch.nn.Tanh(),
        torch.nn.Linear(SVAE_H, SVAE_H), torch.nn.Tanh(),
        torch.nn.Linear(SVAE_H, 2 * D),
    )
    opt = torch.optim.Adam(
        list(enc.parameters()) + list(dec.parameters()), lr=1e-3
    )
    rng = np.random.default_rng(7)
    e_lam = np.abs(rng.normal(1.0, 0.1, size=(s, SVAE_DZ)))
    e_mu = rng.normal(size=(s, SVAE_DZ))
    e_stats = torch.tensor(np.concatenate(
        [e_lam, e_lam * e_mu, e_lam * e_mu**2, np.log(e_lam)], axis=1
    ).astype(np.float32))
    lt = torch.full((s, s), -1e30)
    for u in range(SVAE_UNITS):
        for i in range(SVAE_SPU):
            st = u * SVAE_SPU + i
            lt[st, st] = np.log(0.5)
            if i + 1 < SVAE_SPU:
                lt[st, st + 1] = np.log(0.5)
    starts = torch.arange(SVAE_UNITS) * SVAE_SPU
    ends = starts + SVAE_SPU - 1
    lt[ends[:, None], starts[None, :]] = np.log(0.25 / SVAE_UNITS)
    li = torch.full((s,), -1e30); li[starts] = -float(np.log(SVAE_UNITS))

    total_frames, t0 = 0, time.time()
    for b in range(n_utts):
        ln = int(mask[b, :SVAE_T].sum())
        x = torch.tensor(data[b, :ln])
        opt.zero_grad()
        q = enc(x)
        mu, log_var = q[:, :SVAE_DZ], q[:, SVAE_DZ:]
        z = mu + torch.exp(0.5 * log_var) * torch.randn_like(mu)
        zstats = torch.cat(
            [-0.5 * z**2, z, -0.5 * torch.ones_like(z),
             0.5 * torch.ones_like(z)], dim=1,
        )
        llh = zstats @ e_stats.T
        log_alpha = li + llh[0]
        for t in range(1, ln):        # the reference's sequential prior
            log_alpha = llh[t] + torch.logsumexp(
                log_alpha[:, None] + lt, dim=0
            )
        prior = torch.logsumexp(log_alpha, dim=0)
        out = dec(z)
        dmu, dlog_var = out[:, :D], out[:, D:]
        rec = (-0.5 * ((x - dmu) ** 2) * torch.exp(-dlog_var)
               - 0.5 * dlog_var).sum()
        entropy = 0.5 * log_var.sum()
        elbo = rec + prior + entropy
        (-elbo).backward()            # nnet grads AND (reference) stats
        opt.step()
        total_frames += ln
    return total_frames / (time.time() - t0)


STREAM_UTTS, STREAM_TMIN, STREAM_TMAX = 12_800, 250, 500
STREAM_BATCH, STREAM_BUCKETS = 512, 4


def _stream_archive(path):
    """Synthetic corpus-scale archive (~5M frames, ~750 MB): written once,
    then mmap-served by the native loader across bench runs."""
    import os

    from beer_tpu import io as bio

    if os.path.exists(path):
        return
    print(f"# generating {path} ({STREAM_UTTS} utts)...", file=sys.stderr)
    rng = np.random.default_rng(SEED)
    utts = {}
    for i in range(STREAM_UTTS):
        t = int(rng.integers(STREAM_TMIN, STREAM_TMAX + 1))
        utts[f"utt{i:06d}"] = rng.normal(size=(t, D)).astype(np.float32)
    bio.write_archive(path, utts)


def bench_streamed(archive_path=None, epochs=3):
    """Corpus-scale streamed phone-loop AUD (SURVEY.md §2.10 scale-out):
    the config-4 model trained through io.BatchLoader (mmap'd .bar,
    native fill, bucketed static shapes, background prefetch) on a ~5M
    frame archive that never sits in device memory at once.

    Reports streamed frames/s, the in-memory step rate at the same
    shapes (resident-batch upper bound), loader-induced idle, and the
    number of distinct compiled shapes.
    """
    import jax
    import jax.numpy as jnp

    import beer_tpu
    from beer_tpu import io as bio
    from beer_tpu.models.phoneloop import PhoneLoop
    from beer_tpu.vbi import vb_step

    if archive_path is None:
        import tempfile

        archive_path = os.path.join(tempfile.gettempdir(),
                                    "beer_stream_bench.bar")
    _stream_archive(archive_path)
    archive = bio.Archive(archive_path)
    n_utts = len(archive)

    nset = beer_tpu.NormalSet.create(
        jnp.zeros(D), jnp.ones(D), size=S, cov_type="diagonal",
        noise_std=0.5, key=jax.random.PRNGKey(1),
    )
    model = PhoneLoop.create(N_UNITS, STATES_PER_UNIT, nset)
    step = jax.jit(lambda m, x, msk, ds: vb_step(m, x, datasize=ds,
                                                 mask=msk))
    loader = bio.BatchLoader(archive, STREAM_BATCH, seed=0,
                             buckets=STREAM_BUCKETS)

    stats = {}
    sync_diag = {}
    for epoch in range(epochs):
        # last epoch: fully async (the hmm-train trainer's real mode —
        # per-batch ELBOs stay lazy so H2D overlaps compute); earlier
        # epochs sync per batch so step_t measures real device time
        # (under async dispatch step_t would be dispatch-only noise, so
        # the device/idle diagnostics are taken from the last sync
        # epoch instead)
        async_mode = epoch == epochs - 1
        t0 = time.time()
        frames, step_t, n_batches = 0.0, 0.0, 0
        elbos = []
        for data, mask in loader:
            n_valid = data.shape[0]
            if n_valid < STREAM_BATCH:
                pad = STREAM_BATCH - n_valid
                data = np.concatenate(
                    [data, np.zeros((pad,) + data.shape[1:], data.dtype)])
                mask = np.concatenate(
                    [mask, np.zeros((pad,) + mask.shape[1:], mask.dtype)])
            x, msk = jnp.asarray(data), jnp.asarray(mask)
            ds = jnp.float32(n_utts * STREAM_BATCH / n_valid)
            t1 = time.time()
            elbo, model = step(model, x, msk, ds)
            if async_mode:
                elbos.append(elbo)
            else:
                float(elbo)
            step_t += time.time() - t1
            frames += float(mask.sum())
            n_batches += 1
        if async_mode:
            for e in elbos:
                float(e)
        wall = time.time() - t0
        if not async_mode:
            sync_diag = {
                "device_frames_per_s": frames / step_t,
                "loader_idle_pct": 100.0 * (wall - step_t) / wall,
                "sync_epoch_s": wall,
            }
        stats = {
            "streamed_frames_per_s": frames / wall,
            "n_batches": n_batches,
            "n_shapes": len(loader.bucket_t_max),
            "epoch_s": wall,
            "frames": frames,
            "async": async_mode,
            **sync_diag,
        }
        diag = (f"(per-batch-sync device {frames/step_t/1e6:.1f}M, "
                f"idle {100.0*(wall-step_t)/wall:.1f}%)"
                if not async_mode else "(pipelined)")
        print(f"# streamed epoch {epoch}"
              f"{' (async)' if async_mode else ''}: "
              f"{frames/wall/1e6:.1f}M f/s {diag}", file=sys.stderr)
    # resident-batch upper bound at the largest bucket shape: the same
    # jitted step re-run on one in-memory batch (no host loop, no loader)
    idx = list(loader.bucket_indices[-1][:STREAM_BATCH])
    data, mask = archive.padded_batch(idx, loader.bucket_t_max[-1])
    if data.shape[0] < STREAM_BATCH:
        pad = STREAM_BATCH - data.shape[0]
        data = np.concatenate(
            [data, np.zeros((pad,) + data.shape[1:], data.dtype)])
        mask = np.concatenate(
            [mask, np.zeros((pad,) + mask.shape[1:], mask.dtype)])
    x, msk = jnp.asarray(data), jnp.asarray(mask)
    ds = jnp.float32(n_utts)
    fr = float(mask.sum())
    float(step(model, x, msk, ds)[0])
    reps = 10
    t0 = time.time()
    for _ in range(reps):
        elbo, model = step(model, x, msk, ds)
        float(elbo)  # same per-step sync semantics as the streamed loop
    resident = fr * reps / (time.time() - t0)
    stats["resident_frames_per_s"] = resident
    stats["streamed_vs_resident_pct"] = round(
        100.0 * stats["streamed_frames_per_s"] / resident, 1)
    return stats


GSM_UPL, GSM_NLANG, GSM_SPU, GSM_EMBED, GSM_LANGD = 50, 3, 3, 8, 2
GSM_NSAMPLES = 4


def _gsm_unit_stats(rng, u, p, d):
    """Synthetic diagonal-layout per-unit-state stats (dict form of
    gsm.accumulate_unit_stats with transitions)."""
    c = rng.uniform(500.0, 2000.0, size=(u, p, 1)).astype(np.float32)
    mu = rng.normal(size=(u, p, 1, d)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, size=(u, p, 1, d)).astype(np.float32)
    cc = c[..., None]
    sx = cc * mu
    sxx = cc * (var + mu**2)
    emission = np.concatenate(
        [-0.5 * sxx, sx, np.broadcast_to(-0.5 * cc, sxx.shape),
         np.broadcast_to(0.5 * cc, sxx.shape)], axis=-1)
    return emission, c


def bench_gsm(outer=4, inner=2400):
    """Config 6: the H-SHMM subspace gradient step (recipe stage 7's
    dominant stage, SURVEY.md §3.5) — reparameterized ELBO grad + Adam
    over a 3-language hierarchical subspace, one lax.scan dispatch."""
    import jax
    import jax.numpy as jnp
    import optax

    from beer_tpu.models.gsm import (
        HierarchicalGSM, make_gsm_train_scan, train_key)

    u = GSM_UPL * GSM_NLANG
    unit_lang = sum(([i] * GSM_UPL for i in range(GSM_NLANG)), [])
    gsm = HierarchicalGSM.create(
        u, GSM_EMBED, D, lang_dim=GSM_LANGD, n_langs=GSM_NLANG,
        unit_lang=unit_lang, states_per_unit=GSM_SPU,
        learn_transitions=True, key=jax.random.PRNGKey(3),
    )
    rng = np.random.default_rng(5)
    emission, c = _gsm_unit_stats(rng, u, GSM_SPU, D)
    stats = {
        "emission": jnp.asarray(emission),
        "comp_counts": jnp.asarray(c),
        "self": jnp.asarray(0.9 * c[..., 0]),
        "adv": jnp.asarray(0.1 * c[..., 0]),
    }
    tx = optax.adam(5e-2)
    opt = tx.init(gsm)
    run = make_gsm_train_scan(tx, nsamples=GSM_NSAMPLES)
    key = train_key(11)  # rbg: hw RngBitGenerator, see gsm.GSM_RNG_IMPL
    lo = max(inner // 4, 1)

    def timed(n):
        t0 = time.time()
        e, g, o = run(gsm, opt, stats, None, key, n)
        float(e)  # host fetch: forces the whole scan
        return time.time() - t0

    timed(inner), timed(lo)  # compile both
    rates = sorted(
        (inner - lo) / (timed(inner) - timed(lo))
        for _ in range(max(N_SLOPES, outer))
    )
    med = float(np.median(rates))
    return med, {
        "median": round(med, 1),
        "min": round(rates[0], 1),
        "max": round(rates[-1], 1),
        "n_slopes": len(rates),
    }


def torch_gsm(inner=100):
    """The same H-SHMM subspace step in CPU torch: sample (e, lang, W),
    affine map + softplus links, expected-stats ELBO, backward + Adam."""
    import torch

    u = GSM_UPL * GSM_NLANG
    p, d, e_dim, l_dim = GSM_SPU, D, GSM_EMBED, GSM_LANGD
    out = p * 2 * d + p  # emissions + transition logits (K=1)
    torch.manual_seed(0)
    e_mean = torch.zeros(u, e_dim, requires_grad=True)
    e_logvar = torch.full((u, e_dim), -2.0, requires_grad=True)
    l_mean = torch.zeros(GSM_NLANG, l_dim, requires_grad=True)
    l_logvar = torch.full((GSM_NLANG, l_dim), -2.0, requires_grad=True)
    w_mean = torch.randn(e_dim + l_dim + 1, out) * 0.1
    w_mean.requires_grad_(True)
    w_logvar = torch.full((e_dim + l_dim + 1, out), -2.0, requires_grad=True)
    params = [e_mean, e_logvar, l_mean, l_logvar, w_mean, w_logvar]
    opt = torch.optim.Adam(params, lr=5e-2)

    rng = np.random.default_rng(5)
    emission, c = _gsm_unit_stats(rng, u, p, d)
    emission = torch.tensor(emission[:, :, 0])       # (U, P, 4D)
    counts = torch.tensor(c)                         # (U, P, 1)
    self_c = 0.9 * counts[..., 0]
    adv_c = 0.1 * counts[..., 0]
    unit_lang = torch.tensor(
        sum(([i] * GSM_UPL for i in range(GSM_NLANG)), []))
    s_sq, s_x = emission[..., :d], emission[..., d:2 * d]
    ns = GSM_NSAMPLES

    def step():
        opt.zero_grad()
        e = e_mean[None] + torch.exp(0.5 * e_logvar)[None] \
            * torch.randn(ns, u, e_dim)
        lang = l_mean[None] + torch.exp(0.5 * l_logvar)[None] \
            * torch.randn(ns, GSM_NLANG, l_dim)
        w = w_mean[None] + torch.exp(0.5 * w_logvar)[None] \
            * torch.randn(ns, e_dim + l_dim + 1, out)
        h = torch.cat([e, lang[:, unit_lang]], dim=-1)
        ones = torch.ones(ns, u, 1)
        raw = torch.cat([h, ones], dim=-1) @ w       # (S, U, out)
        em = raw[..., : p * 2 * d].reshape(ns, u, p, 2 * d)
        mu, lam = em[..., :d], torch.nn.functional.softplus(em[..., d:]) + 1e-4
        ll = (
            (s_sq[None] * lam).sum(-1) + (s_x[None] * lam * mu).sum(-1)
            - counts[None, ..., 0] * (
                0.5 * lam * mu**2 - 0.5 * torch.log(lam)
                + 0.5 * float(np.log(2 * np.pi))
            ).sum(-1)
        )
        t = raw[..., p * 2 * d:]
        ll = ll + self_c[None] * torch.nn.functional.logsigmoid(t) \
            + adv_c[None] * torch.nn.functional.logsigmoid(-t)
        kl = sum(
            0.5 * (torch.exp(lv) + m**2 - 1.0 - lv).sum()
            for m, lv in ((e_mean, e_logvar), (l_mean, l_logvar),
                          (w_mean, w_logvar))
        )
        loss = -(ll.sum() / ns - kl)
        loss.backward()
        opt.step()

    step()  # warm-up
    t0 = time.time()
    for _ in range(inner):
        step()
    return inner / (time.time() - t0)


# ----------------------------------------------------------------------
# configs 7/8: PPCA / PLDA closed-form VB-EM (the last two SURVEY §2
# model rows without perf evidence).  Embedding-
# scale shapes (speaker-verification style): D=256 vectors, Q=64
# subspace.
# ----------------------------------------------------------------------
PPCA_N, PPCA_D, PPCA_Q = 262144, 256, 64
PLDA_C, PLDA_PER, PLDA_D, PLDA_Q = 512, 64, 256, 64


def _ppca_data():
    rng = np.random.default_rng(11)
    w = rng.normal(size=(PPCA_D, PPCA_Q)) / np.sqrt(PPCA_Q)
    z = rng.normal(size=(PPCA_N, PPCA_Q))
    x = z @ w.T + 0.1 * rng.normal(size=(PPCA_N, PPCA_D))
    return x.astype(np.float32)


def _plda_data():
    rng = np.random.default_rng(12)
    f = rng.normal(size=(PLDA_D, PLDA_Q)) / np.sqrt(PLDA_Q)
    h = rng.normal(size=(PLDA_C, PLDA_Q))
    x = (np.repeat(h, PLDA_PER, 0) @ f.T
         + 0.3 * rng.normal(size=(PLDA_C * PLDA_PER, PLDA_D)))
    labels = np.repeat(np.arange(PLDA_C), PLDA_PER)
    return x.astype(np.float32), labels.astype(np.int32)


def bench_ppca(outer=4, inner=30):
    """Full PPCA VB-EM epoch (infer + accumulate + coordinate M-step),
    `inner` epochs chained in one jitted scan (slope method)."""
    import jax

    from beer_tpu.models.ppca import PPCA
    from beer_tpu.vbi import vb_step

    import jax.numpy as jnp

    x = jnp.asarray(_ppca_data())
    model = PPCA.create(PPCA_D, PPCA_Q, key=jax.random.PRNGKey(5))

    def make_epochs(n):
        @jax.jit
        def train(model, x, _m):
            def body(mdl, _):
                elbo, mdl = vb_step(mdl, x)
                return mdl, elbo

            mdl, elbos = jax.lax.scan(body, model, None, length=n)
            return mdl, elbos[-1]

        return train

    return _time_epochs(
        make_epochs, model, x, None, outer, float(PPCA_N), inner
    )


def torch_ppca():
    """The same closed-form PPCA VB-EM epoch in CPU torch f32."""
    import torch

    x = torch.tensor(_ppca_data())
    n, d, q = x.shape[0], PPCA_D, PPCA_Q
    torch.manual_seed(5)
    w = 0.5 * torch.randn(d, q)
    w_cov = torch.eye(q)
    mu = torch.zeros(d)
    a, b = torch.tensor(1.0), torch.tensor(1.0)

    def epoch(w, w_cov, mu, a, b):
        e_lam = a / b
        e_wtw = w.T @ w + d * w_cov
        cov_z = torch.linalg.inv(torch.eye(q) + e_lam * e_wtw)
        xc = x - mu
        m = e_lam * (xc @ w) @ cov_z
        s_z = n * cov_z + m.T @ m
        c = xc.T @ m
        w_cov2 = torch.linalg.inv(torch.eye(q) + e_lam * s_z)
        w2 = e_lam * c @ w_cov2
        e_wtw2 = w2.T @ w2 + d * w_cov2
        resid = ((xc**2).sum() - 2.0 * torch.trace(w2.T @ c)
                 + (e_wtw2 * s_z).sum())
        a2 = a + 0.5 * d * n
        b2 = b + 0.5 * resid
        mu2 = (x.sum(0) - w2 @ m.sum(0)) / n
        return w2, w_cov2, mu2, a2, b2

    state = epoch(w, w_cov, mu, a, b)  # warm
    t0 = time.time()
    epoch(*state)
    return n / (time.time() - t0)


def bench_plda(outer=4, inner=30):
    """Full PLDA VB-EM epoch with class labels (segment-sum E-step +
    per-dim batched F update), chained in one jitted scan."""
    import jax
    import jax.numpy as jnp

    from beer_tpu.models.plda import PLDA

    xd, ld = _plda_data()
    x, y = jnp.asarray(xd), jnp.asarray(ld)
    model = PLDA.create(PLDA_D, PLDA_Q, key=jax.random.PRNGKey(6))
    n = xd.shape[0]

    def make_epochs(nep):
        @jax.jit
        def train(model, x, yv):
            def body(mdl, _):
                stats = mdl.sufficient_statistics(x)
                llh, cache = mdl.infer(stats, labels=yv, n_classes=PLDA_C)
                elbo = llh.sum() - mdl.kl_div_posterior_prior()
                acc = mdl.accumulate(stats, cache)
                return mdl.vb_update(acc), elbo

            mdl, elbos = jax.lax.scan(body, model, None, length=nep)
            return mdl, elbos[-1]

        return train

    return _time_epochs(make_epochs, model, x, y, outer, float(n), inner)


def torch_plda():
    """The same PLDA VB-EM epoch in CPU torch f32 (index_add segment
    sums, batched per-dim F row update)."""
    import torch

    xd, ld = _plda_data()
    x = torch.tensor(xd)
    y = torch.tensor(ld, dtype=torch.long)
    n, d, q, n_cls = x.shape[0], PLDA_D, PLDA_Q, PLDA_C
    torch.manual_seed(6)
    f = 0.5 * torch.randn(d, q)
    f_cov = torch.eye(q).expand(d, q, q).clone()
    mu = torch.zeros(d)
    a, b = torch.ones(d), torch.ones(d)

    def epoch(f, f_cov, mu, a, b):
        e_lam = a / b
        e_ftlf = (f.T @ (e_lam[:, None] * f)
                  + torch.einsum("d,dij->ij", e_lam, f_cov))
        xc = x - mu
        counts = torch.zeros(n_cls).index_add_(0, y, torch.ones(n))
        cov_h = torch.linalg.inv(
            torch.eye(q)[None] + counts[:, None, None] * e_ftlf[None]
        )
        proj = xc @ (e_lam[:, None] * f)
        sum_proj = torch.zeros(n_cls, q).index_add_(0, y, proj)
        m_h = torch.einsum("cij,cj->ci", cov_h, sum_proj)
        e_hh = cov_h + m_h[:, :, None] * m_h[:, None, :]
        m_per = m_h[y]
        c_acc = xc.T @ m_per
        s_h = torch.einsum("c,cij->ij", counts, e_hh)
        f_cov2 = torch.linalg.inv(
            torch.eye(q)[None] + e_lam[:, None, None] * s_h[None]
        )
        f2 = torch.einsum("d,dq,dqr->dr", e_lam, c_acc, f_cov2)
        e_ff = torch.einsum("di,dj->dij", f2, f2) + f_cov2
        resid = ((xc**2).sum(0)
                 - 2.0 * torch.einsum("dq,dq->d", f2, c_acc)
                 + torch.einsum("dij,ij->d", e_ff, s_h))
        a2 = a + 0.5 * n
        b2 = b + 0.5 * resid
        mu2 = (x.sum(0) - f2 @ m_per.sum(0)) / n
        return f2, f_cov2, mu2, a2, b2

    state = epoch(f, f_cov, mu, a, b)  # warm
    t0 = time.time()
    epoch(*state)
    return n / (time.time() - t0)


def entry(value, baseline, spread=None, unit="frames/s"):
    out = {
        "value": round(value, 1),
        "unit": unit,
        "vs_baseline": (None if baseline is None
                        else round(value / baseline, 2)),
    }
    if spread is not None:
        out["spread"] = spread
    return out


def device_record():
    """The device this run measures: JAX's view plus the card's name and
    power limit.  Refuses to run without a GPU."""
    import subprocess

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"bench: JAX finds no GPU (devices: {devices})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "count": len(devices),
        "nvidia_smi": smi.splitlines(),
    }


def torch_baseline(fn, *args):
    """The CPU-torch denominator, or None where torch is not installed."""
    try:
        import torch  # noqa: F401
    except ImportError:
        return None
    return fn(*args)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs",
                    default="gmm,hmm,recognizer,svae,gsm,ppca,plda,"
                    "phone_loop",
                    help="comma list of configs to run")
    ap.add_argument("--streamed", action="store_true",
                    help="corpus-scale streamed-training bench (own JSON "
                    "line; skips the standard configs)")
    args = ap.parse_args()
    wanted = set(args.configs.split(","))

    from beer_tpu.utils import runtime

    device = device_record()
    print(json.dumps({"device": device}))
    runtime.setup_compile_cache()

    if args.streamed:
        stats = bench_streamed()
        print(json.dumps({
            "metric": "streamed_phone_loop_vb_throughput",
            "value": round(stats["streamed_frames_per_s"], 1),
            "unit": "frames/s",
            "vs_baseline": round(
                stats["streamed_frames_per_s"]
                / stats["resident_frames_per_s"], 3),
            "baseline": "resident-batch-same-shapes",
            "device": device,
            "detail": {k: round(v, 2) if isinstance(v, float) else v
                       for k, v in stats.items()},
        }))
        return 0

    data, mask = make_data()
    configs = {}

    def run_config(name, fn):
        # one config's failure must not take down the others; the exit
        # code reports it
        if name not in wanted:
            return
        try:
            configs[name] = fn()
        except Exception as e:  # noqa: BLE001 — report, then exit non-zero
            print(f"# {name}: FAILED ({type(e).__name__}: {e})",
                  file=sys.stderr)
            configs[name] = {"error": f"{type(e).__name__}: {e}"}

    def _gmm():
        v, _, sp = bench_gmm(data)
        return entry(v, torch_baseline(torch_gmm, data), sp)

    def _hmm():
        v, _, sp = bench_hmm(data, mask)
        return entry(v, torch_baseline(torch_hmm, data, mask), sp)

    def _recognizer():
        v, sp, rdata, rmask, _graphs = bench_recognizer()
        return entry(v, torch_baseline(torch_recognizer, rdata, rmask), sp)

    def _svae():
        v, _, sp = bench_svae(data, mask)
        return entry(v, torch_baseline(torch_svae, data, mask), sp)

    def _gsm():
        v, sp = bench_gsm()
        return entry(v, torch_baseline(torch_gsm), sp,
                     unit="subspace_steps/s")

    def _ppca():
        v, _, sp = bench_ppca()
        return entry(v, torch_baseline(torch_ppca), sp)

    def _plda():
        v, _, sp = bench_plda()
        return entry(v, torch_baseline(torch_plda), sp)

    def _phone_loop():
        v, _, sp = bench_phone_loop(data, mask)
        return entry(v, torch_baseline(torch_phone_loop, data, mask), sp)

    for name, fn in [("gmm", _gmm), ("hmm", _hmm),
                     ("recognizer", _recognizer), ("svae", _svae),
                     ("gsm", _gsm), ("ppca", _ppca), ("plda", _plda),
                     ("phone_loop", _phone_loop)]:
        run_config(name, fn)

    head = configs.get("phone_loop", {})
    result = {
        "metric": "phone_loop_vb_estep_throughput",
        "value": head.get("value"),
        "unit": "frames/s",
        "vs_baseline": head.get("vs_baseline"),
        # the upstream repo publishes no numbers, so the denominator is
        # this file's re-implementation of the reference algorithm
        # (sequential per-utterance loop) in CPU torch, when installed
        "baseline": "reimplemented-torch-cpu",
        "device": device,
        "configs": configs,
    }
    print(json.dumps(result))
    failed = [name for name, c in configs.items() if "error" in c]
    for name, c in configs.items():
        if name not in failed:
            print(f"# {name}: {c['value']:,.0f} {c['unit']} | "
                  f"vs torch-cpu {c['vs_baseline']}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
