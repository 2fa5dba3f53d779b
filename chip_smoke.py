"""Smoke check on one GPU: the system's main path, its kernels and every
model family, at the benchmark's widths.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python chip_smoke.py           # phases a-e on one card
    python chip_smoke.py --four    # only phase f, on four cards

Phases (each prints its own lines; any failure exits non-zero):

a. device    JAX must find a GPU; prints versions, card name, power limit.
b. main path phone-loop AUD VB-EM at bench width (B=512, T=500, D=39,
             50 units x 3 states), 5 jitted ``vb_step`` epochs: ELBO finite
             and monotone, within 1e-4 nats/frame of the same epochs in
             float64 on the CPU (a subprocess, so one process opens the
             card).
c. CLI       ``hmm mkphoneloop`` -> ``hmm train --epochs 2`` on synthetic
             speech features, then reload the last checkpoint.
d. kernel    the Pallas HMM scan pair against the plain ``lax.scan`` route
             at the phone-loop (S=150) and HMM (S=30) shapes: log Z and
             posteriors, median times of the E-step and of the full
             jitted ``vb_step`` for both routes.
e. families  one jitted step of gmm, hmm, recognizer, svae, gsm, ppca and
             plda at the benchmark's shapes: finite ELBO or loss.
f. --four    the data-parallel step of ``beer hmm train`` on 4 cards
             against the same batch on 1 card.

The last line of standard output is one JSON object with the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
EPOCHS = 5
ELBO_TOL = 1e-4          # nats/frame, GPU float32 vs CPU float64
# kernel vs plain scan, both float32: log Z sums ~T log-normalizers, so
# its rounding is relative to |log Z| (1e-6 is ~8 float32 ulps)
LOGZ_TOL = 1e-6          # max |ΔlogZ| / |logZ|
GAMMA_TOL = 1e-5         # max |Δγ|, kernel vs plain scan
N_TIMED = 10


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def phone_loop_setup(dtype="float32"):
    """The bench-width phone loop and its data, made from fixed seeds."""
    import jax
    import jax.numpy as jnp

    import bench
    import beer_tpu
    from beer_tpu.models.phoneloop import PhoneLoop

    data, mask = bench.make_data()
    # built in float32 under either x64 setting, so both runs start from
    # the same parameters
    f32 = jnp.float32
    nset = beer_tpu.NormalSet.create(
        jnp.zeros(bench.D, f32), jnp.ones(bench.D, f32), size=bench.S,
        cov_type="diagonal", noise_std=0.5, key=jax.random.PRNGKey(1),
    )
    loop = PhoneLoop.create(bench.N_UNITS, bench.STATES_PER_UNIT, nset)
    if dtype == "float64":
        loop = jax.tree.map(
            lambda a: a.astype(jnp.float64)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, loop)
        data, mask = data.astype(np.float64), mask.astype(np.float64)
    return loop, data, mask


def train_epochs(loop, data, mask, epochs=EPOCHS):
    """Per-frame ELBO of ``epochs`` jitted vb_step calls."""
    import jax
    import jax.numpy as jnp

    from beer_tpu.vbi import vb_step

    step = jax.jit(vb_step)
    x, m = jnp.asarray(data), jnp.asarray(mask)
    frames = float(mask.sum())
    elbos = []
    for _ in range(epochs):
        elbo, loop = step(loop, x, mask=m)
        elbos.append(float(elbo) / frames)
    return elbos


def cpu_reference(out_path):
    """The float64 CPU side of phase b (run as a subprocess)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    loop, data, mask = phone_loop_setup("float64")
    Path(out_path).write_text(json.dumps(train_epochs(loop, data, mask)))


def start_cpu_reference(tmp):
    out = Path(tmp) / "cpu_elbos.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "chip_smoke.py"), "--cpu-reference",
         str(out)], env=env, cwd=REPO)
    return proc, out


# ----------------------------------------------------------------------
def phase_device():
    import jax
    import jaxlib

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX finds no GPU (devices: {devices})")
    log("a", f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
             f"{len(devices)} x {devices[0].device_kind}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return devices


def phase_main_path(cpu_proc, cpu_out):
    import jax.numpy as jnp

    from beer_tpu.ops import triton_scan

    loop, data, mask = phone_loop_setup()
    trans = loop._effective_graph().log_trans
    route = ("pallas-triton kernel pair"
             if triton_scan.use_kernel(trans, jnp.float32) else "lax.scan")
    log("b", f"phone loop B={data.shape[0]} T={data.shape[1]} "
             f"D={data.shape[2]} S={loop.n_states}, scan route: {route}")
    t0 = time.perf_counter()
    elbos = train_epochs(loop, data, mask)
    log("b", f"{EPOCHS} epochs in {time.perf_counter() - t0:.1f} s "
             f"(compile included); ELBO/frame {elbos}")
    if not np.all(np.isfinite(elbos)):
        raise AssertionError(f"non-finite ELBO: {elbos}")
    if np.any(np.diff(elbos) < 0):
        raise AssertionError(f"ELBO not monotone: {elbos}")
    if cpu_proc.wait() != 0:
        raise AssertionError("float64 CPU reference run failed")
    ref = json.loads(Path(cpu_out).read_text())
    drift = float(np.max(np.abs(np.asarray(elbos) - np.asarray(ref))))
    log("b", f"CPU float64 ELBO/frame {ref}; max |Δ| {drift:.3e} "
             f"(limit {ELBO_TOL})")
    if drift > ELBO_TOL:
        raise AssertionError(f"GPU vs CPU float64 drift {drift}")
    return route


def phase_cli(tmp):
    sys.path.insert(0, str(REPO / "recipes" / "lib"))
    import aud_synth

    from beer_tpu.cli.main import main as cli
    from beer_tpu.utils import latest_checkpoint, load_model

    work = Path(tmp) / "cli"
    rng = np.random.default_rng(0)
    steady, allo = aud_synth.make_inventory(rng, 8)
    unigram = rng.dirichlet(np.full(8, 3.0))
    aud_synth.make_split(rng, "smoke", steady, allo, unigram, work, 24)
    conf = REPO / "recipes" / "aud" / "conf"
    steps = [
        ["dataset", "create", str(work / "wav_smoke.scp"),
         str(work / "manifest.json")],
        ["features", "extract", str(conf / "features.yml"),
         str(work / "manifest.json"), str(work / "feats.npz")],
        ["hmm", "mkphoneloop", str(conf / "hmm.yml"),
         str(work / "feats.npz"), str(work / "init.mdl")],
        ["hmm", "train", str(work / "init.mdl"), str(work / "feats.npz"),
         str(work / "exp"), "--epochs", "2", "--single-device",
         "--device", "gpu"],
    ]
    for argv in steps:
        t0 = time.perf_counter()
        rc = cli(argv)
        log("c", f"beer {' '.join(argv[:2])}: rc {rc}, "
                 f"{time.perf_counter() - t0:.1f} s")
        if rc != 0:
            raise AssertionError(f"beer {' '.join(argv)} returned {rc}")
    ckpt = latest_checkpoint(work / "exp")
    model = load_model(ckpt)
    log("c", f"reloaded {ckpt.name}: {type(model).__name__} with "
             f"{model.n_units} units")


def _median_ms(fn, args):
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(N_TIMED):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def phase_kernel():
    import jax
    import jax.numpy as jnp

    import bench
    import beer_tpu
    from beer_tpu.models.graph import ergodic
    from beer_tpu.models.hmm import HMM
    from beer_tpu.ops import semiring_scan, triton_scan
    from beer_tpu.vbi import vb_step

    loop, data, mask = phone_loop_setup()
    nset = beer_tpu.NormalSet.create(
        jnp.zeros(bench.D), jnp.ones(bench.D), size=bench.HMM_S,
        cov_type="diagonal", noise_std=0.5, key=jax.random.PRNGKey(3))
    hmm = HMM.create(ergodic(bench.HMM_S), nset, learn_transitions=True)
    x, m = jnp.asarray(data), jnp.asarray(mask)
    log("d", f"kernel products: {triton_scan.PRECISION.name} "
             f"(exact float32 FMA), batch tile {triton_scan.BATCH_TILE}, "
             f"chunk <= {triton_scan.MAX_CHUNK}")
    use_kernel = triton_scan.use_kernel
    for name, model, graph in [
        ("phone_loop", loop, loop._effective_graph()),
        ("hmm", hmm, hmm.graph.replace(log_trans=hmm._effective_log_trans())),
    ]:
        llh = model.modelset.expected_log_likelihood(
            model.sufficient_statistics(x))
        llh = graph.expand_llh(llh) if name == "hmm" else llh
        args = (llh, graph.log_trans, graph.log_init, graph.log_final, m)
        out, times = {}, {}
        for route in ("plain", "kernel"):
            triton_scan.use_kernel = (
                use_kernel if route == "kernel" else (lambda t, d: False))
            try:
                # fresh closures: each route traces (and compiles) anew
                estep = jax.jit(
                    lambda *a: semiring_scan.forward_backward_probs(*a))
                step = jax.jit(lambda mdl, x, m: vb_step(mdl, x, mask=m))
                out[route] = estep(*args)
                times[f"estep_{route}_ms"] = _median_ms(estep, args)
                times[f"vb_step_{route}_ms"] = _median_ms(
                    step, (model, x, m))
            finally:
                triton_scan.use_kernel = use_kernel
        dz = float(jnp.max(jnp.abs(out["kernel"].log_z - out["plain"].log_z)
                           / jnp.maximum(jnp.abs(out["plain"].log_z), 1.0)))
        dg = float(jnp.max(jnp.abs(out["kernel"].posteriors
                                   - out["plain"].posteriors)))
        log("d", f"{name} S={llh.shape[-1]}: |ΔlogZ|/|logZ| {dz:.2e} "
                 f"(limit {LOGZ_TOL}), max |Δγ| {dg:.2e} (limit {GAMMA_TOL})")
        log("d", f"{name} median of {N_TIMED}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in times.items()))
        if not (dz <= LOGZ_TOL and dg <= GAMMA_TOL):
            raise AssertionError(f"{name}: kernel disagrees with lax.scan")


def phase_families():
    import jax
    import jax.numpy as jnp
    import optax

    import bench
    import beer_tpu
    from beer_tpu.models.graph import ergodic, transcription_graphs
    from beer_tpu.models.gsm import (
        HierarchicalGSM, make_gsm_train_scan, train_key)
    from beer_tpu.models.hmm import HMM
    from beer_tpu.models.phoneloop import PhoneLoop
    from beer_tpu.models.plda import PLDA
    from beer_tpu.models.ppca import PPCA
    from beer_tpu.models.vae import SequenceVAE, make_vae_train_step
    from beer_tpu.vbi import vb_step

    d = bench.D
    data, mask = bench.make_data()
    x, m = jnp.asarray(data), jnp.asarray(mask)

    def diag_set(size, seed, dim=d):
        return beer_tpu.NormalSet.create(
            jnp.zeros(dim), jnp.ones(dim), size=size, cov_type="diagonal",
            noise_std=0.5, key=jax.random.PRNGKey(seed))

    def gmm():
        nset = beer_tpu.NormalSet.create(
            jnp.zeros(d), jnp.eye(d), size=bench.GMM_K, cov_type="full",
            noise_std=0.5, key=jax.random.PRNGKey(2))
        return jax.jit(vb_step)(beer_tpu.Mixture.create(nset),
                                x.reshape(-1, d))[0]

    def hmm():
        model = HMM.create(ergodic(bench.HMM_S), diag_set(bench.HMM_S, 3),
                           learn_transitions=True)
        return jax.jit(vb_step)(model, x, mask=m)[0]

    def recognizer():
        rng = np.random.default_rng(4)
        rx = rng.normal(size=(bench.REC_B, bench.REC_T, d)).astype(np.float32)
        seqs = [list(rng.integers(bench.REC_PHONES, size=6))
                for _ in range(bench.REC_B)]
        graphs = transcription_graphs(seqs, bench.REC_PHONES, bench.REC_SPP)
        model = HMM.create(graphs,
                           diag_set(bench.REC_PHONES * bench.REC_SPP, 4))
        rm = jnp.ones((bench.REC_B, bench.REC_T), jnp.float32)
        return jax.jit(vb_step)(model, jnp.asarray(rx), mask=rm)[0]

    def svae():
        loop = PhoneLoop.create(
            bench.SVAE_UNITS, bench.SVAE_SPU,
            diag_set(bench.SVAE_UNITS * bench.SVAE_SPU, 7, bench.SVAE_DZ))
        vae = SequenceVAE.create(
            obs_dim=d, latent_dim=bench.SVAE_DZ, latent_model=loop,
            hidden=(bench.SVAE_H, bench.SVAE_H), nsamples=1,
            key=jax.random.PRNGKey(8))
        tx = optax.adam(1e-3)
        step = make_vae_train_step(tx)
        return step(vae, tx.init(vae.nnet_params),
                    x[:bench.SVAE_B, :bench.SVAE_T], jax.random.PRNGKey(9),
                    m[:bench.SVAE_B, :bench.SVAE_T])[0]

    def gsm():
        u = bench.GSM_UPL * bench.GSM_NLANG
        model = HierarchicalGSM.create(
            u, bench.GSM_EMBED, d, lang_dim=bench.GSM_LANGD,
            n_langs=bench.GSM_NLANG,
            unit_lang=sum(([i] * bench.GSM_UPL
                           for i in range(bench.GSM_NLANG)), []),
            states_per_unit=bench.GSM_SPU, learn_transitions=True,
            key=jax.random.PRNGKey(3))
        emission, c = bench._gsm_unit_stats(
            np.random.default_rng(5), u, bench.GSM_SPU, d)
        stats = {"emission": jnp.asarray(emission),
                 "comp_counts": jnp.asarray(c),
                 "self": jnp.asarray(0.9 * c[..., 0]),
                 "adv": jnp.asarray(0.1 * c[..., 0])}
        tx = optax.adam(5e-2)
        run = make_gsm_train_scan(tx, nsamples=bench.GSM_NSAMPLES)
        return run(model, tx.init(model), stats, None, train_key(11), 1)[0]

    def ppca():
        model = PPCA.create(bench.PPCA_D, bench.PPCA_Q,
                            key=jax.random.PRNGKey(5))
        return jax.jit(vb_step)(model, jnp.asarray(bench._ppca_data()))[0]

    def plda():
        xd, ld = bench._plda_data()
        model = PLDA.create(bench.PLDA_D, bench.PLDA_Q,
                            key=jax.random.PRNGKey(6))

        @jax.jit
        def step(mdl, x, y):
            stats = mdl.sufficient_statistics(x)
            llh, _ = mdl.infer(stats, labels=y, n_classes=bench.PLDA_C)
            return llh.sum() - mdl.kl_div_posterior_prior()

        return step(model, jnp.asarray(xd), jnp.asarray(ld))

    for name, fn in [("gmm", gmm), ("hmm", hmm), ("recognizer", recognizer),
                     ("svae", svae), ("gsm", gsm), ("ppca", ppca),
                     ("plda", plda)]:
        t0 = time.perf_counter()
        value = float(fn())
        log("e", f"{name}: ELBO/loss {value:.6g} "
                 f"({time.perf_counter() - t0:.1f} s, compile included)")
        if not np.isfinite(value):
            raise AssertionError(f"{name}: non-finite ELBO {value}")


def phase_four():
    import jax
    import jax.numpy as jnp

    from beer_tpu import parallel

    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"--four needs 4 GPUs, JAX finds {len(devices)}")
    loop, data, mask = phone_loop_setup()
    x, m = jnp.asarray(data), jnp.asarray(mask)
    out, times = {}, {}
    for n in (4, 1):
        estep = parallel.make_vb_estep(parallel.make_mesh(n))
        step = parallel.make_vb_train_step(parallel.make_mesh(n))
        out[n] = estep(loop, x, m)
        times[n] = _median_ms(step, (loop, x, m))
        log("f", f"{n} card(s): data-parallel vb_step median "
                 f"{times[n]:.3f} ms over {N_TIMED} runs")
    elbo_rel = abs(float(out[4][0]) - float(out[1][0])) / abs(float(out[1][0]))
    stat_rel = max(
        float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))
        for a, b in zip(map(np.asarray, jax.tree.leaves(out[4][1])),
                        map(np.asarray, jax.tree.leaves(out[1][1]))))
    log("f", f"4 vs 1 card: ELBO rel. diff {elbo_rel:.2e}, statistics max "
             f"rel. diff {stat_rel:.2e} (limit 1e-5 each)")
    if not (elbo_rel <= 1e-5 and stat_rel <= 1e-5):
        raise AssertionError("4-card statistics disagree with 1 card")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card data-parallel phase")
    ap.add_argument("--cpu-reference", metavar="OUT",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    if args.cpu_reference:
        cpu_reference(args.cpu_reference)
        return 0

    from beer_tpu.utils import runtime

    devices = phase_device()
    log("a", f"compile cache: {runtime.setup_compile_cache()}")
    if args.four:
        phase_four()
    else:
        with tempfile.TemporaryDirectory() as tmp:
            cpu_proc, cpu_out = start_cpu_reference(tmp)
            try:
                phase_main_path(cpu_proc, cpu_out)
            finally:
                if cpu_proc.poll() is None:
                    cpu_proc.kill()
                    cpu_proc.wait()
            phase_cli(tmp)
        phase_kernel()
        phase_families()
    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
