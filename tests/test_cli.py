"""End-to-end CLI smoke test: the full AUD recipe flow on synthetic audio.

dataset create → features extract → hmm mkphoneloop → hmm train (with
resume) → hmm decode, exactly the reference recipe pipeline (SURVEY §3.3)
driven through ``python -m beer_tpu.cli``'s entry point.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from beer_tpu.cli.main import main as cli


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("aud")
    wav_dir = root / "audio"
    wav_dir.mkdir()
    # synthetic "speech": random tone segments at 16 kHz, ~0.5 s each
    scp_lines = []
    for i in range(4):
        sig = np.concatenate(
            [
                np.sin(
                    2 * np.pi * float(rng.uniform(80, 400))
                    * np.arange(4000) / 16000.0
                )
                for _ in range(3)
            ]
        ).astype(np.float32)
        path = wav_dir / f"utt{i}.npy"
        np.save(path, sig)
        scp_lines.append(f"utt{i} {path}")
    (root / "wav.scp").write_text("\n".join(scp_lines))
    (root / "features.yml").write_text(
        "feature_type: fbank\nn_filters: 10\ndeltas: false\nsrate: 16000\n"
    )
    (root / "hmm.yml").write_text(
        "n_units: 4\nstates_per_unit: 2\ncov_type: diagonal\nconcentration: 2.0\n"
    )
    return root


def test_full_pipeline(workdir):
    root = workdir
    assert cli(["dataset", "create", str(root / "wav.scp"), str(root / "manifest.json")]) == 0
    manifest = json.loads((root / "manifest.json").read_text())
    assert len(manifest["utterances"]) == 4

    assert cli([
        "features", "extract", str(root / "features.yml"),
        str(root / "manifest.json"), str(root / "feats.npz"),
    ]) == 0
    feats = np.load(root / "feats.npz")
    assert len(feats.files) == 4 and feats["utt0"].shape[-1] == 10

    assert cli([
        "hmm", "mkphoneloop", str(root / "hmm.yml"),
        str(root / "feats.npz"), str(root / "init.mdl"),
    ]) == 0

    assert cli([
        "hmm", "train", str(root / "init.mdl"), str(root / "feats.npz"),
        str(root / "exp"), "--epochs", "3", "--single-device",
    ]) == 0
    assert (root / "exp" / "final.mdl").exists()

    # resume: asking for more epochs continues from epoch 3
    assert cli([
        "hmm", "train", str(root / "init.mdl"), str(root / "feats.npz"),
        str(root / "exp"), "--epochs", "5", "--single-device",
    ]) == 0
    assert (root / "exp" / "epoch0005.mdl").exists()

    assert cli([
        "hmm", "decode", str(root / "exp" / "final.mdl"),
        str(root / "feats.npz"), str(root / "trans.txt"),
    ]) == 0
    lines = (root / "trans.txt").read_text().splitlines()
    assert len(lines) == 4
    assert all(line.split()[1].startswith("au") for line in lines)


def test_supervised_pipeline(workdir, tmp_path):
    """mkphones -> train --transcriptions -> decode --phone-lm (config 3)."""
    root = workdir
    exp = tmp_path / "sup"
    exp.mkdir()
    # fake transcriptions over the 4 utterances (3 segments each)
    trans = exp / "train.trans"
    trans.write_text(
        "\n".join(f"utt{i} a b c" for i in range(4)) + "\n"
    )
    (exp / "phones.yml").write_text(
        "states_per_phone: 2\nncomp_per_state: 1\ncov_type: diagonal\n"
    )
    assert cli([
        "hmm", "mkphones", str(exp / "phones.yml"), str(root / "feats.npz"),
        str(trans), str(exp / "emissions.mdl"),
    ]) == 0
    assert (exp / "emissions.mdl.phones.json").exists()

    assert cli([
        "hmm", "train", str(exp / "emissions.mdl"), str(root / "feats.npz"),
        str(exp / "exp"), "--epochs", "3",
        "--transcriptions", str(trans),
    ]) == 0
    assert (exp / "exp" / "final.mdl").exists()

    assert cli([
        "hmm", "decode", str(exp / "exp" / "final.mdl"),
        str(root / "feats.npz"), str(exp / "hyp.txt"), "--phone-lm",
    ]) == 0
    lines = (exp / "hyp.txt").read_text().splitlines()
    assert len(lines) == 4
    symbols = set(lines[0].split()[1:])
    assert symbols <= {"a", "b", "c"}


def test_shmm_pipeline(workdir, tmp_path):
    """shmm train on a trained phone loop (subspace alternation)."""
    root = workdir
    exp = tmp_path / "shmm"
    assert cli([
        "shmm", "train", str(root / "exp" / "final.mdl"),
        str(root / "feats.npz"), str(exp),
        "--embed-dim", "2", "--outer-iters", "2", "--inner-iters", "50",
    ]) == 0
    assert (exp / "final.mdl").exists() and (exp / "gsm.mdl").exists()
    from beer_tpu.utils import load_model

    gsm = load_model(exp / "gsm.mdl")
    assert gsm.e_mean.shape[0] == 4  # n_units from the aud fixture config


def test_minibatch_training(workdir, tmp_path):
    """Stochastic VB minibatch path (--batch-size) with .bar conversion."""
    root = workdir
    exp = tmp_path / "mb"
    assert cli([
        "hmm", "train", str(root / "init.mdl"), str(root / "feats.npz"),
        str(exp), "--epochs", "3", "--batch-size", "3", "--lrate", "0.5",
    ]) == 0
    assert (exp / "final.mdl").exists()
    # the npz was converted to a native archive for mmap'd minibatches
    assert (root / "feats.npz.bar").exists()


def test_dataset_create_from_directory(workdir, tmp_path):
    """dataset create accepts a directory of audio files."""
    root = workdir
    out = tmp_path / "dir_manifest.json"
    assert cli(["dataset", "create", str(root / "audio"), str(out)]) == 0
    manifest = json.loads(out.read_text())
    assert len(manifest["utterances"]) == 4
    assert all(k.startswith("utt") for k in manifest["utterances"])


def test_forced_alignment_cli(workdir, tmp_path):
    """hmm align emits per-frame phone labels matching utterance lengths."""
    root = workdir
    exp = tmp_path / "ali"
    exp.mkdir()
    trans = exp / "train.trans"
    trans.write_text("\n".join(f"utt{i} a b c" for i in range(4)) + "\n")
    (exp / "phones.yml").write_text("states_per_phone: 2\nncomp_per_state: 1\n")
    assert cli([
        "hmm", "mkphones", str(exp / "phones.yml"), str(root / "feats.npz"),
        str(trans), str(exp / "emissions.mdl"),
    ]) == 0
    assert cli([
        "hmm", "align", str(exp / "emissions.mdl"), str(root / "feats.npz"),
        str(trans), str(exp / "ali.txt"),
    ]) == 0
    feats = np.load(root / "feats.npz")
    for line in (exp / "ali.txt").read_text().splitlines():
        parts = line.split()
        assert len(parts) - 1 == feats[parts[0]].shape[0]
        assert set(parts[1:]) <= {"a", "b", "c"}


def test_cmvn_global(workdir, tmp_path):
    root = workdir
    # self-sufficient: (re)create the manifest for standalone runs
    assert cli(["dataset", "create", str(root / "wav.scp"),
                str(root / "manifest.json")]) == 0
    out = tmp_path / "feats_cmvn.npz"
    assert cli([
        "features", "extract", str(root / "features.yml"),
        str(root / "manifest.json"), str(out), "--cmvn", "global",
    ]) == 0
    feats = np.load(out)
    flat = np.concatenate([feats[k] for k in feats.files])
    np.testing.assert_allclose(flat.mean(0), 0.0, atol=1e-4)
    np.testing.assert_allclose(flat.std(0), 1.0, atol=1e-3)


def test_mkphoneloop_hyperprior(workdir, tmp_path):
    """hyperprior: true builds an SBCategoricalHyperPrior unit LM."""
    from beer_tpu.models.categorical import SBCategoricalHyperPrior
    from beer_tpu.utils import load_model

    root = workdir
    conf = tmp_path / "hmm_hp.yml"
    conf.write_text(
        "n_units: 3\nstates_per_unit: 2\ncov_type: diagonal\nhyperprior: true\n"
    )
    out = tmp_path / "hp.mdl"
    assert cli(["hmm", "mkphoneloop", str(conf), str(root / "feats.npz"),
                str(out)]) == 0
    loop = load_model(out)
    assert isinstance(loop.unit_prior, SBCategoricalHyperPrior)
    # and it trains through the CLI
    assert cli(["hmm", "train", str(out), str(root / "feats.npz"),
                str(tmp_path / "exp_hp"), "--epochs", "2",
                "--single-device"]) == 0


def test_minibatch_buckets_and_accumulate(workdir, tmp_path):
    """--accumulate-batches streams the epoch but matches full-batch VB."""
    root = workdir
    full = tmp_path / "full"
    acc = tmp_path / "acc"
    assert cli([
        "hmm", "train", str(root / "init.mdl"), str(root / "feats.npz"),
        str(full), "--epochs", "3", "--single-device",
    ]) == 0
    assert cli([
        "hmm", "train", str(root / "init.mdl"), str(root / "feats.npz"),
        str(acc), "--epochs", "3", "--batch-size", "2", "--buckets", "2",
        "--accumulate-batches", "--single-device",
    ]) == 0
    from beer_tpu.utils import load_model
    import jax

    m_full = load_model(full / "final.mdl")
    m_acc = load_model(acc / "final.mdl")
    for a, b in zip(jax.tree.leaves(m_full), jax.tree.leaves(m_acc)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4,
                                   atol=1e-5)


def test_nan_guard_catches_corruption(workdir, tmp_path):
    """--nan-guard raises (with location info) on non-finite features."""
    root = workdir
    feats = dict(np.load(root / "feats.npz"))
    first = sorted(feats)[0]
    feats[first] = feats[first].copy()
    feats[first][0, 0] = np.nan
    bad = tmp_path / "bad.npz"
    np.savez(bad, **feats)
    import jax.experimental.checkify as checkify

    with pytest.raises(checkify.JaxRuntimeError, match="non-finite"):
        cli([
            "hmm", "train", str(root / "init.mdl"), str(bad),
            str(tmp_path / "guard"), "--epochs", "1", "--single-device",
            "--nan-guard",
        ])


def test_nan_guard_catches_corruption_data_parallel(workdir, tmp_path):
    """--nan-guard is live under dp too (output-side finite check —
    checkify cannot wrap shard_map collectives)."""
    root = workdir
    feats = dict(np.load(root / "feats.npz"))
    first = sorted(feats)[0]
    feats[first] = feats[first].copy()
    feats[first][0, 0] = np.nan
    bad = tmp_path / "bad.npz"
    np.savez(bad, **feats)

    with pytest.raises(FloatingPointError, match="non-finite"):
        cli([
            "hmm", "train", str(root / "init.mdl"), str(bad),
            str(tmp_path / "guard_dp"), "--epochs", "1", "--nan-guard",
        ])
    with pytest.raises(FloatingPointError, match="non-finite"):
        cli([
            "hmm", "train", str(root / "init.mdl"), str(bad),
            str(tmp_path / "guard_dp_mb"), "--epochs", "1", "--nan-guard",
            "--batch-size", "4",
        ])


def test_shmm_multilingual_cli(workdir, tmp_path):
    """H-SHMM path: --extra-lang switches to a HierarchicalGSM with one
    shared subspace + per-language embeddings, writes per-language loops."""
    root = workdir
    exp = tmp_path / "hshmm"
    assert cli([
        "shmm", "train", str(root / "exp" / "final.mdl"),
        str(root / "feats.npz"), str(exp),
        "--extra-lang", f"L2:{root / 'exp' / 'final.mdl'}:{root / 'feats.npz'}",
        "--embed-dim", "2", "--lang-dim", "2", "--learn-transitions",
        "--outer-iters", "2", "--inner-iters", "40", "--loop-epochs", "1",
    ]) == 0
    assert (exp / "final.mdl").exists()
    assert (exp / "final_L2.mdl").exists()
    from beer_tpu.models.gsm import HierarchicalGSM
    from beer_tpu.utils import load_model

    gsm = load_model(exp / "gsm.mdl")
    assert isinstance(gsm, HierarchicalGSM)
    assert gsm.n_units == 8 and gsm.n_langs == 2  # 4 units x 2 languages
    assert gsm.learn_transitions
    loop = load_model(exp / "final.mdl")
    assert loop.log_exit is not None  # transition write-back happened


def test_auto_streaming_when_monolith_too_big(workdir, tmp_path):
    """A tiny --max-padded-gb must flip the default path to streamed
    exact full-batch VB and still match the monolith result."""
    root = workdir
    full = tmp_path / "full"
    auto = tmp_path / "auto"
    assert cli([
        "hmm", "train", str(root / "init.mdl"), str(root / "feats.npz"),
        str(full), "--epochs", "3", "--single-device",
    ]) == 0
    assert cli([
        "hmm", "train", str(root / "init.mdl"), str(root / "feats.npz"),
        str(auto), "--epochs", "3", "--single-device",
        "--max-padded-gb", "1e-6",
    ]) == 0
    from beer_tpu.utils import load_model
    import jax

    m_full = load_model(full / "final.mdl")
    m_auto = load_model(auto / "final.mdl")
    for a, b in zip(jax.tree.leaves(m_full), jax.tree.leaves(m_auto)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4,
                                   atol=1e-5)
