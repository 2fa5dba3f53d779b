"""Feature frontend tests (SURVEY §7 step 5).

Oracles: numpy re-implementation of the classic fbank/MFCC pipeline
(no librosa dependency in the image; the pipeline is standard enough that
an independent numpy path is an adequate oracle), plus structural checks
(DCT orthogonality, mel filter coverage, jittability, delta filters).
"""

import numpy as np
import jax
import jax.numpy as jnp

from beer_tpu import features


def test_mel_filterbank_shape_and_coverage():
    fb = features.mel_filterbank(26, 512, 16000)
    assert fb.shape == (257, 26)
    assert (fb >= 0).all()
    # every filter has some support; interior bins covered by >= 1 filter
    assert (fb.sum(0) > 0).all()


def test_dct_orthogonal():
    m = features.dct_matrix(13, 26)
    np.testing.assert_allclose(m.T @ m, np.eye(13), atol=1e-10)


def test_framing():
    sig = jnp.arange(100.0)
    frames = features.frame_signal(sig, 25, 10)
    assert frames.shape == (8, 25)
    np.testing.assert_allclose(np.asarray(frames[1][:3]), [10.0, 11.0, 12.0])


def test_numpy_oracle_fbank(rng):
    """End-to-end fbank vs an independent numpy implementation."""
    sig = rng.normal(size=8000).astype(np.float32)
    conf = features.FeatureConfig(
        feature_type="fbank", deltas=False, mean_norm=False
    )
    ours = np.asarray(features.fbank(jnp.asarray(sig), conf))

    # independent numpy pipeline
    x = np.concatenate([sig[:1], sig[1:] - 0.97 * sig[:-1]])
    fl, fs = conf.frame_length, conf.frame_shift
    nfr = 1 + (len(x) - fl) // fs
    frames = np.stack([x[i * fs : i * fs + fl] for i in range(nfr)])
    win = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(fl) / (fl - 1))
    spec = np.abs(np.fft.rfft(frames * win, n=512, axis=-1)) ** 2
    mel = features.mel_filterbank(26, 512, 16000)
    oracle = np.log(np.maximum(spec @ mel, 1e-10))

    assert ours.shape == oracle.shape
    np.testing.assert_allclose(ours, oracle, rtol=1e-4, atol=1e-4)


def test_mfcc_shape_and_jit(rng):
    sig = jnp.asarray(rng.normal(size=16000).astype(np.float32))
    conf = features.FeatureConfig()
    fn = jax.jit(lambda s: features.extract(s, conf))
    out = fn(sig)
    assert out.shape[-1] == 13 * 3  # ceps + deltas + delta-deltas
    # mean-norm applied
    np.testing.assert_allclose(np.asarray(out).mean(0), 0.0, atol=1e-4)


def test_deltas_of_constant_are_zero():
    feats = jnp.ones((40, 5))
    out = features.add_deltas(feats)
    assert out.shape == (40, 15)
    np.testing.assert_allclose(np.asarray(out[:, 5:]), 0.0, atol=1e-7)


def _oracle_fbank(sig, conf):
    """Independent numpy fbank (same pipeline as test_numpy_oracle_fbank)."""
    x = np.concatenate([sig[:1], sig[1:] - 0.97 * sig[:-1]])
    fl, fs = conf.frame_length, conf.frame_shift
    nfr = 1 + (len(x) - fl) // fs
    frames = np.stack([x[i * fs: i * fs + fl] for i in range(nfr)])
    win = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(fl) / (fl - 1))
    spec = np.abs(np.fft.rfft(frames * win, n=512, axis=-1)) ** 2
    mel = features.mel_filterbank(26, 512, 16000)
    return np.log(np.maximum(spec @ mel, 1e-10))


def test_fbank_robust_to_degraded_waveforms(rng):
    """Frontend robustness on real-corpus pathologies:
    hard-clipped, DC-offset, and near-silent waveforms must stay
    finite and keep tracking the numpy oracle — the log-floor, the
    pre-emphasis and the windowing are where naive frontends blow up."""
    conf = features.FeatureConfig(
        feature_type="fbank", deltas=False, mean_norm=False
    )
    base = rng.normal(size=8000).astype(np.float32)
    cases = {
        "clipped": np.clip(3.0 * base, -1.0, 1.0).astype(np.float32),
        "dc_offset": (base + 0.5).astype(np.float32),
        "quiet": (1e-5 * base).astype(np.float32),
        "silence": np.zeros(8000, np.float32),
    }
    for name, sig in cases.items():
        ours = np.asarray(features.fbank(jnp.asarray(sig), conf))
        assert np.isfinite(ours).all(), f"{name}: non-finite fbank"
        oracle = _oracle_fbank(sig, conf)
        np.testing.assert_allclose(
            ours, oracle, rtol=1e-3, atol=1e-3,
            err_msg=f"fbank diverges from oracle on {name} waveform",
        )
    # mean-norm + deltas must also survive silence (zero variance)
    full = features.FeatureConfig(feature_type="fbank")
    out = np.asarray(features.extract(jnp.asarray(cases["silence"]), full))
    assert np.isfinite(out).all(), "extract blows up on silence"


def test_config_from_yaml_dict():
    conf = features.FeatureConfig.from_dict(
        {"srate": 8000, "n_filters": 20, "feature_type": "fbank", "junk": 1}
    )
    assert conf.srate == 8000 and conf.n_filters == 20
    assert conf.frame_length == 200
