"""Shared adversarial synthetic-speech generator for the AUD recipes.

Reference context: the SHMM (Interspeech'19) / H-SHMM (ICASSP'21) papers
evaluate acoustic unit discovery on real low-resource speech; with no
network access the recipes use this generator instead, built to be
*adversarial* rather than a toy tone grid:

* a latent inventory of pseudo-phones, each a 3-sub-state formant
  *trajectory* (onset → steady → offset toward a neutral schwa) — real
  sub-phone dynamics for 3-state unit HMMs;
* TWO allophone modes per phone (formant offsets chosen per occurrence)
  → bimodal, non-Gaussian per-unit emission distributions;
* gamma-distributed sub-state durations → variable unit lengths;
* per-utterance SPEAKER factors: vocal-tract formant scaling, gain, and
  additive noise at a random level → train/eval mismatch;
* optional per-language affine "vocal tract" factors and language
  unigram phonotactics (the multilingual H-SHMM setting);
* HELD-OUT eval splits — scores must come from utterances never touched
  by training.

Every recipe's ``local/make_*_data.py`` is a thin wrapper over
:func:`make_inventory` + :func:`make_split`.
"""

from pathlib import Path

import numpy as np

SRATE = 16000
FRAME_SHIFT = 160  # 10 ms
SCHWA = np.array([500.0, 1500.0])


def make_inventory(rng, n_phones):
    """Latent inventory: steady formants + per-phone allophone offsets."""
    f1 = rng.uniform(280, 850, size=n_phones)
    f2 = rng.uniform(900, 2600, size=n_phones)
    steady = np.stack([f1, f2], axis=1)                   # (P, 2)
    allo = rng.uniform(30, 90, size=(n_phones, 2)) * np.where(
        rng.random((n_phones, 2)) < 0.5, 1.0, -1.0
    )
    return steady, allo


def phone_trajectory(steady_point):
    """(onset, steady, offset) formant targets for one phone."""
    onset = 0.5 * steady_point + 0.5 * SCHWA
    offset = 0.65 * steady_point + 0.35 * SCHWA
    return [onset, steady_point, offset]


def synth_segment(rng, targets, durs, spk_scale, gain, noise_std):
    """Render one phone: per-sub-state sinusoid mixtures + noise."""
    chunks = []
    for (f1, f2), dur in zip(targets, durs):
        n = dur * FRAME_SHIFT
        t = np.arange(n) / SRATE
        jit = 1.0 + 0.015 * rng.normal()
        f1s, f2s = f1 * spk_scale * jit, f2 * spk_scale * jit
        sig = 0.6 * np.sin(2 * np.pi * f1s * t) + 0.4 * np.sin(
            2 * np.pi * f2s * t
        )
        chunks.append(sig)
    sig = np.concatenate(chunks)
    n = len(sig)
    env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n)) / 240.0)
    return (gain * sig * env + noise_std * rng.normal(size=n)).astype(
        np.float32
    )


def gamma_dur(rng, mean_frames, lo=2, hi=24):
    d = int(np.round(rng.gamma(shape=2.0, scale=mean_frames / 2.0)))
    return int(np.clip(d, lo, hi))


def _babble(rng, n, n_talkers=6):
    """Speech-shaped interference: sinusoid talkers whose formants do a
    slow random walk (≈ real babble's spectral occupancy, unlike white
    noise which the fbank frontend trivially averages out)."""
    t = np.arange(n) / SRATE
    total = np.zeros(n)
    n_ctrl = max(2, n // (SRATE // 5))          # ~5 control points / s
    for _ in range(n_talkers):
        f0 = rng.uniform(250, 900)
        ctrl = np.clip(
            f0 + np.cumsum(rng.normal(0, 60, size=n_ctrl)), 150, 2800
        )
        freq = np.interp(np.arange(n), np.linspace(0, n - 1, n_ctrl), ctrl)
        phase = 2 * np.pi * np.cumsum(freq) / SRATE
        amp = 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * rng.uniform(1, 4) * t
                                        + rng.uniform(0, 2 * np.pi)))
        total += amp * np.sin(phase)
    return total / n_talkers


def harden_utterance(rng, sig):
    """Real-corpus channel/noise degradations:

    * room IR convolution — exponential-decay reverb, τ ∈ [5, 30] ms
      (truncated to signal length so frame labels stay aligned);
    * babble at an SNR drawn from a 0–15 dB sweep;
    * random DC offset (±5% full scale);
    * 30% of utterances amplitude-clipped at 70% of their peak.
    """
    n = len(sig)
    # room IR
    tau = rng.uniform(0.005, 0.030) * SRATE
    ir_len = int(0.040 * SRATE)
    ir = rng.normal(size=ir_len) * np.exp(-np.arange(ir_len) / tau)
    ir[0] = 1.0                                   # direct path dominates
    ir /= np.sqrt((ir**2).sum())
    sig = np.convolve(sig, ir)[:n]
    # babble at SNR ∈ [0, 15] dB
    snr_db = rng.uniform(0.0, 15.0)
    noise = _babble(rng, n)
    sig_rms = np.sqrt((sig**2).mean()) + 1e-12
    noise_rms = np.sqrt((noise**2).mean()) + 1e-12
    sig = sig + noise * (sig_rms / noise_rms) * 10 ** (-snr_db / 20.0)
    # DC offset
    sig = sig + rng.uniform(-0.05, 0.05) * max(1.0, np.abs(sig).max())
    # occasional clipping
    if rng.random() < 0.3:
        lim = 0.7 * np.abs(sig).max()
        sig = np.clip(sig, -lim, lim)
    return sig.astype(np.float32)


def make_split(
    rng,
    name,
    steady,
    allo,
    unigram,
    out_dir,
    n_utts,
    tag="",
    formant_shift=(0.0, 0.0),
    formant_scale=1.0,
    audio_subdir=None,
    return_transcripts=False,
    hard=False,
):
    """Write one corpus split: audio .npy + scp + per-frame ref ali.

    ``tag`` (e.g. ``"_eval"``) suffixes utterance ids and output files;
    ``formant_shift``/``formant_scale`` are the per-language vocal-tract
    factors of the multilingual setting.  Returns the phone-sequence
    transcripts when ``return_transcripts`` (the supervised recipe's
    labels).  ``hard`` applies real-corpus degradations on top
    (:func:`harden_utterance`) and draws utterance lengths from a
    heavy-tailed lognormal matched to real AUD corpora (a few seconds,
    occasional long utterances) instead of the 5–10-phone uniform.
    """
    out_dir = Path(out_dir)
    shift = np.asarray(formant_shift, float)
    audio_dir = out_dir / (audio_subdir or f"audio_{name}")
    audio_dir.mkdir(parents=True, exist_ok=True)
    scp_lines, ref_lines, transcripts = [], [], []
    n_phones = len(steady)
    for i in range(n_utts):
        spk_scale = rng.uniform(0.88, 1.12)
        gain = rng.uniform(0.6, 1.1)
        noise_std = rng.uniform(0.05, 0.18)
        if hard:
            n_seg = int(np.clip(rng.lognormal(np.log(10.0), 0.6), 3, 40))
        else:
            n_seg = int(rng.integers(5, 11))
        seq = rng.choice(n_phones, size=n_seg, p=unigram)
        segs, labels = [], []
        for ph in seq:
            base = (steady[ph] + shift) * formant_scale
            mode = 1.0 if rng.random() < 0.5 else -1.0
            point = base + mode * allo[ph] * formant_scale
            targets = phone_trajectory(point)
            durs = [gamma_dur(rng, m) for m in (3.0, 6.0, 3.0)]
            segs.append(
                synth_segment(rng, targets, durs, spk_scale, gain, noise_std)
            )
            labels += [int(ph)] * sum(durs)
        sig = np.concatenate(segs)
        if hard:
            sig = harden_utterance(rng, sig)
        utt = f"{name}{tag}_utt{i:04d}"
        path = audio_dir / f"{utt}.npy"
        np.save(path, sig)
        scp_lines.append(f"{utt} {path.resolve()}")
        ref_lines.append(f"{utt} {' '.join(f'p{l}' for l in labels)}")
        transcripts.append((utt, [int(p) for p in seq]))
    suffix = f"_{tag.lstrip('_')}" if tag else ""
    (out_dir / f"wav_{name}{suffix}.scp").write_text(
        "\n".join(scp_lines) + "\n")
    (out_dir / f"ref_{name}{suffix}.ali").write_text(
        "\n".join(ref_lines) + "\n")
    if return_transcripts:
        return transcripts
