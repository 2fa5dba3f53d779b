"""The GPU scan kernels (``ops/triton_scan.py``) in Pallas interpret mode
against the plain ``lax.scan`` route, the plain route against a float64
log-domain reference, the wrapper's geometry and route choice, and the
model-level routes.  The compiled kernels run on the card in
``chip_smoke.py`` phase d (and in the ``chip``-marked test below)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import beer_tpu
from beer_tpu.ops import semiring_scan, triton_scan

SHAPES = [3, 30, 150, 160]
CASES = ["ragged", "zero_length", "extreme"]


def _inputs(s, case, b=5, t=9, seed=0):
    """float32 scan inputs: e_llh, row-stochastic trans, init, final, mask."""
    rng = np.random.default_rng(seed + s)
    llh = rng.normal(size=(b, t, s))
    if case == "extreme":
        # per-frame spreads of ~1e3 nats: most states underflow after the
        # max shift, a few frames are flat
        llh = llh * 300.0
        llh[:, ::3] = -5000.0
    e = np.exp(llh - llh.max(-1, keepdims=True))
    trans = rng.uniform(size=(s, s)) * (rng.uniform(size=(s, s)) < 0.5)
    trans[np.arange(s), np.arange(s)] += 0.1
    trans /= trans.sum(1, keepdims=True)
    init = rng.uniform(size=(b, s))
    final = rng.uniform(size=(b, s))
    lengths = rng.integers(1, t + 1, size=b)
    lengths[0] = t
    if case == "zero_length":
        lengths[1] = 0
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    e = e * mask[..., None] + (1 - mask[..., None])
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    return f32(e), f32(trans), f32(init), f32(final), f32(mask), llh


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("s", SHAPES)
def test_forward_kernel_matches_scan(s, case):
    e, trans, init, _, mask, _ = _inputs(s, case)
    probs, logcs = triton_scan.forward_pass(e, trans, init, mask)
    ref_p, ref_l, _ = semiring_scan._scaled_pass(e, trans, init, mask, False)
    np.testing.assert_allclose(probs, ref_p, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(logcs, ref_l, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("s", SHAPES)
def test_smoothing_kernel_matches_scan(s, case):
    e, trans, init, final, mask, _ = _inputs(s, case)
    alpha, _, _ = semiring_scan._scaled_pass(e, trans, init, mask, False)
    got = triton_scan.smoothing_pass(e, trans, final, mask, alpha)
    ref = semiring_scan._smoothing_scan(e, trans, final, mask, alpha)
    for name, a, r in zip(("gamma", "w", "wsum", "pnorm"), got, ref):
        np.testing.assert_allclose(a, r, rtol=1e-5, atol=1e-6, err_msg=name)


def _fbp(llh, trans, init, final, mask, kernel, monkeypatch):
    monkeypatch.setattr(triton_scan, "use_kernel", lambda t, d: kernel)
    return semiring_scan.forward_backward_probs(
        llh, jnp.log(trans), jnp.log(init[0]), jnp.log(final[0]), mask)


@pytest.mark.parametrize("s", SHAPES)
def test_logz_gradient_through_kernel_route(s, monkeypatch):
    """∂Σ log Z/∂llh through the custom_vjp (kernel forward, scan VJP)
    equals the plain route's gradient — the SVAE encoder's path."""
    _, trans, init, final, mask, llh = _inputs(s, "ragged")
    llh = jnp.asarray(llh, jnp.float32)

    def total(kernel):
        def f(x):
            return _fbp(x, trans, init, final, mask, kernel,
                        monkeypatch).log_z.sum()
        return jax.value_and_grad(f)(llh)

    (z_k, g_k), (z_p, g_p) = total(True), total(False)
    np.testing.assert_allclose(z_k, z_p, rtol=1e-6)
    np.testing.assert_allclose(g_k, g_p, rtol=1e-4, atol=1e-6)


# ----------------------------------------------------------------------
# the plain route against a float64 log-domain reference
# ----------------------------------------------------------------------
def _log_domain(llh, trans, init, final, mask):
    """Brute log-domain forward/backward in numpy float64."""
    from scipy.special import logsumexp

    with np.errstate(divide="ignore"):       # log 0 = -inf: forbidden arcs
        lt, li, lf = np.log(trans), np.log(init), np.log(final)
    b, t_len, s = llh.shape
    log_z = np.zeros(b)
    post = np.zeros((b, t_len, s))
    for i in range(b):
        n = int(mask[i].sum())
        if n == 0:
            continue
        a = np.zeros((n, s))
        a[0] = li + llh[i, 0]
        for t in range(1, n):
            a[t] = logsumexp(a[t - 1][:, None] + lt, axis=0) + llh[i, t]
        bb = np.zeros((n, s))
        bb[-1] = lf
        for t in range(n - 2, -1, -1):
            bb[t] = logsumexp(lt + (llh[i, t + 1] + bb[t + 1])[None], axis=1)
        log_z[i] = logsumexp(a[-1] + lf)
        post[i, :n] = np.exp(a + bb - logsumexp(a + bb, axis=1)[:, None])
    return log_z, post


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("s", SHAPES)
def test_plain_scan_matches_log_domain_float64(s, case):
    _, trans, init, final, mask, llh = _inputs(s, case)
    trans, init, final, mask = (np.asarray(a, np.float64)
                                for a in (trans, init, final, mask))
    init, final = init[0], final[0]
    fb = semiring_scan.forward_backward_probs(
        jnp.asarray(llh), jnp.log(trans), jnp.log(init), jnp.log(final),
        jnp.asarray(mask))
    ref_z, ref_post = _log_domain(llh, trans, init, final, mask)
    valid = mask.sum(1) > 0
    np.testing.assert_allclose(np.asarray(fb.log_z)[valid], ref_z[valid],
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(fb.posteriors), ref_post,
                               atol=1e-10)


# ----------------------------------------------------------------------
# wrapper geometry and route choice
# ----------------------------------------------------------------------
@pytest.mark.parametrize("s,expected", [
    (1, (16, 1)), (3, (16, 1)), (16, (16, 1)), (30, (32, 1)),
    (64, (64, 1)), (65, (64, 2)), (150, (64, 3)), (160, (64, 3)),
    (257, (64, 5)),
])
def test_state_chunking(s, expected):
    assert triton_scan.chunking(s) == expected


@pytest.mark.parametrize("b", [1, 7, 8, 13])
def test_batch_padding_to_tile(b):
    """Batches that are not a multiple of the tile pad with rows the
    outputs drop."""
    e, trans, init, final, mask, _ = _inputs(30, "ragged", b=b)
    probs, logcs = triton_scan.forward_pass(e, trans, init, mask)
    assert probs.shape == e.shape and logcs.shape == mask.shape
    ref_p, _, _ = semiring_scan._scaled_pass(e, trans, init, mask, False)
    np.testing.assert_allclose(probs, ref_p, rtol=1e-5, atol=1e-6)
    _, _, _, bb, _, _, b_pad, _ = triton_scan._geometry(e)
    assert bb == triton_scan.BATCH_TILE and (b + b_pad) % bb == 0


@pytest.mark.parametrize("backend,ndim,dtype,expected", [
    ("gpu", 2, jnp.float32, True),
    ("gpu", 3, jnp.float32, False),     # per-utterance graphs
    ("gpu", 2, jnp.float64, False),
    ("cpu", 2, jnp.float32, False),
])
def test_route_choice(backend, ndim, dtype, expected, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    trans = jnp.zeros((4,) * ndim)
    assert triton_scan.use_kernel(trans, dtype) is expected


@pytest.mark.chip
def test_compiled_kernels_match_scan_at_bench_width():
    """On a GPU: the compiled pair at the phone-loop width."""
    e, trans, init, final, mask, _ = _inputs(150, "ragged", b=64, t=200)
    probs, logcs = jax.jit(triton_scan.forward_pass)(e, trans, init, mask)
    ref_p, ref_l, _ = jax.jit(
        lambda *a: semiring_scan._scaled_pass(*a, False))(e, trans, init, mask)
    np.testing.assert_allclose(probs, ref_p, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(logcs, ref_l, rtol=1e-5, atol=1e-3)


# ----------------------------------------------------------------------
# model-level routes (the kernel forced through the dispatch predicate)
# ----------------------------------------------------------------------
def _force(monkeypatch, kernel):
    real = triton_scan.use_kernel
    monkeypatch.setattr(
        triton_scan, "use_kernel",
        (lambda t, d: t.ndim == 2 and jnp.dtype(d) == jnp.float32)
        if kernel else real)


def _both_routes(monkeypatch, fn):
    out = {}
    for kernel in (False, True):
        _force(monkeypatch, kernel)
        out[kernel] = fn()
    return out[True], out[False]


def _assert_trees_close(a, b, rtol=1e-4, atol=1e-4):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=rtol, atol=atol)


def _data(rng, b=6, t=15, d=3):
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    lengths = rng.integers(t // 2, t + 1, size=b)
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    return jnp.asarray(x), jnp.asarray(mask)


def _diag_set(size, d=3, seed=1):
    return beer_tpu.NormalSet.create(
        jnp.zeros(d, jnp.float32), jnp.ones(d, jnp.float32), size=size,
        cov_type="diagonal", noise_std=0.7, key=jax.random.PRNGKey(seed))


def _vb_steps(model, x, mask, n=3):
    from beer_tpu.vbi import vb_step

    elbos = []
    for _ in range(n):
        elbo, model = vb_step(model, x, mask=mask)
        elbos.append(float(elbo))
    return elbos, model


def test_phone_loop_kernel_route_matches_scan(rng, monkeypatch):
    from beer_tpu.models.phoneloop import PhoneLoop

    x, mask = _data(rng)
    loop = PhoneLoop.create(4, 3, _diag_set(12))
    (e_k, m_k), (e_p, m_p) = _both_routes(
        monkeypatch, lambda: _vb_steps(loop, x, mask))
    np.testing.assert_allclose(e_k, e_p, rtol=1e-5)
    _assert_trees_close(m_k, m_p)


def test_hmm_kernel_route_matches_scan(rng, monkeypatch):
    from beer_tpu.models.graph import ergodic
    from beer_tpu.models.hmm import HMM

    x, mask = _data(rng)
    hmm = HMM.create(ergodic(5), _diag_set(5), learn_transitions=True)
    (e_k, m_k), (e_p, m_p) = _both_routes(
        monkeypatch, lambda: _vb_steps(hmm, x, mask))
    np.testing.assert_allclose(e_k, e_p, rtol=1e-5)
    _assert_trees_close(m_k, m_p)


def test_recognizer_routes(rng, monkeypatch):
    """Shared-graph transcriptions (one (S, S) matrix, per-utterance
    pdf maps) take the kernel; per-utterance (B, S, S) graphs keep the
    scan — both routes agree either way."""
    from beer_tpu.models.graph import transcription_graphs
    from beer_tpu.models.hmm import HMM

    x, mask = _data(rng)
    seqs = [list(rng.integers(3, size=2)) for _ in range(x.shape[0])]
    for shared in (True, False):
        graphs = transcription_graphs(seqs, 3, 2, shared=shared)
        assert (graphs.log_trans.ndim == 2) == shared
        hmm = HMM.create(graphs, _diag_set(6))
        (e_k, m_k), (e_p, m_p) = _both_routes(
            monkeypatch, lambda: _vb_steps(hmm, x, mask))
        np.testing.assert_allclose(e_k, e_p, rtol=1e-5)
        _assert_trees_close(m_k, m_p)


def test_svae_gradient_kernel_route_matches_scan(rng, monkeypatch):
    """The sequence VAE differentiates log Z through the kernel's
    custom_vjp: ELBO and encoder/decoder gradients match the scan."""
    from beer_tpu.models.phoneloop import PhoneLoop
    from beer_tpu.models.vae import SequenceVAE

    x, mask = _data(rng, d=4)
    loop = PhoneLoop.create(2, 2, _diag_set(4, d=2))
    svae = SequenceVAE.create(obs_dim=4, latent_dim=2, latent_model=loop,
                              hidden=(8,), key=jax.random.PRNGKey(3))

    def value_and_grad():
        def loss(params):
            elbo, _ = svae.replace(nnet_params=params).elbo_and_stats(
                x, jax.random.PRNGKey(0), mask=mask)
            return elbo
        return jax.value_and_grad(loss)(svae.nnet_params)

    (v_k, g_k), (v_p, g_p) = _both_routes(monkeypatch, value_and_grad)
    np.testing.assert_allclose(v_k, v_p, rtol=1e-5)
    _assert_trees_close(g_k, g_p, rtol=1e-3, atol=1e-4)
