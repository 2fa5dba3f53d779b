"""GSM / subspace-HMM tests (SURVEY §3.5).

Synthetic setting: unit emission parameters generated from a true 2-D
affine subspace; accumulated per-unit statistics fed to the GSM; the
reparameterization training must raise the ELBO and recover unit means.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax

from beer_tpu.models.gsm import GSM, HierarchicalGSM, make_gsm_train_step


def make_unit_stats(rng, n_units=10, d=4, frames_per_unit=200):
    """True params from a planted subspace; stats in [−½Σx², Σx, −½c, ½c]."""
    w_true = rng.normal(size=(2, d))
    b_true = rng.normal(size=d)
    e_true = rng.normal(size=(n_units, 2))
    mus = e_true @ w_true + b_true
    lams = np.exp(0.3 * rng.normal(size=(n_units, d)))
    stats = np.zeros((n_units, 4 * d))
    counts = np.full(n_units, float(frames_per_unit))
    for u in range(n_units):
        x = mus[u] + rng.normal(size=(frames_per_unit, d)) / np.sqrt(lams[u])
        stats[u] = np.concatenate([
            -0.5 * (x**2).sum(0), x.sum(0),
            np.full(d, -0.5 * frames_per_unit), np.full(d, 0.5 * frames_per_unit),
        ])
    return stats.astype(np.float32), counts.astype(np.float32), mus, lams


def _train(gsm, stats, counts, iters=800, lr=5e-2):
    tx = optax.adam(lr)
    opt_state = tx.init(gsm)
    step = make_gsm_train_step(tx)
    key = jax.random.PRNGKey(0)
    elbos = []
    for _ in range(iters):
        key, sub = jax.random.split(key)
        elbo, gsm, opt_state = step(
            gsm, opt_state, jnp.asarray(stats), jnp.asarray(counts), sub
        )
        elbos.append(float(elbo))
    return gsm, elbos


def test_gsm_learns_units(rng):
    stats, counts, mus, lams = make_unit_stats(rng)
    gsm = GSM.create(n_units=10, embed_dim=2, obs_dim=4, key=jax.random.PRNGKey(1))
    gsm, elbos = _train(gsm, stats, counts)
    assert np.isfinite(elbos).all()
    assert np.mean(elbos[-50:]) > np.mean(elbos[:50]) + 100.0
    mu_est, lam_est = map(np.asarray, gsm.emission_expectations())
    mu_est, lam_est = mu_est[:, 0], lam_est[:, 0]  # P_states = 1
    np.testing.assert_allclose(mu_est, mus, atol=0.25)
    # precisions in the right ballpark (log-scale agreement)
    np.testing.assert_allclose(np.log(lam_est), np.log(lams), atol=0.6)


def test_hierarchical_gsm_runs(rng):
    stats, counts, _, _ = make_unit_stats(rng, n_units=6)
    gsm = HierarchicalGSM.create(
        n_units=6, embed_dim=2, obs_dim=4, lang_dim=2, key=jax.random.PRNGKey(2)
    )
    gsm, elbos = _train(gsm, stats, counts, iters=200)
    assert np.isfinite(elbos).all()
    assert np.mean(elbos[-20:]) > np.mean(elbos[:20])


def test_hierarchical_gsm_multilingual(rng):
    """Two languages sharing a subspace: a per-language mean offset must be
    absorbed by the language embeddings (H-SHMM's core mechanism)."""
    n_units, d = 8, 4
    stats, counts, mus, _ = make_unit_stats(rng, n_units=n_units, d=d)
    # units 0..3 = language A, 4..7 = language B with a constant shift
    shift = np.array([3.0, -3.0, 2.0, -2.0], np.float32)
    stats = stats.copy()
    for u in range(4, 8):
        # shift the accumulated first moments: sum_x' = sum_x + c*shift
        c = counts[u]
        sx = stats[u, d:2*d] + c * shift
        sq = stats[u, :d] - c * (shift * (stats[u, d:2*d] / c) + 0.5 * shift**2)
        stats[u, :d], stats[u, d:2*d] = sq, sx
    unit_lang = np.array([0]*4 + [1]*4)
    gsm = HierarchicalGSM.create(
        n_units=n_units, embed_dim=2, obs_dim=d, lang_dim=2, n_langs=2,
        unit_lang=unit_lang, key=jax.random.PRNGKey(3),
    )
    gsm, elbos = _train(gsm, stats, counts, iters=600)
    assert np.isfinite(elbos).all()
    assert np.mean(elbos[-20:]) > np.mean(elbos[:20])
    # the two language embeddings must have separated
    lang = np.asarray(gsm.lang_mean)
    assert np.linalg.norm(lang[0] - lang[1]) > 0.5


def test_kl_zero_at_prior():
    gsm = GSM.create(3, 2, 2)
    gsm = gsm.replace(
        e_mean=jnp.zeros_like(gsm.e_mean), e_logvar=jnp.zeros_like(gsm.e_logvar),
        w_mean=jnp.zeros_like(gsm.w_mean), w_logvar=jnp.zeros_like(gsm.w_logvar),
    )
    np.testing.assert_allclose(float(gsm.kl_div_posterior_prior()), 0.0, atol=1e-6)


def test_shmm_bridge_roundtrip(rng):
    """Phone-loop -> unit stats -> GSM -> inject back -> loop still works."""
    import beer_tpu
    from beer_tpu.models.phoneloop import PhoneLoop
    from beer_tpu.models.gsm import accumulate_unit_stats, apply_to_phoneloop
    from beer_tpu.vbi import vb_step

    d, n_units, spp = 3, 4, 2
    centers = rng.normal(size=(n_units, d)) * 3.0
    data = np.zeros((8, 40, d)); mask = np.ones((8, 40))
    for i in range(8):
        t = 0
        while t < 40:
            ph = int(rng.integers(n_units)); dwell = min(int(rng.integers(4, 9)), 40 - t)
            data[i, t:t+dwell] = centers[ph] + 0.4 * rng.normal(size=(dwell, d))
            t += dwell
    flat = data.reshape(-1, d)
    nset = beer_tpu.NormalSet.create(
        jnp.asarray(flat.mean(0)), jnp.asarray(np.diag(flat.var(0))),
        size=n_units * spp, cov_type="diagonal", noise_std=1.0,
        key=jax.random.PRNGKey(0),
    )
    loop = PhoneLoop.create(n_units, spp, nset, dtype=jnp.float64)
    x, m = jnp.asarray(data), jnp.asarray(mask)
    for _ in range(10):
        _, loop = jax.jit(vb_step)(loop, x, mask=m)

    stats, counts = accumulate_unit_stats(loop, x, m)
    assert stats.shape == (n_units, spp, 4 * d)
    np.testing.assert_allclose(float(counts.sum()), float(m.sum()), rtol=1e-6)

    gsm = GSM.create(n_units, 2, d, states_per_unit=spp,
                     key=jax.random.PRNGKey(1), dtype=jnp.float64)
    gsm, elbos = _train(gsm, np.asarray(stats), np.asarray(counts), iters=400)
    assert np.mean(elbos[-20:]) > np.mean(elbos[:20])

    loop2 = apply_to_phoneloop(gsm, loop)
    elbo, _ = jax.jit(vb_step)(loop2, x, mask=m)
    assert np.isfinite(float(elbo))
    # subspace emissions should be close to the loop's learned means
    mu_gsm, _ = loop2.modelset.means_precisions.family.to_std(
        loop2.modelset.means_precisions.posterior
    )[:2]
    mu_loop = loop.modelset.means()
    err = np.abs(np.asarray(mu_gsm) - np.asarray(mu_loop))
    # only compare states with meaningful occupancy
    occ = np.asarray(counts).reshape(-1)
    assert np.median(err[occ > 20]) < 0.5


# ----------------------------------------------------------------------
# Generalized subspace: moment-matched write-back, transitions, weights,
# nnet trunk
# ----------------------------------------------------------------------
def _fit_loop(rng, d=3, n_units=4, spp=2, mixture=False, iters=10):
    import beer_tpu
    from beer_tpu.models.phoneloop import PhoneLoop
    from beer_tpu.models.mixture import MixtureSet
    from beer_tpu.vbi import vb_step

    centers = rng.normal(size=(n_units, d)) * 3.0
    data = np.zeros((8, 40, d)); mask = np.ones((8, 40))
    for i in range(8):
        t = 0
        while t < 40:
            ph = int(rng.integers(n_units)); dwell = min(int(rng.integers(4, 9)), 40 - t)
            data[i, t:t+dwell] = centers[ph] + 0.4 * rng.normal(size=(dwell, d))
            t += dwell
    flat = data.reshape(-1, d)
    k = 2 if mixture else 1
    nset = beer_tpu.NormalSet.create(
        jnp.asarray(flat.mean(0)), jnp.asarray(np.diag(flat.var(0))),
        size=n_units * spp * k, cov_type="diagonal", noise_std=1.0,
        key=jax.random.PRNGKey(0),
    )
    emissions = MixtureSet.create(nset, n_units * spp) if mixture else nset
    loop = PhoneLoop.create(n_units, spp, emissions)
    x, m = jnp.asarray(data, jnp.float32), jnp.asarray(mask, jnp.float32)
    for _ in range(iters):
        _, loop = jax.jit(vb_step)(loop, x, mask=m)
    return loop, x, m


def test_moment_matched_writeback(rng):
    """Write-back must reproduce the induced E[T(θ)] moments exactly
    (the E-step sees the subspace posterior, not a point mass)."""
    from beer_tpu.models.gsm import (
        GSM, apply_to_phoneloop, induced_posterior_moments)
    from beer_tpu.vbi import vb_step

    loop, x, m = _fit_loop(rng)
    gsm = GSM.create(4, 2, 3, states_per_unit=2, key=jax.random.PRNGKey(1))
    # non-trivial posterior spread
    gsm = gsm.replace(e_logvar=jnp.full_like(gsm.e_logvar, -1.5),
                      w_logvar=jnp.full_like(gsm.w_logvar, -3.0))
    key = jax.random.PRNGKey(7)
    mom = induced_posterior_moments(gsm, key, nsamples=512)
    loop2 = apply_to_phoneloop(gsm, loop, key=key, nsamples=512)
    et = np.asarray(
        loop2.modelset.means_precisions.expected_sufficient_statistics()
    )  # (S, 4D): [E[λ], E[λμ], E[λμ²], E[log λ]]
    d = 3
    np.testing.assert_allclose(et[:, :d], np.asarray(mom["e_lam"]).reshape(-1, d), rtol=2e-3)
    np.testing.assert_allclose(et[:, d:2*d], np.asarray(mom["e_lam_mu"]).reshape(-1, d), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(et[:, 2*d:3*d], np.asarray(mom["e_lam_mu2"]).reshape(-1, d), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(et[:, 3*d:], np.asarray(mom["e_log_lam"]).reshape(-1, d), rtol=2e-3, atol=2e-3)
    elbo, _ = jax.jit(vb_step)(loop2, x, mask=m)
    assert np.isfinite(float(elbo))


def test_gsm_transition_subspace(rng):
    """learn_transitions: counts are conserved, ELBO climbs, write-back
    sets per-state self-loops + per-unit exits and the loop still runs."""
    from beer_tpu.models.gsm import (
        GSM, accumulate_unit_stats, apply_to_phoneloop, make_gsm_train_step)
    from beer_tpu.vbi import vb_step

    loop, x, m = _fit_loop(rng)
    stats, counts = accumulate_unit_stats(loop, x, m, transitions=True)
    # every valid frame's transition slot is allocated once
    total = float(stats["self"].sum() + stats["adv"].sum())
    np.testing.assert_allclose(total, float(m.sum()), rtol=1e-4)

    gsm = GSM.create(4, 2, 3, states_per_unit=2, learn_transitions=True,
                     key=jax.random.PRNGKey(2))
    tx = optax.adam(5e-2)
    opt_state = tx.init(gsm)
    step = make_gsm_train_step(tx)
    key = jax.random.PRNGKey(0)
    elbos = []
    for _ in range(400):
        key, sub = jax.random.split(key)
        elbo, gsm, opt_state = step(gsm, opt_state, stats, counts, sub)
        elbos.append(float(elbo))
    assert np.isfinite(elbos).all()
    assert np.mean(elbos[-20:]) > np.mean(elbos[:20])

    loop2 = apply_to_phoneloop(gsm, loop, key=key)
    assert loop2.log_exit is not None and loop2.log_exit.shape == (4,)
    diag = np.diagonal(np.asarray(loop2.base_log_trans))
    assert (diag < 0).all()  # valid log self-loop probs
    elbo, _ = jax.jit(vb_step)(loop2, x, mask=m)
    assert np.isfinite(float(elbo))


def test_gsm_mixture_weights_head(rng):
    """n_comp>1: subspace generates per-state GMMs incl. weights; the
    Dirichlet write-back matches E[log w] and the loop still trains."""
    from beer_tpu.models.gsm import (
        GSM, accumulate_unit_stats, apply_to_phoneloop, make_gsm_train_step)
    from beer_tpu.vbi import vb_step
    from jax.scipy.special import digamma as _dg

    loop, x, m = _fit_loop(rng, mixture=True)
    stats, counts = accumulate_unit_stats(loop, x, m)
    assert stats["emission"].shape == (4, 2, 2, 12)
    assert stats["comp_counts"].shape == (4, 2, 2)

    gsm = GSM.create(4, 2, 3, states_per_unit=2, n_comp=2,
                     key=jax.random.PRNGKey(3))
    tx = optax.adam(5e-2)
    opt_state = tx.init(gsm)
    step = make_gsm_train_step(tx)
    key = jax.random.PRNGKey(0)
    elbos = []
    for _ in range(300):
        key, sub = jax.random.split(key)
        elbo, gsm, opt_state = step(gsm, opt_state, stats, counts, sub)
        elbos.append(float(elbo))
    assert np.isfinite(elbos).all()
    assert np.mean(elbos[-20:]) > np.mean(elbos[:20])

    from beer_tpu.models.gsm import induced_posterior_moments
    key2 = jax.random.PRNGKey(9)
    mom = induced_posterior_moments(gsm, key2, nsamples=256)
    loop2 = apply_to_phoneloop(gsm, loop, key=key2, nsamples=256)
    # Dirichlet moment match: E[log w] of the written-back weights
    alpha_nat = loop2.modelset.weights.posterior
    alpha = np.asarray(alpha_nat) + 1.0  # Dirichlet nat = alpha - 1
    elw = _dg(alpha) - _dg(alpha.sum(-1, keepdims=True))
    np.testing.assert_allclose(
        np.asarray(elw), np.asarray(mom["e_log_w"]).reshape(8, 2), atol=5e-3
    )
    elbo, _ = jax.jit(vb_step)(loop2, x, mask=m)
    assert np.isfinite(float(elbo))


def test_gsm_nnet_trunk(rng):
    """Optional nnet transform (MLP trunk before the variational affine)."""
    from beer_tpu.models.gsm import GSM

    stats, counts, _, _ = make_unit_stats(rng, n_units=6)
    gsm = GSM.create(6, 2, 4, trunk="mlp:16:tanh", key=jax.random.PRNGKey(4))
    assert gsm.trunk_def is not None
    gsm, elbos = _train(gsm, stats, counts, iters=300)
    assert np.isfinite(elbos).all()
    assert np.mean(elbos[-20:]) > np.mean(elbos[:20])


def test_expected_llh_array_form_requires_counts(rng):
    """Array-form unit_stats without unit_counts must raise, not crash
    with an AttributeError."""
    import pytest

    stats, counts, _, _ = make_unit_stats(rng, n_units=3, d=4, frames_per_unit=10)
    gsm = GSM.create(n_units=3, embed_dim=2, obs_dim=4, key=jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="unit_counts"):
        gsm.expected_llh_of_stats(jnp.asarray(stats))
    # passing the counts works
    ll = gsm.expected_llh_of_stats(
        jnp.asarray(stats), jnp.asarray(counts), key=jax.random.PRNGKey(1)
    )
    assert np.isfinite(float(ll))


def test_gsm_train_scan_matches_stepwise(rng):
    """The one-dispatch scanned inner loop equals per-step jitted calls
    driven by the same key schedule (recipe stage 7 dispatch fix)."""
    from beer_tpu.models.gsm import make_gsm_train_scan

    stats, counts, _, _ = make_unit_stats(rng, n_units=6, d=4,
                                          frames_per_unit=20)
    stats, counts = jnp.asarray(stats), jnp.asarray(counts)
    gsm0 = GSM.create(n_units=6, embed_dim=2, obs_dim=4,
                      key=jax.random.PRNGKey(3))
    tx = optax.adam(5e-2)
    opt0 = tx.init(gsm0)
    key = jax.random.PRNGKey(9)

    elbo_s, gsm_s, _ = make_gsm_train_scan(tx)(
        gsm0, opt0, stats, counts, key, 5)

    step = make_gsm_train_step(tx)
    gsm, opt = gsm0, opt0
    for k in jax.random.split(key, 5):
        elbo, gsm, opt = step(gsm, opt, stats, counts, k)

    np.testing.assert_allclose(float(elbo_s), float(elbo), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(gsm_s), jax.tree.leaves(gsm)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=2e-5)
