"""(S)VAE tests (BASELINE config 5).

The hybrid step (optax reparameterization + conjugate natural-gradient)
must raise the ELBO on synthetic data, with both a plain Normal latent
prior (classic VAE) and a GMM latent prior (structured VAE).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax

import beer_tpu
from beer_tpu.models.vae import VAE, make_vae_train_step


def make_data(rng, n=256, d=8):
    """Two latent clusters pushed through a fixed random linear map."""
    z = np.concatenate(
        [rng.normal(size=(n // 2, 2)) + [-3, 0], rng.normal(size=(n // 2, 2)) + [3, 0]]
    )
    w = rng.normal(size=(2, d))
    return (z @ w + 0.1 * rng.normal(size=(n, d))).astype(np.float32)


def make_latent_prior(kind, key=0):
    mean, cov = jnp.zeros(2), 4.0 * jnp.eye(2)
    if kind == "normal":
        return beer_tpu.Normal.create(mean, cov, cov_type="full")
    nset = beer_tpu.NormalSet.create(
        mean, cov, size=4, cov_type="full", noise_std=1.0,
        key=jax.random.PRNGKey(key),
    )
    return beer_tpu.Mixture.create(nset)


@pytest.mark.parametrize("prior_kind", ["normal", "gmm"])
def test_elbo_improves(rng, prior_kind):
    data = make_data(rng)
    x = jnp.asarray(data)
    vae = VAE.create(
        obs_dim=data.shape[1], latent_dim=2,
        latent_model=make_latent_prior(prior_kind),
        hidden=(32, 32), nsamples=1, key=jax.random.PRNGKey(0),
    )
    tx = optax.adam(1e-3)
    opt_state = tx.init(vae.nnet_params)
    step = make_vae_train_step(tx)
    key = jax.random.PRNGKey(42)
    elbos = []
    for it in range(200):
        key, sub = jax.random.split(key)
        elbo, vae, opt_state = step(vae, opt_state, x, sub)
        elbos.append(float(elbo) / len(data))
    assert np.isfinite(elbos).all()
    first = np.mean(elbos[:10])
    last = np.mean(elbos[-10:])
    assert last > first + 1.0, f"ELBO did not improve: {first} -> {last}"


def test_svae_latent_clusters(rng):
    """With a GMM prior the aggregate posterior should use >1 component."""
    data = make_data(rng, n=256)
    x = jnp.asarray(data)
    vae = VAE.create(
        obs_dim=data.shape[1], latent_dim=2,
        latent_model=make_latent_prior("gmm", key=3),
        hidden=(32, 32), key=jax.random.PRNGKey(1),
    )
    tx = optax.adam(3e-3)
    opt_state = tx.init(vae.nnet_params)
    step = make_vae_train_step(tx)
    key = jax.random.PRNGKey(7)
    for _ in range(300):
        key, sub = jax.random.split(key)
        _, vae, opt_state = step(vae, opt_state, x, sub)
    q = vae.posteriors(x)
    resps = vae.latent_model.posteriors(q["mean"])
    usage = np.asarray(resps).mean(0)
    assert (usage > 0.1).sum() >= 2, f"only one active component: {usage}"


def test_bernoulli_output(rng):
    """VAE with Bernoulli decoder head on binarized data."""
    data = (make_data(rng) > 0).astype(np.float32)
    x = jnp.asarray(data)
    vae = VAE.create(
        obs_dim=data.shape[1], latent_dim=2,
        latent_model=make_latent_prior("normal"),
        hidden=(16,), output="bernoulli", key=jax.random.PRNGKey(2),
    )
    tx = optax.adam(3e-3)
    opt_state = tx.init(vae.nnet_params)
    step = make_vae_train_step(tx)
    key = jax.random.PRNGKey(0)
    elbos = []
    for _ in range(100):
        key, sub = jax.random.split(key)
        elbo, vae, opt_state = step(vae, opt_state, x, sub)
        elbos.append(float(elbo) / len(data))
    assert np.isfinite(elbos).all()
    assert np.mean(elbos[-10:]) > np.mean(elbos[:10])


# ----------------------------------------------------------------------
# Sequence SVAE (HMM / phone-loop latent prior) — BASELINE config 5
# ----------------------------------------------------------------------
def make_seq_data(rng, b=12, t=48, d=8, seg=8):
    """Latent unit sequences (2 units, fixed-length segments) pushed
    through a random linear map; returns (x, mask, unit labels)."""
    means = np.array([[-3.0, 0.0], [3.0, 0.0]])
    w = rng.normal(size=(2, d))
    labels = np.zeros((b, t), np.int32)
    x = np.zeros((b, t, d), np.float32)
    for i in range(b):
        start_unit = i % 2
        for s in range(0, t, seg):
            u = (start_unit + s // seg) % 2
            labels[i, s:s + seg] = u
            z = means[u] + 0.3 * rng.normal(size=(min(seg, t - s), 2))
            x[i, s:s + seg] = z @ w + 0.1 * rng.normal(size=(min(seg, t - s), d))
    return x, np.ones((b, t), np.float32), labels


def _unit_accuracy(pred, true):
    """Best-permutation frame accuracy for 2-unit labelings."""
    pred, true = np.asarray(pred), np.asarray(true)
    acc = (pred == true).mean()
    return max(acc, 1.0 - acc)


def test_sequence_svae_phone_loop_prior(rng):
    from beer_tpu.models.phoneloop import PhoneLoop
    from beer_tpu.models.vae import SequenceVAE

    x_np, mask_np, labels = make_seq_data(rng)
    x, mask = jnp.asarray(x_np), jnp.asarray(mask_np)
    nset = beer_tpu.NormalSet.create(
        jnp.zeros(2), 4.0 * jnp.eye(2), size=2 * 2, cov_type="diagonal",
        noise_std=1.0, key=jax.random.PRNGKey(5),
    )
    loop = PhoneLoop.create(2, 2, nset, self_loop=0.8)
    svae = SequenceVAE.create(
        obs_dim=x_np.shape[-1], latent_dim=2, latent_model=loop,
        hidden=(32, 32), nsamples=1, key=jax.random.PRNGKey(3),
    )
    tx = optax.adam(3e-3)
    opt_state = tx.init(svae.nnet_params)
    step = make_vae_train_step(tx)
    key = jax.random.PRNGKey(11)
    elbos = []
    for _ in range(250):
        key, sub = jax.random.split(key)
        elbo, svae, opt_state = step(svae, opt_state, x, sub, mask)
        elbos.append(float(elbo) / mask_np.sum())
    assert np.isfinite(elbos).all()
    assert np.mean(elbos[-10:]) > np.mean(elbos[:10]) + 1.0, (
        f"sequence SVAE ELBO did not improve: "
        f"{np.mean(elbos[:10])} -> {np.mean(elbos[-10:])}"
    )
    # latent Viterbi segmentation should track the true unit boundaries
    units, _ = jax.jit(svae.latent_decode)(x, mask)
    acc = _unit_accuracy(units, labels)
    assert acc > 0.75, f"latent segmentation accuracy too low: {acc}"


def test_sequence_svae_hmm_prior_infer(rng):
    """SequenceVAE.infer returns finite per-sequence MC ELBO terms."""
    from beer_tpu.models.phoneloop import PhoneLoop
    from beer_tpu.models.vae import SequenceVAE

    x_np, mask_np, _ = make_seq_data(rng, b=4, t=16)
    nset = beer_tpu.NormalSet.create(
        jnp.zeros(2), jnp.eye(2), size=4, cov_type="diagonal",
        noise_std=1.0, key=jax.random.PRNGKey(0),
    )
    svae = SequenceVAE.create(
        obs_dim=x_np.shape[-1], latent_dim=2,
        latent_model=PhoneLoop.create(2, 2, nset),
        hidden=(16,), key=jax.random.PRNGKey(1),
    )
    llh, cache = jax.jit(svae.infer)(jnp.asarray(x_np))
    assert llh.shape == (4,)
    assert np.isfinite(np.asarray(llh)).all()
    assert "posterior" in cache


# ----------------------------------------------------------------------
# Flow posteriors wired into the VAE
# ----------------------------------------------------------------------
def test_flow_vae_trains_and_matches_plain(rng):
    data = make_data(rng)
    x = jnp.asarray(data)

    def train(n_planar, n_iaf, seed):
        vae = VAE.create(
            obs_dim=data.shape[1], latent_dim=2,
            latent_model=make_latent_prior("normal"),
            hidden=(32, 32), nsamples=1,
            n_flow_planar=n_planar, n_flow_iaf=n_iaf,
            key=jax.random.PRNGKey(seed),
        )
        tx = optax.adam(3e-3)
        opt_state = tx.init(vae.nnet_params)
        step = make_vae_train_step(tx)
        key = jax.random.PRNGKey(99)
        elbos = []
        for _ in range(250):
            key, sub = jax.random.split(key)
            elbo, vae, opt_state = step(vae, opt_state, x, sub)
            elbos.append(float(elbo) / len(data))
        return np.asarray(elbos), vae

    plain_elbos, _ = train(0, 0, seed=0)
    flow_elbos, flow_vae = train(2, 1, seed=0)
    assert np.isfinite(flow_elbos).all()
    assert flow_elbos[-10:].mean() > flow_elbos[:10].mean() + 1.0
    # the flow posterior must not lose to the plain diagonal posterior
    assert flow_elbos[-10:].mean() > plain_elbos[-10:].mean() - 0.5, (
        f"flow VAE worse than plain: {flow_elbos[-10:].mean()} vs "
        f"{plain_elbos[-10:].mean()}"
    )
    assert flow_vae.flow_def is not None
    assert "flow" in flow_vae.nnet_params


# ----------------------------------------------------------------------
# nnet breadth: residual trunks, iso head, config-string builders
# ----------------------------------------------------------------------
def test_nnet_builders_and_heads():
    from beer_tpu import nnet

    trunk = nnet.build_trunk("resmlp:32x2:relu")
    params = trunk.init(jax.random.PRNGKey(0), jnp.zeros((3, 5)))
    out = trunk.apply(params, jnp.ones((3, 5)))
    assert out.shape == (3, 32)

    trunk2 = nnet.build_trunk("mlp:16,8")
    p2 = trunk2.init(jax.random.PRNGKey(0), jnp.zeros((3, 5)))
    assert trunk2.apply(p2, jnp.ones((3, 5))).shape == (3, 8)

    head = nnet.build_head("normal_iso", 4)
    ph = head.init(jax.random.PRNGKey(0), jnp.zeros((3, 8)))
    q = head.apply(ph, jnp.ones((3, 8)))
    assert q["mean"].shape == (3, 4) and q["logvar"].shape == (3, 4)
    # isotropic: one shared logvar per row
    assert np.allclose(np.asarray(q["logvar"]).std(axis=-1), 0.0)

    import pytest as _pytest
    with _pytest.raises(ValueError):
        nnet.build_trunk("conv:3")
    with _pytest.raises(ValueError):
        nnet.build_head("poisson", 4)


def test_vae_residual_iso(rng):
    """Residual trunk + isotropic head VAE trains."""
    data = make_data(rng, n=128)
    x = jnp.asarray(data)
    vae = VAE.create(
        obs_dim=data.shape[1], latent_dim=2,
        latent_model=make_latent_prior("normal"),
        hidden=(32, 32), residual=True, output="normal_iso",
        key=jax.random.PRNGKey(4),
    )
    tx = optax.adam(3e-3)
    opt_state = tx.init(vae.nnet_params)
    step = make_vae_train_step(tx)
    key = jax.random.PRNGKey(1)
    elbos = []
    for _ in range(100):
        key, sub = jax.random.split(key)
        elbo, vae, opt_state = step(vae, opt_state, x, sub)
        elbos.append(float(elbo) / len(data))
    assert np.isfinite(elbos).all()
    assert np.mean(elbos[-10:]) > np.mean(elbos[:10])


def test_vae_infer_honest(rng):
    """VAE.infer returns a per-frame MC ELBO (not the round-1 stub)."""
    data = make_data(rng, n=64)
    x = jnp.asarray(data)
    vae = VAE.create(
        obs_dim=data.shape[1], latent_dim=2,
        latent_model=make_latent_prior("normal"),
        hidden=(16,), key=jax.random.PRNGKey(0),
    )
    llh, cache = jax.jit(vae.infer)(x)
    assert llh.shape == (64,)
    assert np.isfinite(np.asarray(llh)).all()
    # reconstruction of untrained nets must make this far below 0
    assert float(llh.mean()) < 0.0


# ----------------------------------------------------------------------
# Mean-field groups through the latent model; mask-aware SequenceVAE.infer
# ----------------------------------------------------------------------
def test_vae_mean_field_groups(rng):
    """VAE exposes the latent model's groups via dotted paths, and a
    group update grafts only those sub-fields."""
    from beer_tpu.vbi import vb_update_partial

    data = make_data(rng, n=64)
    x = jnp.asarray(data)
    vae = VAE.create(
        obs_dim=data.shape[1], latent_dim=2,
        latent_model=make_latent_prior("gmm"),
        hidden=(16,), key=jax.random.PRNGKey(2),
    )
    groups = vae.mean_field_factorization()
    assert groups == [["latent_model.categorical"], ["latent_model.modelset"]]

    key = jax.random.PRNGKey(7)
    elbo0, acc = vae.elbo_and_stats(x, key)
    up = vb_update_partial(vae, acc, groups[0])
    # weights updated, emissions and nnets untouched
    assert not np.allclose(
        np.asarray(up.latent_model.categorical.weights.posterior),
        np.asarray(vae.latent_model.categorical.weights.posterior),
    )
    np.testing.assert_array_equal(
        np.asarray(up.latent_model.modelset.means_precisions.posterior),
        np.asarray(vae.latent_model.modelset.means_precisions.posterior),
    )
    chex_equal = jax.tree.all(jax.tree.map(
        lambda a, b: bool(jnp.array_equal(a, b)), up.nnet_params, vae.nnet_params
    ))
    assert chex_equal
    # alternating both conjugate groups with the same key raises the ELBO
    up2 = vb_update_partial(up, acc, groups[1])
    elbo1, _ = up2.elbo_and_stats(x, key)
    assert float(elbo1) >= float(elbo0) - 1e-6


def test_sequence_svae_infer_mask_aware(rng):
    """Garbage in padded frames must not change masked infer outputs."""
    from beer_tpu.models.phoneloop import PhoneLoop
    from beer_tpu.models.vae import SequenceVAE

    x_np, mask_np, _ = make_seq_data(rng, b=4, t=16)
    # make the mask genuinely ragged
    mask_np[:, 10:] = 0.0
    nset = beer_tpu.NormalSet.create(
        jnp.zeros(2), jnp.eye(2), size=4, cov_type="diagonal",
        noise_std=1.0, key=jax.random.PRNGKey(0),
    )
    svae = SequenceVAE.create(
        obs_dim=x_np.shape[-1], latent_dim=2,
        latent_model=PhoneLoop.create(2, 2, nset),
        hidden=(16,), key=jax.random.PRNGKey(1),
    )
    x = jnp.asarray(x_np)
    mask = jnp.asarray(mask_np)
    llh, _ = svae.infer(x, mask=mask)
    x_garbage = jnp.where(mask[..., None] > 0, x, 1e3)
    llh_g, _ = svae.infer(x_garbage, mask=mask)
    np.testing.assert_allclose(np.asarray(llh), np.asarray(llh_g), rtol=1e-6)
    assert np.isfinite(np.asarray(llh)).all()
