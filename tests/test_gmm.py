"""End-to-end Bayesian GMM VB-EM (BASELINE config 1).

Covers: ELBO monotonicity for every covariance type, responsibilities
normalization, the reference-API veneer, jit-compiled training, and ELBO
parity against the independent CPU-torch re-implementation of the
reference algorithm (tests/torch_ref.py) at float64.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import beer_tpu
from beer_tpu.vbi import elbo_and_stats, vb_step


def make_data(rng, n=400, dtype=np.float64):
    """Three well-separated 2-D gaussian clusters."""
    means = np.array([[-4.0, 0.0], [4.0, 0.0], [0.0, 5.0]])
    covs = [np.diag([1.0, 0.3]), np.diag([0.5, 1.2]), np.diag([0.8, 0.8])]
    xs = [
        rng.multivariate_normal(m, c, size=n // 3)
        for m, c in zip(means, covs)
    ]
    return np.concatenate(xs).astype(dtype)


def make_gmm(data, ncomp=6, cov_type="full", key=0):
    mean = jnp.asarray(data.mean(0))
    cov = jnp.asarray(np.cov(data.T))
    nset = beer_tpu.NormalSet.create(
        mean, cov, size=ncomp, cov_type=cov_type, noise_std=1.0,
        key=jax.random.PRNGKey(key),
    )
    return beer_tpu.Mixture.create(nset)


@pytest.mark.parametrize(
    "cov_type",
    ["full", "diagonal", "isotropic", "shared_full", "shared_diagonal",
     "shared_isotropic"],
)
def test_elbo_monotone(rng, cov_type):
    data = make_data(rng)
    gmm = make_gmm(data, cov_type=cov_type)
    x = jnp.asarray(data)
    elbos = []
    for _ in range(15):
        elbo, gmm = vb_step(gmm, x)
        elbos.append(float(elbo) / len(data))
    diffs = np.diff(elbos)
    assert np.all(diffs > -1e-8), f"ELBO decreased: {elbos}"
    assert elbos[-1] > elbos[0] + 0.1


def test_resps_normalized(rng):
    data = make_data(rng)
    gmm = make_gmm(data)
    stats = gmm.sufficient_statistics(jnp.asarray(data))
    _, cache = gmm.infer(stats)
    np.testing.assert_allclose(
        np.asarray(cache["resps"]).sum(-1), 1.0, rtol=1e-8
    )


def test_reference_api_veneer(rng):
    """The reference notebook flow: evidence_lower_bound + optimizer."""
    data = make_data(rng)
    x = jnp.asarray(data)
    optim = beer_tpu.VBConjugateOptimizer(make_gmm(data), lrate=1.0)
    prev = -np.inf
    for _ in range(5):
        optim.init_step()
        elbo = beer_tpu.evidence_lower_bound(optim.model, x, datasize=len(data))
        elbo.backward()
        optim.step(elbo)
        assert float(elbo) >= prev - 1e-6
        prev = float(elbo)


def test_jit_epoch(rng):
    """The whole VB-EM step compiles to one XLA program."""
    data = make_data(rng)
    gmm = make_gmm(data)
    x = jnp.asarray(data)
    step = jax.jit(vb_step)
    e1, gmm = step(gmm, x)
    e2, gmm = step(gmm, x)
    assert float(e2) > float(e1)


def test_minibatch_scaling(rng):
    """datasize scaling: full-batch stats == sum of equal minibatch stats."""
    data = make_data(rng, n=300)
    gmm = make_gmm(data)
    x = jnp.asarray(data)
    _, acc_full = elbo_and_stats(gmm, x)
    # one minibatch of the full data with datasize=N gives identical scaled stats
    _, acc_mb = elbo_and_stats(gmm, x, datasize=len(data))
    for a, b in zip(jax.tree.leaves(acc_full), jax.tree.leaves(acc_mb)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10)


def _full_nset(data, k=5):
    return beer_tpu.NormalSet.create(
        jnp.asarray(data.mean(0)), jnp.asarray(np.cov(data.T)),
        size=k, cov_type="full", noise_std=1.0,
        key=jax.random.PRNGKey(1),
    )


def test_raw_frame_ellh_matches_materialized(rng):
    """stats_kernels.ellh_full_xla scores raw frames exactly like the
    materialized full-covariance statistics path."""
    from beer_tpu.ops import stats_kernels

    data = make_data(rng, n=90)
    nset = _full_nset(data)
    x = jnp.asarray(data)
    e_stats = nset.means_precisions.expected_sufficient_statistics()
    got = stats_kernels.ellh_full_xla(x, e_stats, nset.dim)
    ref = nset.expected_log_likelihood(nset.sufficient_statistics(x))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-10, atol=1e-10)


def test_raw_frame_accumulate_matches_materialized(rng):
    """stats_kernels.accumulate_full_xla == NormalSet.accumulate on the
    materialized statistics."""
    from beer_tpu.ops import stats_kernels

    data = make_data(rng, n=90)
    nset = _full_nset(data)
    x = jnp.asarray(data)
    resps = jax.nn.softmax(
        jnp.asarray(rng.normal(size=(len(data), 5))), axis=-1
    )
    ref = nset.accumulate(nset.sufficient_statistics(x), resps)
    got = stats_kernels.accumulate_full_xla(x, resps)
    np.testing.assert_allclose(np.asarray(got),
                               np.asarray(ref["means_precisions"]),
                               rtol=1e-10, atol=1e-10)


def test_recovers_clusters(rng):
    data = make_data(rng, n=600)
    gmm = make_gmm(data, ncomp=3, cov_type="full", key=3)
    x = jnp.asarray(data)
    for _ in range(50):
        _, gmm = vb_step(gmm, x)
    learned = np.sort(np.asarray(gmm.modelset.means()), axis=0)
    true = np.sort(np.array([[-4.0, 0.0], [4.0, 0.0], [0.0, 5.0]]), axis=0)
    np.testing.assert_allclose(learned, true, atol=0.5)


class TestTorchParity:
    """ELBO trajectory parity vs the independent torch implementation.

    BASELINE target: ≤ 1e-4/frame in f32; here both sides run f64 on
    CPU so agreement must be much tighter.
    """

    def test_elbo_trajectory(self, rng):
        import torch

        from tests.torch_ref import TorchVBGMM

        data = make_data(rng, n=300)
        x = jnp.asarray(data)
        n, d = data.shape
        ncomp = 4

        mean = data.mean(0)
        cov = np.cov(data.T)
        prior_strength = 1.0
        dof0 = d + prior_strength
        w0 = np.linalg.inv(cov) / dof0
        noise = np.asarray(
            jax.random.normal(jax.random.PRNGKey(7), (ncomp, d))
        )
        post_means = mean + 1.0 * noise

        # beer_tpu model with *identical* prior and posterior init.
        from beer_tpu import dists
        from beer_tpu.models.parameters import BayesianParameter
        from beer_tpu.models.normal import NormalSet

        fam = dists.NormalWishart(dim=d)
        prior_nat = fam.to_nat(jnp.asarray(mean), prior_strength, jnp.asarray(w0), dof0)
        post_nat = jax.vmap(
            lambda m: fam.to_nat(m, prior_strength, jnp.asarray(w0), dof0)
        )(jnp.asarray(post_means))
        nset = NormalSet(
            means_precisions=BayesianParameter(
                prior=jnp.broadcast_to(prior_nat, (ncomp,) + prior_nat.shape),
                posterior=post_nat,
                family=fam,
            ),
            cov_type="full", ncomp=ncomp, dim=d,
        )
        gmm = beer_tpu.Mixture.create(nset, prior_strength=1.0)

        ref = TorchVBGMM(
            torch.tensor(mean), prior_strength, torch.tensor(w0), dof0,
            torch.ones(ncomp, dtype=torch.float64),
            torch.tensor(post_means),
        )

        for it in range(10):
            elbo_jax, gmm = vb_step(gmm, x)
            elbo_ref = ref.em_step(torch.tensor(data))
            per_frame_diff = abs(float(elbo_jax) - float(elbo_ref)) / n
            assert per_frame_diff < 1e-8, (
                f"iter {it}: jax {float(elbo_jax)/n:.10f} vs "
                f"torch {float(elbo_ref)/n:.10f}"
            )


def test_coordinate_ascent_monotone(rng):
    """Mean-field group-sequential updates are also monotone VB-EM."""
    from beer_tpu.vbi import vb_step_coordinate

    data = make_data(rng)
    gmm = make_gmm(data)
    x = jnp.asarray(data)
    step = jax.jit(vb_step_coordinate)
    elbos = []
    for _ in range(10):
        elbo, gmm = step(gmm, x)
        elbos.append(float(elbo) / len(data))
    diffs = np.diff(elbos)
    assert np.all(diffs > -1e-8), f"ELBO decreased: {elbos}"


def test_fused_mixture_posteriors_and_cpu_fallback(rng):
    """A full-covariance Mixture's posteriors() equal the responsibilities
    that infer() caches, and sum to one."""
    import jax
    import jax.numpy as jnp

    import beer_tpu

    d, k, t = 4, 3, 40
    x = jnp.asarray(rng.normal(size=(t, d)).astype(np.float32))
    nset = beer_tpu.NormalSet.create(
        jnp.zeros(d), jnp.eye(d), size=k, cov_type="full",
        noise_std=0.5, key=jax.random.PRNGKey(0))
    gmm = beer_tpu.Mixture.create(nset)
    llh, cache = gmm.infer(gmm.sufficient_statistics(x))
    assert "resps" in cache
    post = gmm.posteriors(x)
    np.testing.assert_allclose(np.asarray(post), np.asarray(cache["resps"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(post.sum(-1)), 1.0, rtol=1e-5)


def test_fused_route_trajectory_tracks_exact(rng):
    """VB-EM driven by the raw-frame E-step (stats_kernels.gmm_estep_xla)
    must TRACK the materialized vb_step route — pointwise ELBO drift
    small and monotone — on clustered data with sharpening precisions."""
    import jax
    import jax.numpy as jnp

    import beer_tpu
    from beer_tpu.ops import stats_kernels
    from beer_tpu.vbi import vb_step

    d, k, t = 8, 8, 4000
    centers = rng.normal(size=(4, d)) * 3.0
    x = jnp.asarray((centers[rng.integers(0, 4, size=t)]
                     + rng.normal(size=(t, d))).astype(np.float32))

    def raw_frame_step(gmm):
        ms = gmm.modelset
        e_stats = ms.means_precisions.expected_sufficient_statistics()
        llh, acc, counts = stats_kernels.gmm_estep_xla(
            x, e_stats, gmm.categorical.expected_log_weights(), ms.dim)
        elbo = llh.sum() - gmm.kl_div_posterior_prior()
        return elbo, gmm.vb_update({
            "categorical": gmm.categorical.accumulate_counts(counts),
            "modelset": {"means_precisions": acc},
        })

    trajs = {}
    for raw in (True, False):
        nset = beer_tpu.NormalSet.create(
            jnp.zeros(d), jnp.eye(d), size=k, cov_type="full",
            noise_std=0.5, key=jax.random.PRNGKey(2))
        gmm = beer_tpu.Mixture.create(nset)
        elbos = []
        for _ in range(10):
            e, gmm = raw_frame_step(gmm) if raw else vb_step(gmm, x)
            elbos.append(float(e) / t)
        trajs[raw] = np.array(elbos)
        # monotone after burn-in
        drops = np.diff(elbos[2:])
        assert drops.min() > -1e-3, elbos
    drift = np.abs(trajs[True] - trajs[False]).max()
    assert drift <= 1e-4, drift
