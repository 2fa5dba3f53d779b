"""PPCA and PLDA tests.

PPCA: ELBO monotone; recovers a planted 2-D subspace in 6-D data; noise
precision estimated correctly.  PLDA: ELBO monotone on labeled clusters;
same-class trials score higher than different-class trials.
"""

import numpy as np
import jax
import jax.numpy as jnp

from beer_tpu.models.ppca import PPCA
from beer_tpu.models.plda import PLDA
from beer_tpu.vbi import (elbo_and_stats, vb_step, vb_step_coordinate,
                           vb_update_partial)


class TestPPCA:
    def make_data(self, rng, n=500, d=6, q=2, noise=0.1):
        w = rng.normal(size=(d, q))
        z = rng.normal(size=(n, q))
        mu = rng.normal(size=d)
        return (mu + z @ w.T + noise * rng.normal(size=(n, d))), w, mu

    def test_elbo_monotone_and_recovery(self, rng):
        data, w_true, mu_true = self.make_data(rng)
        x = jnp.asarray(data)
        model = PPCA.create(6, 2, mean=data.mean(0), key=jax.random.PRNGKey(0),
                            dtype=jnp.float64)
        elbos = []
        step = jax.jit(vb_step)
        for _ in range(80):
            elbo, model = step(model, x)
            elbos.append(float(elbo) / len(data))
        diffs = np.diff(elbos)
        assert np.all(diffs > -1e-8), f"ELBO decreased: min {diffs.min()}"
        # recovered subspace spans the true one (principal angles ~ 0)
        w_est = np.asarray(model.w_mean)
        qt, _ = np.linalg.qr(w_true)
        qe, _ = np.linalg.qr(w_est)
        sv = np.linalg.svd(qt.T @ qe, compute_uv=False)
        np.testing.assert_allclose(sv, 1.0, atol=1e-2)
        np.testing.assert_allclose(np.asarray(model.mean), mu_true, atol=0.1)
        # noise precision ~ 1/0.1^2 = 100
        e_lam = float(model._e_lam()[0])
        assert 60 < e_lam < 140, e_lam

    def test_transform_shape(self, rng):
        data, _, _ = self.make_data(rng, n=50)
        model = PPCA.create(6, 2, dtype=jnp.float64)
        z = model.transform(jnp.asarray(data))
        assert z.shape == (50, 2)


class TestPLDA:
    def make_data(self, rng, n_classes=20, per_class=15, d=8, q=2):
        f = rng.normal(size=(d, q)) * 2.0
        mu = rng.normal(size=d)
        xs, ys = [], []
        for c in range(n_classes):
            h = rng.normal(size=q)
            xs.append(mu + h @ f.T + 0.3 * rng.normal(size=(per_class, d)))
            ys.append(np.full(per_class, c))
        return np.concatenate(xs), np.concatenate(ys).astype(np.int32)

    def fit(self, rng, iters=40):
        data, labels = self.make_data(rng)
        x = jnp.asarray(data)
        y = jnp.asarray(labels)
        n_classes = int(labels.max()) + 1
        model = PLDA.create(8, 2, mean=data.mean(0), key=jax.random.PRNGKey(0),
                            dtype=jnp.float64)

        @jax.jit
        def step(model, x, y):
            stats = model.sufficient_statistics(x)
            llh, cache = model.infer(stats, labels=y, n_classes=n_classes)
            elbo = llh.sum() - model.kl_div_posterior_prior()
            acc = model.accumulate(stats, cache)
            return elbo, model.vb_update(acc)

        elbos = []
        for _ in range(iters):
            elbo, model = step(model, x, y)
            elbos.append(float(elbo) / len(data))
        return model, data, labels, elbos

    def test_elbo_monotone(self, rng):
        _, _, _, elbos = self.fit(rng)
        diffs = np.diff(elbos)
        assert np.all(diffs > -1e-8), f"ELBO decreased: min {diffs.min()}"

    def test_llr_separates_trials(self, rng):
        model, data, labels, _ = self.fit(rng)
        rng2 = np.random.default_rng(1)
        same_pairs, diff_pairs = [], []
        for _ in range(200):
            c = rng2.integers(labels.max() + 1)
            idx = np.flatnonzero(labels == c)
            i, j = rng2.choice(idx, 2, replace=False)
            same_pairs.append((data[i], data[j]))
            c2 = (c + 1 + rng2.integers(labels.max())) % (labels.max() + 1)
            k = rng2.choice(np.flatnonzero(labels == c2))
            diff_pairs.append((data[i], data[k]))
        e1s = jnp.asarray([p[0] for p in same_pairs])
        e2s = jnp.asarray([p[1] for p in same_pairs])
        e1d = jnp.asarray([p[0] for p in diff_pairs])
        e2d = jnp.asarray([p[1] for p in diff_pairs])
        same_scores = np.asarray(model.llr_score(e1s, e2s))
        diff_scores = np.asarray(model.llr_score(e1d, e2d))
        # strong separation: EER well below chance
        thresh = np.median(np.concatenate([same_scores, diff_scores]))
        acc = 0.5 * ((same_scores > thresh).mean() + (diff_scores <= thresh).mean())
        assert acc > 0.9, f"PLDA verification accuracy too low: {acc}"


class TestMeanFieldGroups:
    """vb_step_coordinate is real for PPCA/PLDA."""

    def test_ppca_coordinate_ascent_monotone(self, rng):
        data = TestPPCA().make_data(rng)[0]
        x = jnp.asarray(data)
        model = PPCA.create(6, 2, mean=data.mean(0),
                            key=jax.random.PRNGKey(0), dtype=jnp.float64)
        assert model.mean_field_factorization() == \
            [["w_mean", "w_cov", "mean"], ["prec"]]
        elbos = []
        for _ in range(40):
            elbo, model = vb_step_coordinate(model, x)
            elbos.append(float(elbo) / len(data))
        diffs = np.diff(elbos)
        assert np.all(diffs > -1e-8), f"ELBO decreased: min {diffs.min()}"

    def test_ppca_group_update_touches_only_group(self, rng):
        data = TestPPCA().make_data(rng, n=100)[0]
        x = jnp.asarray(data)
        model = PPCA.create(6, 2, dtype=jnp.float64)
        _, acc = elbo_and_stats(model, x)
        up = vb_update_partial(model, acc, ["prec"])
        np.testing.assert_array_equal(np.asarray(up.w_mean),
                                      np.asarray(model.w_mean))
        np.testing.assert_array_equal(np.asarray(up.mean),
                                      np.asarray(model.mean))
        assert not np.allclose(np.asarray(up.prec.posterior),
                               np.asarray(model.prec.posterior))
        up2 = vb_update_partial(model, acc, ["w_mean", "w_cov", "mean"])
        np.testing.assert_array_equal(np.asarray(up2.prec.posterior),
                                      np.asarray(model.prec.posterior))
        assert not np.allclose(np.asarray(up2.w_mean),
                               np.asarray(model.w_mean))

    def test_plda_coordinate_ascent_monotone(self, rng):
        t = TestPLDA()
        data, labels = t.make_data(rng)
        x, y = jnp.asarray(data), jnp.asarray(labels)
        n_classes = int(labels.max()) + 1
        model = PLDA.create(8, 2, mean=data.mean(0),
                            key=jax.random.PRNGKey(0), dtype=jnp.float64)
        assert model.mean_field_factorization() == \
            [["f_mean", "f_cov", "mean"], ["prec"]]

        def estep(m):
            stats = m.sufficient_statistics(x)
            llh, cache = m.infer(stats, labels=y, n_classes=n_classes)
            elbo = llh.sum() - m.kl_div_posterior_prior()
            return elbo, m.accumulate(stats, cache)

        elbos = []
        for _ in range(30):
            for group in model.mean_field_factorization():
                elbo, acc = estep(model)
                model = vb_update_partial(model, acc, group)
                elbos.append(float(elbo) / len(data))
        diffs = np.diff(elbos)
        assert np.all(diffs > -1e-8), f"ELBO decreased: min {diffs.min()}"


class TestPLDAQuadRestructure:
    """infer's per-class quadratic-term restructure (a (C,) einsum +
    lookup instead of the naive (N, Q, Q) e_hh[labels] gather) and the
    accumulate/vb_update algebra must reproduce the fully naive
    construction exactly (f64 oracle)."""

    def test_infer_accumulate_update_match_naive(self, rng):
        d, q, n_classes, per = 8, 3, 6, 9
        f = rng.normal(size=(d, q))
        xs, ys = [], []
        for c in range(n_classes):
            h = rng.normal(size=q)
            xs.append(h @ f.T + 0.3 * rng.normal(size=(per, d)))
            ys.append(np.full(per, c))
        x = jnp.asarray(np.concatenate(xs))
        y = jnp.asarray(np.concatenate(ys).astype(np.int32))
        model = PLDA.create(d, q, mean=np.zeros(d), key=jax.random.PRNGKey(3),
                            dtype=jnp.float64)
        # one warm VB step so posteriors are non-trivial
        stats = model.sufficient_statistics(x)
        llh, cache = model.infer(stats, labels=y, n_classes=n_classes)
        model = model.vb_update(model.accumulate(stats, cache))

        llh, cache = model.infer(stats, labels=y, n_classes=n_classes)
        acc = model.accumulate(stats, cache)
        up = model.vb_update(acc)

        # -- naive oracle: batched inverses and slogdets ---------------
        e_lam, e_loglam = model._e_lam()
        e_ftlf = model._e_ftlf()
        xc = x - model.mean
        counts = jax.ops.segment_sum(jnp.ones(len(x), x.dtype), y, n_classes)
        prec_h = (jnp.eye(q, dtype=x.dtype)[None]
                  + counts[:, None, None] * e_ftlf[None])
        cov_h = jnp.linalg.inv(prec_h)
        proj = xc @ (e_lam[:, None] * model.f_mean)
        sum_proj = jax.ops.segment_sum(proj, y, n_classes)
        m_h = jnp.einsum("cij,cj->ci", cov_h, sum_proj)
        e_hh = cov_h + m_h[:, :, None] * m_h[:, None, :]
        resid = ((e_lam * xc**2).sum(-1)
                 - 2.0 * (proj * m_h[y]).sum(-1)
                 + jnp.einsum("ij,nij->n", e_ftlf, e_hh[y]))
        e_logpx = 0.5 * (e_loglam.sum() - d * np.log(2 * np.pi)) - 0.5 * resid
        logdet_cov = jnp.linalg.slogdet(cov_h)[1]
        per_class = (-0.5 * (jnp.einsum("cii->c", e_hh) + q * np.log(2 * np.pi))
                     + 0.5 * (q * (1.0 + np.log(2 * np.pi)) + logdet_cov))
        llh_naive = e_logpx + (per_class / jnp.maximum(counts, 1.0))[y]
        s_h_naive = jnp.einsum("c,cij->ij", counts, e_hh)
        f_cov_naive = jnp.linalg.inv(
            jnp.eye(q, dtype=x.dtype)[None]
            + e_lam[:, None, None] * s_h_naive[None])
        f_mean_naive = jnp.einsum("d,dq,dqr->dr", e_lam, acc["c"], f_cov_naive)

        np.testing.assert_allclose(np.asarray(llh), np.asarray(llh_naive),
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(np.asarray(cache["m_h"]), np.asarray(m_h),
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(np.asarray(acc["s_h"]),
                                   np.asarray(s_h_naive),
                                   rtol=1e-9, atol=1e-10)
        np.testing.assert_allclose(np.asarray(up.f_cov),
                                   np.asarray(f_cov_naive),
                                   rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(np.asarray(up.f_mean),
                                   np.asarray(f_mean_naive),
                                   rtol=1e-9, atol=1e-10)
