"""Phone-loop AUD tests (BASELINE config 4).

Synthetic AUD: sequences built from a small set of "phones" (distinct
emission distributions with left-to-right dwell); the phone loop must
train monotonically, discover the units, and produce segmentations whose
NMI against the true phone labels is high.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import beer_tpu
from beer_tpu.models.phoneloop import PhoneLoop
from beer_tpu.vbi import vb_step


def make_aud_data(rng, n_seq=12, n_phones=3, t_len=60, d=2, dtype=np.float64):
    """Random phone sequences, each phone dwelling 4-8 frames."""
    centers = rng.normal(size=(n_phones, d)) * 4.0
    data = np.zeros((n_seq, t_len, d), dtype)
    labels = np.full((n_seq, t_len), -1, np.int32)
    mask = np.zeros((n_seq, t_len), dtype)
    for i in range(n_seq):
        t = 0
        while t < t_len - 4:
            p = int(rng.integers(n_phones))
            dwell = int(rng.integers(4, 9))
            dwell = min(dwell, t_len - t)
            data[i, t : t + dwell] = centers[p] + 0.4 * rng.normal(size=(dwell, d))
            labels[i, t : t + dwell] = p
            t += dwell
        mask[i, :t] = 1
    return data, labels, mask, centers


def nmi(a, b):
    """Normalized mutual information of two label sequences."""
    from collections import Counter

    a, b = np.asarray(a), np.asarray(b)
    n = len(a)
    pa = Counter(a)
    pb = Counter(b)
    pab = Counter(zip(a, b))
    mi = sum(
        (c / n) * np.log((c / n) / ((pa[x] / n) * (pb[y] / n)))
        for (x, y), c in pab.items()
    )
    ha = -sum((c / n) * np.log(c / n) for c in pa.values())
    hb = -sum((c / n) * np.log(c / n) for c in pb.values())
    return mi / max(np.sqrt(ha * hb), 1e-10)


@pytest.fixture
def trained_loop(rng):
    data, labels, mask, _ = make_aud_data(rng)
    flat = data.reshape(-1, 2)[mask.reshape(-1) > 0]
    n_units, states_per_unit = 8, 3
    nset = beer_tpu.NormalSet.create(
        jnp.asarray(flat.mean(0)),
        jnp.asarray(np.cov(flat.T)),
        size=n_units * states_per_unit,
        cov_type="full",
        noise_std=2.0,
        key=jax.random.PRNGKey(11),
    )
    loop = PhoneLoop.create(
        n_units, states_per_unit, nset, concentration=2.0, dtype=jnp.float64
    )
    x, m = jnp.asarray(data), jnp.asarray(mask)
    step = jax.jit(vb_step)
    elbos = []
    for _ in range(30):
        elbo, loop = step(loop, x, mask=m)
        elbos.append(float(elbo) / mask.sum())
    return loop, x, m, labels, mask, elbos


def test_elbo_monotone(trained_loop):
    *_, elbos = trained_loop
    diffs = np.diff(elbos)
    assert np.all(diffs > -1e-8), f"ELBO decreased: min diff {diffs.min()}"


def test_unit_counts_total(rng):
    """Expected unit counts must sum to the expected number of segments."""
    data, labels, mask, _ = make_aud_data(rng, n_seq=4)
    flat = data.reshape(-1, 2)[mask.reshape(-1) > 0]
    nset = beer_tpu.NormalSet.create(
        jnp.asarray(flat.mean(0)), jnp.asarray(np.cov(flat.T)),
        size=12, cov_type="full", noise_std=1.0, key=jax.random.PRNGKey(2),
    )
    loop = PhoneLoop.create(4, 3, nset, dtype=jnp.float64)
    x, m = jnp.asarray(data), jnp.asarray(mask)
    stats = loop.sufficient_statistics(x)
    _, cache = loop.infer(stats, mask=m)
    counts = np.asarray(loop._unit_counts(cache))
    assert counts.min() >= -1e-8
    # total segments >= number of sequences (each visits at least one unit)
    assert counts.sum() >= len(data) - 1e-6


def test_aud_segmentation_quality(trained_loop):
    loop, x, m, labels, mask, _ = trained_loop
    units, _ = jax.jit(loop.decode_units)(x, m)
    units = np.asarray(units)
    valid = mask.reshape(-1) > 0
    score = nmi(labels.reshape(-1)[valid], units.reshape(-1)[valid])
    # 3 true phones, clean separation: NMI should be high
    assert score > 0.55, f"NMI too low: {score}"


def test_sb_prior_prunes_units(trained_loop):
    """The DP prior should concentrate mass on a few units."""
    loop, *_ = trained_loop
    weights = np.asarray(loop.unit_prior.mean())
    top3 = np.sort(weights)[::-1][:3].sum()
    assert top3 > 0.6, f"stick-breaking weights too flat: {weights}"


def test_hyperprior_phone_loop(rng):
    """SBCategoricalHyperPrior trains monotonically and adapts gamma."""
    from beer_tpu.models.categorical import SBCategoricalHyperPrior

    data, labels, mask, _ = make_aud_data(rng, n_seq=6)
    flat = data.reshape(-1, 2)[mask.reshape(-1) > 0]
    nset = beer_tpu.NormalSet.create(
        jnp.asarray(flat.mean(0)), jnp.asarray(np.cov(flat.T)),
        size=18, cov_type="full", noise_std=1.5, key=jax.random.PRNGKey(4),
    )
    prior = SBCategoricalHyperPrior.create(6, dtype=jnp.float64)
    loop = PhoneLoop.create(6, 3, nset, unit_prior=prior, dtype=jnp.float64)
    x, m = jnp.asarray(data), jnp.asarray(mask)
    step = jax.jit(vb_step)
    elbos = []
    for _ in range(15):
        elbo, loop = step(loop, x, mask=m)
        elbos.append(float(elbo) / mask.sum())
    diffs = np.diff(elbos)
    assert np.all(diffs > -1e-7), f"min diff {diffs.min()}"
    # gamma posterior moved away from the prior
    a, b = loop.unit_prior.concentration.family.to_std(
        loop.unit_prior.concentration.posterior
    )
    assert float(a) > 1.0


def test_structured_trans_densifies_to_graph():
    """The band + rank-1 factorization fed to the scan kernels must be
    the same matrix as the dense effective graph (kernel correctness
    rests on this identity)."""
    import beer_tpu
    from beer_tpu.ops import semiring_scan

    for n_units, spu in [(4, 3), (5, 1)]:
        nset = beer_tpu.NormalSet.create(
            jnp.zeros(2), jnp.ones(2), size=n_units * spu,
            cov_type="diagonal", key=jax.random.PRNGKey(0),
        )
        loop = PhoneLoop.create(n_units, spu, nset, self_loop=0.7)
        dense = jnp.exp(loop._effective_graph().log_trans)
        banded = semiring_scan.bands_to_dense(
            loop._structured_trans(jnp.float32)
        )
        np.testing.assert_allclose(
            np.asarray(banded), np.asarray(dense), rtol=1e-6, atol=1e-7
        )


def test_banded_viterbi_matches_dense(rng):
    """PhoneLoop.decode's band + rank-1 (max,+) path == the dense
    semiring_scan.viterbi on the same effective graph: identical paths
    and scores (random data — ties measure-zero), P>1 and P==1, with a
    ragged mask."""
    from beer_tpu.ops import semiring_scan

    for spu in (3, 1):
        data, _, mask, _ = make_aud_data(rng, n_seq=6, t_len=50, d=2)
        data = data.astype(np.float32)
        mask = mask.astype(np.float32)
        nset = beer_tpu.NormalSet.create(
            jnp.zeros(2), jnp.eye(2), size=8 * spu, cov_type="diagonal",
            noise_std=0.7, key=jax.random.PRNGKey(4))
        loop = PhoneLoop.create(8, spu, nset)
        # a couple of VB steps so transitions/weights are non-uniform
        for _ in range(2):
            _, loop = vb_step(loop, jnp.asarray(data),
                              mask=jnp.asarray(mask))
        x, m = jnp.asarray(data), jnp.asarray(mask)
        paths_b, score_b = loop.decode(x, m)
        graph = loop._effective_graph()
        stats = loop.sufficient_statistics(x)
        llh = loop.modelset.expected_log_likelihood(stats)
        paths_d, score_d = semiring_scan.viterbi(
            llh, graph.log_trans, graph.log_init, graph.log_final, m)
        np.testing.assert_allclose(np.asarray(score_b),
                                   np.asarray(score_d), rtol=1e-5)
        valid = np.asarray(m) > 0
        np.testing.assert_array_equal(
            np.asarray(paths_b)[valid], np.asarray(paths_d)[valid])


def test_structured_trans_after_transition_writeback(rng):
    """Bands must track PER-STATE transitions written back by the
    subspace (gsm.apply_to_phoneloop --learn-transitions), not the
    scalar self_loop the loop was created with (round-4 bug: stale
    scalar bands misrouted every fused E-step and banded decode on a
    trained H-SHMM loop)."""
    import beer_tpu
    from beer_tpu.ops import semiring_scan

    n_units, spu = 4, 3
    s = n_units * spu
    nset = beer_tpu.NormalSet.create(
        jnp.zeros(2), jnp.ones(2), size=s, cov_type="diagonal",
        key=jax.random.PRNGKey(0))
    loop = PhoneLoop.create(n_units, spu, nset, self_loop=0.6)
    # simulate the write-back: per-state self/adv + per-unit exit
    e_self = np.log(rng.uniform(0.3, 0.9, size=s)).astype(np.float32)
    base = np.asarray(loop.base_log_trans).copy()
    ids = np.arange(s)
    nonfinal = ids % spu != spu - 1
    base[ids, ids] = e_self
    base[ids[nonfinal], ids[nonfinal] + 1] = np.log1p(
        -np.exp(e_self[nonfinal]))
    log_exit = np.log(rng.uniform(0.05, 0.3, size=n_units)).astype(
        np.float32)
    loop = loop.replace(base_log_trans=jnp.asarray(base),
                        log_exit=jnp.asarray(log_exit))
    dense = jnp.exp(loop._effective_graph().log_trans)
    banded = semiring_scan.bands_to_dense(
        loop._structured_trans(jnp.float32))
    np.testing.assert_allclose(np.asarray(banded), np.asarray(dense),
                               rtol=1e-6, atol=1e-7)


def test_viterbi_kernel_exit_argmax_over_256():
    """A loop-back whose best exit state is odd and > 256 (state 269 of
    a 90-unit x 3-state loop; an exit argmax stored in bf16 is exact
    only to 256) must backtrace through the right state.  Crafted llh
    climbs unit 89 (267-269) / unit 87 (261-263), then loops back into
    unit 0.  The banded route must match the dense viterbi exactly."""
    from beer_tpu.ops import semiring_scan

    units, spu = 90, 3
    s = units * spu
    nset = beer_tpu.NormalSet.create(
        jnp.zeros(2), jnp.eye(2), size=s, cov_type="diagonal",
        noise_std=0.7, key=jax.random.PRNGKey(4))
    loop = PhoneLoop.create(units, spu, nset)
    graph = loop._effective_graph()
    t_len = 19
    llh = np.full((2, t_len, s), -80.0, np.float32)
    for b, hi in enumerate((267, 261)):
        for t in range(3):
            llh[b, t, hi + t] = 0.0
        for t in range(3, t_len):
            llh[b, t, (t - 3) % 3] = 0.0
    m = jnp.ones((2, t_len), jnp.float32)
    bands = loop._structured_trans(jnp.float32)

    paths_d, score_d = semiring_scan.viterbi(
        jnp.asarray(llh), graph.log_trans, graph.log_init,
        graph.log_final, m)
    paths_k, score_k = semiring_scan.viterbi_banded(
        jnp.asarray(llh), bands, graph.log_init, graph.log_final, m)
    np.testing.assert_allclose(np.asarray(score_k),
                               np.asarray(score_d), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(paths_k),
                                  np.asarray(paths_d))
    # the scenario actually exercised the > 256 exit argmax
    np.testing.assert_array_equal(np.asarray(paths_k)[0, :4],
                                  [267, 268, 269, 0])
    np.testing.assert_array_equal(np.asarray(paths_k)[1, :4],
                                  [261, 262, 263, 0])


def test_viterbi_fwd_kernel_matches_xla(rng):
    """PhoneLoop.decode (the banded (max,+) route) must give the same
    paths and scores as the dense viterbi on the effective graph."""
    from beer_tpu.ops import semiring_scan

    data, _, mask, _ = make_aud_data(rng, n_seq=5, t_len=40, d=2)
    data = data.astype(np.float32)
    mask = mask.astype(np.float32)
    nset = beer_tpu.NormalSet.create(
        jnp.zeros(2), jnp.eye(2), size=22 * 3, cov_type="diagonal",
        noise_std=0.7, key=jax.random.PRNGKey(4))
    loop = PhoneLoop.create(22, 3, nset)
    for _ in range(2):
        _, loop = vb_step(loop, jnp.asarray(data), mask=jnp.asarray(mask))
    x, m = jnp.asarray(data), jnp.asarray(mask)

    graph = loop._effective_graph()
    llh = loop.modelset.expected_log_likelihood(
        loop.sufficient_statistics(x))
    paths_x, score_x = semiring_scan.viterbi(
        llh, graph.log_trans, graph.log_init, graph.log_final, m)
    paths_k, score_k = loop.decode(x, m)
    np.testing.assert_allclose(np.asarray(score_k), np.asarray(score_x),
                               rtol=1e-5, atol=1e-4)
    valid = np.asarray(m) > 0
    np.testing.assert_array_equal(
        np.asarray(paths_k)[valid], np.asarray(paths_x)[valid])
