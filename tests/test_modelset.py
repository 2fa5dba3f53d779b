"""ModelSet composition (Joint / Repeated) + mean-field coordinate ascent.

Reference parity: ``beer/models/modelset.py`` (JointModelSet,
RepeatedModelSet) and the reference's ``mean_field_factorization``-driven
coordinate ascent (``VBConjugateOptimizer`` group scheduling).
"""

import numpy as np
import jax
import jax.numpy as jnp

import beer_tpu
from beer_tpu.models.modelset import JointModelSet, RepeatedModelSet
from beer_tpu.vbi import vb_step, vb_step_coordinate


def _data(rng, n=300):
    means = np.array([[-3.0, 0.0], [3.0, 1.0], [0.0, -3.0]])
    return jnp.asarray(
        np.concatenate([rng.normal(m, 0.5, size=(n, 2)) for m in means]),
        jnp.float32,
    )


def _nset(size, cov_type="diagonal", key=0):
    return beer_tpu.NormalSet.create(
        jnp.zeros(2), jnp.eye(2), size=size, cov_type=cov_type,
        noise_std=1.0, key=jax.random.PRNGKey(key),
    )


def test_joint_modelset_in_mixture(rng):
    """A mixture over the concatenation of two NormalSets trains, and its
    ELLH columns equal the members' columns."""
    x = _data(rng)
    a, b = _nset(2, key=1), _nset(3, key=2)
    joint = JointModelSet.create([a, b])
    assert len(joint) == 5
    stats = joint.sufficient_statistics(x)
    ellh = joint.expected_log_likelihood(stats)
    np.testing.assert_allclose(
        np.asarray(ellh[:, :2]), np.asarray(a.expected_log_likelihood(stats)),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(ellh[:, 2:]), np.asarray(b.expected_log_likelihood(stats)),
        rtol=1e-6,
    )
    gmm = beer_tpu.Mixture.create(joint)
    elbos = []
    model = gmm
    step = jax.jit(vb_step)
    for _ in range(20):
        elbo, model = step(model, x)
        elbos.append(float(elbo) / len(x))
    assert np.isfinite(elbos).all()
    assert np.all(np.diff(elbos) > -1e-5), "joint-set VB-EM not monotone"


def test_repeated_modelset_shares_parameters(rng):
    """Repeats tile the ELLH and fold responsibilities onto the base."""
    x = _data(rng)
    base = _nset(3, key=3)
    rep = RepeatedModelSet.create(base, repeats=2)
    assert len(rep) == 6
    stats = rep.sufficient_statistics(x)
    ellh = rep.expected_log_likelihood(stats)
    np.testing.assert_allclose(
        np.asarray(ellh[:, :3]), np.asarray(ellh[:, 3:]), rtol=1e-7
    )
    # accumulate with resps split across the two repeats == all resps on one
    resps = jax.nn.softmax(ellh, axis=-1)
    acc = rep.accumulate(stats, resps)
    folded = resps[:, :3] + resps[:, 3:]
    acc_ref = base.accumulate(stats, folded)
    np.testing.assert_allclose(
        np.asarray(acc["means_precisions"]),
        np.asarray(acc_ref["means_precisions"]), rtol=1e-6,
    )
    # trains inside a mixture
    model = beer_tpu.Mixture.create(rep)
    step = jax.jit(vb_step)
    elbos = []
    for _ in range(15):
        elbo, model = step(model, x)
        elbos.append(float(elbo) / len(x))
    assert np.isfinite(elbos).all()
    assert elbos[-1] > elbos[0]


def test_coordinate_ascent_mixture_monotone(rng):
    """vb_step_coordinate over the Mixture's two mean-field groups climbs
    monotonically (each group update is exact coordinate ascent)."""
    x = _data(rng)
    gmm = beer_tpu.Mixture.create(_nset(6, key=4))
    assert gmm.mean_field_factorization() == [["categorical"], ["modelset"]]
    model = gmm
    elbos = []
    step = jax.jit(lambda m, x: vb_step_coordinate(m, x))
    for _ in range(15):
        elbo, model = step(model, x)
        elbos.append(float(elbo) / len(x))
    assert np.isfinite(elbos).all()
    assert np.all(np.diff(elbos) > -1e-5), f"not monotone: {elbos}"
    # coordinate ascent must reach at least the joint update's quality
    joint, jelbos = gmm, []
    jstep = jax.jit(vb_step)
    for _ in range(15):
        e, joint = jstep(joint, x)
        jelbos.append(float(e) / len(x))
    assert elbos[-1] > jelbos[-1] - 0.05


def test_coordinate_ascent_phone_loop(rng):
    """Phone-loop groups (emissions | unit prior) climb monotonically."""
    from beer_tpu.models.phoneloop import PhoneLoop

    x = jnp.asarray(rng.normal(size=(6, 30, 2)), jnp.float32)
    mask = jnp.ones((6, 30), jnp.float32)
    loop = PhoneLoop.create(3, 2, _nset(6, key=5))
    assert loop.mean_field_factorization() == [["modelset"], ["unit_prior"]]
    step = jax.jit(lambda m, x, msk: vb_step_coordinate(m, x, mask=msk))
    elbos = []
    model = loop
    for _ in range(10):
        elbo, model = step(model, x, mask)
        elbos.append(float(elbo))
    assert np.isfinite(elbos).all()
    assert np.all(np.diff(elbos) > -1e-3), f"not monotone: {elbos}"


def test_joint_modelset_rejects_layout_mismatch(rng):
    """A full-cov + diag-cov mix scores the wrong stats layout silently —
    create() must reject it up front."""
    import pytest

    with pytest.raises(ValueError, match="layout"):
        JointModelSet.create([_nset(2, "diagonal"), _nset(2, "full")])
    # same layout still composes
    js = JointModelSet.create([_nset(2, "diagonal", key=0),
                               _nset(3, "diagonal", key=1)])
    assert len(js) == 5
