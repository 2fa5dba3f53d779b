"""Sequence-parallel forward vs the single-device scan (8-dev CPU mesh)."""

import numpy as np
import jax
import jax.numpy as jnp

from beer_tpu import parallel
from beer_tpu.ops import semiring_scan, seq_parallel
from tests.test_hmm import random_hmm_params


def test_time_sharded_forward_matches(rng):
    b, t_len, s = 3, 64, 5  # t divisible by 8 devices
    lt, li, lf = random_hmm_params(rng, s)
    llh = rng.normal(size=(b, t_len, s))
    lengths = np.array([64, 40, 21])
    mask = (np.arange(t_len)[None] < lengths[:, None]).astype(np.float64)

    mesh = parallel.make_mesh(axis_name="seq")
    fn = seq_parallel.make_sharded_forward(mesh)
    la_sh, lz_sh = fn(
        jnp.asarray(llh), jnp.asarray(lt), jnp.asarray(li), jnp.asarray(lf),
        jnp.asarray(mask),
    )

    la_ref, _ = semiring_scan.forward(
        jnp.asarray(llh), jnp.asarray(lt), jnp.asarray(li), jnp.asarray(mask)
    )
    fb = semiring_scan.forward_backward(
        jnp.asarray(llh), jnp.asarray(lt), jnp.asarray(li), jnp.asarray(lf),
        jnp.asarray(mask),
    )
    for i, ln in enumerate(lengths):
        np.testing.assert_allclose(
            np.asarray(la_sh[i, :ln]), np.asarray(la_ref[i, :ln]), rtol=1e-8
        )
    np.testing.assert_allclose(np.asarray(lz_sh), np.asarray(fb.log_z), rtol=1e-8)


def test_time_sharded_forward_backward_matches(rng):
    b, t_len, s = 2, 64, 4
    lt, li, lf = random_hmm_params(rng, s)
    llh = rng.normal(size=(b, t_len, s))
    lengths = np.array([64, 30])
    mask = (np.arange(t_len)[None] < lengths[:, None]).astype(np.float64)

    mesh = parallel.make_mesh(axis_name="seq")
    fn = seq_parallel.make_sharded_forward_backward(mesh)
    la, lb, lz, post = fn(
        jnp.asarray(llh), jnp.asarray(lt), jnp.asarray(li), jnp.asarray(lf),
        jnp.asarray(mask),
    )
    fb = semiring_scan.forward_backward(
        jnp.asarray(llh), jnp.asarray(lt), jnp.asarray(li), jnp.asarray(lf),
        jnp.asarray(mask),
    )
    np.testing.assert_allclose(np.asarray(lz), np.asarray(fb.log_z), rtol=1e-8)
    for i, ln in enumerate(lengths):
        np.testing.assert_allclose(
            np.asarray(lb[i, :ln]), np.asarray(fb.log_beta[i, :ln]), rtol=1e-7,
            atol=1e-8,
        )
        np.testing.assert_allclose(
            np.asarray(post[i, :ln]), np.asarray(fb.posteriors[i, :ln]),
            rtol=1e-6, atol=1e-9,
        )


def test_2d_mesh_data_and_time_sharded(rng):
    """dp x sp: batch sharded over 'data', time over 'seq', one shard_map."""
    from functools import partial
    from jax.sharding import Mesh, PartitionSpec as P

    b, t_len, s = 4, 32, 4
    lt, li, lf = random_hmm_params(rng, s)
    llh = rng.normal(size=(b, t_len, s))
    lengths = np.array([32, 20, 9, 28])
    mask = (np.arange(t_len)[None] < lengths[:, None]).astype(np.float64)

    devices = np.asarray(jax.devices()).reshape(2, 4)
    mesh = Mesh(devices, ("data", "seq"))

    @jax.jit
    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("data", "seq"), P(), P(), P(), P("data", "seq")),
        out_specs=(P("data", "seq"), P("data")),
        check_vma=False,
    )
    def fn(llh, log_trans, log_init, log_final, mask):
        _, _, log_z, post = seq_parallel.forward_backward_time_sharded(
            llh, log_trans, log_init, log_final, mask, "seq"
        )
        return post, log_z

    post, lz = fn(
        jnp.asarray(llh), jnp.asarray(lt), jnp.asarray(li), jnp.asarray(lf),
        jnp.asarray(mask),
    )
    fb = semiring_scan.forward_backward(
        jnp.asarray(llh), jnp.asarray(lt), jnp.asarray(li), jnp.asarray(lf),
        jnp.asarray(mask),
    )
    np.testing.assert_allclose(np.asarray(lz), np.asarray(fb.log_z), rtol=1e-8)
    np.testing.assert_allclose(
        np.asarray(post), np.asarray(fb.posteriors), rtol=1e-6, atol=1e-9
    )


def test_2d_mesh_bench_shape(rng):
    """dp x sp at the BENCH shape (S=150 phone-loop graph, T=200) with
    ragged mask edges inside and exactly on every seq-block boundary —
    the shape-dependent sharding regime the toy cases can't reach."""
    from functools import partial
    from jax.sharding import Mesh, PartitionSpec as P

    from beer_tpu.models import graph as graph_mod

    cg = graph_mod.phone_loop_graph(50, 3).compile(jnp.float64)
    s = cg.n_states
    assert s == 150
    b, t_len = 8, 200
    llh = rng.normal(size=(b, t_len, s))
    # 4 seq blocks of 50 frames: edges strictly inside each block, on
    # the exact boundaries, and one block fully masked out
    lengths = np.array([200, 151, 150, 149, 101, 100, 51, 26])
    mask = (np.arange(t_len)[None] < lengths[:, None]).astype(np.float64)

    devices = np.asarray(jax.devices()).reshape(2, 4)
    mesh = Mesh(devices, ("data", "seq"))

    @jax.jit
    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("data", "seq"), P(), P(), P(), P("data", "seq")),
        out_specs=(P("data", "seq"), P("data")),
        check_vma=False,
    )
    def fn(llh, log_trans, log_init, log_final, mask):
        _, _, log_z, post = seq_parallel.forward_backward_time_sharded(
            llh, log_trans, log_init, log_final, mask, "seq"
        )
        return post, log_z

    post, lz = fn(
        jnp.asarray(llh), cg.log_trans, cg.log_init, cg.log_final,
        jnp.asarray(mask),
    )
    fb = semiring_scan.forward_backward(
        jnp.asarray(llh), cg.log_trans, cg.log_init, cg.log_final,
        jnp.asarray(mask),
    )
    np.testing.assert_allclose(np.asarray(lz), np.asarray(fb.log_z), rtol=1e-8)
    for i, ln in enumerate(lengths):
        np.testing.assert_allclose(
            np.asarray(post[i, :ln]), np.asarray(fb.posteriors[i, :ln]),
            rtol=1e-6, atol=1e-9,
        )


def test_time_sharded_with_sparse_graph(rng):
    """Phone-loop-like sparse transitions (LOG_ZERO arcs) stay finite."""
    from beer_tpu.models import graph as graph_mod

    cg = graph_mod.phone_loop_graph(4, 2).compile(jnp.float64)
    s = cg.n_states
    b, t_len = 2, 32
    llh = rng.normal(size=(b, t_len, s))
    mask = np.ones((b, t_len))
    mask[1, 20:] = 0

    mesh = parallel.make_mesh(axis_name="seq")
    fn = seq_parallel.make_sharded_forward_backward(mesh)
    la, lb, lz, post = fn(
        jnp.asarray(llh), cg.log_trans, cg.log_init, cg.log_final,
        jnp.asarray(mask),
    )
    fb = semiring_scan.forward_backward(
        jnp.asarray(llh), cg.log_trans, cg.log_init, cg.log_final,
        jnp.asarray(mask),
    )
    np.testing.assert_allclose(np.asarray(lz), np.asarray(fb.log_z), rtol=1e-8)
    np.testing.assert_allclose(
        np.asarray(post[0]), np.asarray(fb.posteriors[0]), rtol=1e-6, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(post[1, :20]), np.asarray(fb.posteriors[1, :20]),
        rtol=1e-6, atol=1e-9,
    )
