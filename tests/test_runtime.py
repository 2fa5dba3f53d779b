"""Process set-up (device choice, compile cache), the pytree dataclass
helper, flax-free checkpoints, and a main path that imports without the
optional packages."""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from beer_tpu.utils import runtime, struct

REPO = Path(__file__).resolve().parents[1]


# ----------------------------------------------------------------------
# devices and the compile cache
# ----------------------------------------------------------------------
def test_device_gpu_fails_without_gpu():
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.select_device("gpu")


def test_device_auto_keeps_platform(monkeypatch):
    """``auto`` touches no configuration: nothing probes, nothing falls
    back."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    runtime.select_device("auto")
    assert calls == []


def test_device_cpu_pins_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    runtime.select_device("cpu")
    assert calls == [("jax_platforms", "cpu")]


def test_device_unknown_rejected():
    with pytest.raises(ValueError):
        runtime.select_device("metal")


def test_cli_rejects_unknown_device():
    from beer_tpu.cli.main import main as cli

    with pytest.raises(SystemExit):
        cli(["hmm", "mkphones", "x", "y", "--device", "metal"])


def test_compile_cache_env_left_to_jax(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert runtime.setup_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_defaults_to_checkout(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    expected = str(REPO / ".jax_cache")
    assert runtime.setup_compile_cache() == expected
    assert calls == [("jax_compilation_cache_dir", expected)]


# ----------------------------------------------------------------------
# the struct helper
# ----------------------------------------------------------------------
@struct.dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray
    n: int = struct.field(pytree_node=False, default=3)


@struct.dataclass
class _Child(_Pair):
    c: jnp.ndarray = None


def test_struct_flatten_roundtrip():
    p = _Pair(jnp.ones(2), jnp.zeros(3), n=5)
    leaves, treedef = jax.tree.flatten(p)
    assert len(leaves) == 2
    q = jax.tree.unflatten(treedef, leaves)
    assert q.n == 5 and np.array_equal(q.a, p.a)
    c = _Child(jnp.ones(1), jnp.ones(1), c=jnp.zeros(4))
    assert len(jax.tree.leaves(c)) == 3


def test_struct_static_field_in_treedef():
    """Static fields are tree metadata: they split the structure and
    never become traced leaves."""
    s1 = jax.tree.structure(_Pair(jnp.ones(2), jnp.ones(2), n=1))
    s2 = jax.tree.structure(_Pair(jnp.ones(2), jnp.ones(2), n=2))
    assert s1 != s2
    doubled = jax.tree.map(lambda x: 2 * x, _Pair(jnp.ones(2), jnp.ones(2)))
    assert doubled.n == 3


def test_struct_replace_and_frozen():
    p = _Pair(jnp.ones(2), jnp.zeros(2))
    q = p.replace(b=jnp.ones(2), n=7)
    assert q.n == 7 and float(q.b.sum()) == 2.0 and float(p.b.sum()) == 0.0
    with pytest.raises(Exception):
        p.a = jnp.zeros(2)


def test_struct_jit_over_model():
    """A model is a pytree value under jit: arrays trace, static fields
    stay Python values."""
    import beer_tpu
    from beer_tpu.models.phoneloop import PhoneLoop

    nset = beer_tpu.NormalSet.create(
        jnp.zeros(2), jnp.ones(2), size=6, cov_type="diagonal",
        key=jax.random.PRNGKey(0))
    loop = PhoneLoop.create(2, 3, nset)

    @jax.jit
    def f(m):
        assert isinstance(m.n_units, int)
        return m.replace(base_log_trans=m.base_log_trans * 0.5)

    out = f(loop)
    assert out.n_units == 2 and out.states_per_unit == 3
    np.testing.assert_allclose(out.base_log_trans,
                               loop.base_log_trans * 0.5)


# ----------------------------------------------------------------------
# checkpoints and imports without the optional packages
# ----------------------------------------------------------------------
_BLOCK = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("flax", "yaml", "torch"):
            raise ModuleNotFoundError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, _Block())
"""


def _run_blocked(body, tmp_path):
    script = tmp_path / "blocked.py"
    script.write_text(_BLOCK + textwrap.dedent(body))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, str(script)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_main_path_imports_without_flax_yaml_torch(tmp_path):
    out = _run_blocked("""
        import jax, jax.numpy as jnp
        import beer_tpu, beer_tpu.cli.main
        from beer_tpu.vbi import vb_step
        from beer_tpu.models.phoneloop import PhoneLoop
        nset = beer_tpu.NormalSet.create(
            jnp.zeros(3), jnp.ones(3), size=6, cov_type="diagonal")
        loop = PhoneLoop.create(2, 3, nset)
        x = jax.random.normal(jax.random.PRNGKey(0), (2, 8, 3))
        elbo, loop = jax.jit(vb_step)(loop, x, mask=jnp.ones((2, 8)))
        assert jnp.isfinite(elbo)
        assert not any(m.split(".")[0] in ("flax", "yaml", "torch")
                       for m in sys.modules)
        print("ok", float(elbo))
    """, tmp_path)
    assert out.startswith("ok")


def test_checkpoint_roundtrip_without_flax(tmp_path):
    out = _run_blocked(f"""
        import jax, jax.numpy as jnp, numpy as np
        import beer_tpu
        from beer_tpu.models.phoneloop import PhoneLoop
        from beer_tpu.utils import load_model, save_model
        nset = beer_tpu.NormalSet.create(
            jnp.zeros(3), jnp.ones(3), size=6, cov_type="diagonal")
        loop = PhoneLoop.create(2, 3, nset)
        save_model(loop, {str(tmp_path / "m.mdl")!r})
        back = load_model({str(tmp_path / "m.mdl")!r})
        assert type(back) is PhoneLoop and back.n_units == 2
        for a, b in zip(jax.tree.leaves(loop), jax.tree.leaves(back)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        print("ok")
    """, tmp_path)
    assert out.startswith("ok")


def test_checkpoint_payload_is_numpy(tmp_path):
    """The arrays travel as an ``np.savez`` archive beside the pickled
    skeleton; ``None`` fields survive."""
    import io

    import beer_tpu
    from beer_tpu.models.phoneloop import PhoneLoop
    from beer_tpu.utils import load_model, save_model

    nset = beer_tpu.NormalSet.create(
        jnp.zeros(2), jnp.ones(2), size=4, cov_type="diagonal")
    loop = PhoneLoop.create(2, 2, nset)
    assert loop.log_exit is None
    path = tmp_path / "m.mdl"
    save_model(loop, path)
    payload = pickle.loads(path.read_bytes())
    with np.load(io.BytesIO(payload["arrays"])) as arrays:
        assert len(arrays.files) == len(jax.tree.leaves(loop))
    back = load_model(path)
    assert back.log_exit is None
