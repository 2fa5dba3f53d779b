"""Test configuration.

Tests run on CPU with 8 virtual devices (so multi-device sharding paths
are exercised without accelerators, per SURVEY.md §4) and with x64
enabled so float64 scipy oracles can be matched tightly.  Tests that can
only run on a GPU carry the ``chip`` marker and skip here; ``python
chip_smoke.py`` covers them on the card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture(autouse=True)
def _chip_only(request):
    """Tests marked ``chip`` skip unless JAX finds a GPU — decided at run
    time, never at import, so every xdist worker collects the same
    tests."""
    if request.node.get_closest_marker("chip") and \
            jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; `python chip_smoke.py` covers it there")
