"""Test configuration.

The suite runs on the host CPU: ``JAX_PLATFORMS=cpu python -m pytest tests/``.
Eight virtual CPU devices are requested before the CPU backend starts, for
the multi-device sharding tests.

Tests that need the card carry the ``gpu`` marker (registered in
pyproject.toml). Whether a GPU is present is decided inside the autouse
fixture below, while the test runs — never at import or collection, so every
xdist worker collects the same tests. On the card:
``python -m pytest tests/test_on_card.py``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip a ``gpu``-marked test unless JAX's default backend is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; on the card run "
                    "`python -m pytest tests/test_on_card.py`")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def cpu_mesh_devices():
    """8 virtual CPU devices for multi-device sharding tests."""
    devs = jax.devices("cpu")
    assert len(devs) >= 8, "expected 8 virtual CPU devices (XLA_FLAGS)"
    return devs[:8]
