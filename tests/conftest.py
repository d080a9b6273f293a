"""Test harness config.

Tier-1 runs with ``JAX_PLATFORMS=cpu``: multi-device sharding paths are then
validated on 8 virtual CPU devices (``xla_force_host_platform_device_count``).
Elsewhere the platform is left to JAX, so the suite also runs on a machine
with a card, where ``chip_smoke.py`` runs the tests marked ``gpu``.
"""
import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)

if os.environ.get("JAX_PLATFORMS") == "cpu":
    assert jax.default_backend() == "cpu"
    assert jax.device_count() == 8, jax.devices()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (run on the card by chip_smoke.py)"
    )


@pytest.fixture
def gpu():
    """Skip the test unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run on the card by chip_smoke.py")
