"""Test configuration.

On the CPU, JAX gets 8 virtual devices so the mesh tests have a mesh.
Tests that need an NVIDIA GPU carry the ``chip`` marker and take the
``gpu`` fixture, which skips them elsewhere; ``python chip_smoke.py``
runs what they cover on the card.  Device decisions are made inside
fixtures, never while a test module is imported.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()


@pytest.fixture
def gpu():
    """The JAX GPU backend, or skip."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (python chip_smoke.py runs this "
                    "on the card)")
    return jax.devices()[0]


@pytest.fixture
def devices8():
    """Eight JAX devices, or skip."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return jax.devices()[:8]
