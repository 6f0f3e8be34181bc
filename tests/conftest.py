"""Test configuration: JAX on the CPU with 8 virtual devices.

JAX_PLATFORMS=cpu is set before the first backend use, so the suite runs on
the CPU even on a machine with a GPU; 8 virtual host devices let the
sharded engine (sphjax.dist) run real collectives without several cards
(SURVEY.md §4e). Tests that need a GPU carry the `gpu` marker and skip
here (see the `gpu_device` fixture).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
if os.environ.get("SPHJAX_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

import pytest  # noqa: E402

from sphjax.core.config import default_config  # noqa: E402


@pytest.fixture(scope="session")
def small_cfg():
    """512 particles, small chunks — fast on CPU."""
    return default_config(512, chunk_size=512, window_capacity=48)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip — decided when the test runs, never at
    import. On the card: `SPHJAX_TEST_GPU=1 python -m pytest -m gpu tests/`
    (the variable leaves the platform choice to JAX)."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU (run with SPHJAX_TEST_GPU=1 on the card)")
    return gpus[0]


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices("cpu")
    assert len(devs) >= 8, f"expected 8 virtual CPU devices, got {len(devs)}"
    return devs[:8]
