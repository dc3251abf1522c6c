"""Test configuration: an 8-device virtual CPU mesh, set BEFORE jax init.

The suite runs on the CPU (`JAX_PLATFORMS=cpu`, the default here).  Tests
marked `gpu` need an NVIDIA card; they take the `gpu` fixture, which skips
at test time when JAX's devices are not GPUs.  On a card:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)


import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The JAX devices, when they are GPUs; otherwise skip the test."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")
    return devs


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """XLA:CPU has segfaulted once a single process accumulated a few
    hundred compiled programs (the full suite in one process died inside
    backend_compile_and_load while every file passed alone).  Dropping the
    compiled-computation caches between modules bounds the accumulation;
    the lost cache hits cost a few extra small compiles per module."""
    yield
    jax.clear_caches()
