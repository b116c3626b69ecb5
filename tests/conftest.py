"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Sharded code paths are exercised on fake CPU devices (SURVEY.md §4
"Multi-chip without a cluster").  XLA_FLAGS must be set before the
first CPU client is created, and the platform override goes through
jax.config as well as the environment.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and the ``gpu``
fixture below, which skips them on any other backend; run them on the
card with ``python -m pytest tests/ -m gpu`` (without
``JAX_PLATFORMS=cpu``).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
if not os.environ.get("BST_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

if not os.environ.get("BST_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")
# The persistent compile cache stays OFF under pytest: CLI tests call
# cli.main in-process, which would point jax_compilation_cache_dir at
# the checkout's cache for the rest of the suite.  CPU test compiles
# are fast.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first JAX device, when it is an NVIDIA GPU; skips otherwise.

    Decided here, at test time, never at import: every xdist worker
    must collect the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX platform is {dev.platform})")
    return dev
