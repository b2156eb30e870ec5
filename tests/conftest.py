"""Test harness: an 8-device virtual CPU mesh, set up before JAX is
imported, so every sharding and collective test runs without a cluster.

The tests run on the CPU (JAX_PLATFORMS=cpu unless the caller chose a
platform). Tests marked `gpu` need an NVIDIA card and skip elsewhere; on a
GPU machine run them with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from vectorsearch_tpu.utils import enable_compile_cache  # noqa: E402

# persistent compile cache: XLA:CPU compiles of the scan kernels dominate
# test time; cache them across runs and worker processes
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is an NVIDIA GPU (decided here,
    at run time, never while test modules are imported)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")
    return jax.devices()[0]
