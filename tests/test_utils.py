"""Stats/profiling utilities + engine stats endpoint."""
import numpy as np
import pytest

from vectorsearch_tpu.utils import device_memory_stats, timed


def test_device_memory_stats_shape():
    out = device_memory_stats()
    assert isinstance(out, list) and out
    assert "device" in out[0]


def test_timed_runs():
    with timed("unit-test block"):
        np.zeros(10).sum()


@pytest.mark.parametrize("env", [None, "elsewhere"])
def test_compile_cache_dir_follows_env(monkeypatch, tmp_path, env):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache lives
    in the checkout's .cache/jax, wherever the checkout is."""
    import os

    from vectorsearch_tpu.utils import profiling

    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert profiling.compile_cache_dir() == os.path.join(root, ".cache", "jax")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / env))
        assert profiling.compile_cache_dir() == str(tmp_path / env)


def test_compile_cache_env_is_the_only_directory_written(tmp_path):
    """A process with JAX_COMPILATION_CACHE_DIR set writes its compiled
    programs there and creates no cache at the checkout's default path."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    checkout = tmp_path / "checkout"
    checkout.mkdir()
    os.symlink(os.path.join(root, "vectorsearch_tpu"), checkout / "vectorsearch_tpu")
    cache = tmp_path / "cache"
    script = (
        "import jax, jax.numpy as jnp\n"
        "from vectorsearch_tpu.utils import enable_compile_cache\n"
        "enable_compile_cache()\n"
        "jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)\n"
        "print(jax.jit(lambda x: x * 3 + 1)(jnp.arange(7.0)).sum())\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(cache))
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=checkout, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert cache.is_dir() and any(cache.iterdir())
    assert not (checkout / ".cache").exists()
