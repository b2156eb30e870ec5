"""Tracing / profiling utilities.

The reference's observability is txid-prefixed wall-time logs and mpb
progress bars (SURVEY.md §5). Here: the same per-request timing logs
(logger.next_txid + engine logs), plus device-level tracing via
jax.profiler — traces open in XProf/TensorBoard.
"""
from __future__ import annotations

import contextlib
import time

from ..logger import sugar


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.cache/jax (the
    path is derived from this file, so it follows the checkout)."""
    import os

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
    return os.path.join(repo_root, ".cache", "jax")


def enable_compile_cache() -> None:
    """Persistent XLA compile cache in compile_cache_dir(), so a process
    that repeats another's compiles starts in seconds. Config only (no
    device is touched): safe before jax.distributed.initialize."""
    import jax

    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace (device timeline, HLO, memory) to log_dir."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        sugar().info("device trace written to %s", log_dir)


@contextlib.contextmanager
def timed(label: str):
    """Wall-time a block at info level (reference logs per-request ms,
    server/search.go:111)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sugar().info("%s took %.1fms", label, (time.perf_counter() - t0) * 1e3)


def device_memory_stats() -> list[dict]:
    """Per-device memory stats where the backend exposes them."""
    import jax

    out = []
    for dev in jax.devices():
        stats = {}
        try:
            stats = dict(dev.memory_stats() or {})
        except Exception:
            pass
        out.append({"device": str(dev), **stats})
    return out
