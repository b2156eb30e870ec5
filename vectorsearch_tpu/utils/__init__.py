from .errors import fresh_exc  # noqa: F401
from .profiling import (
    compile_cache_dir,
    device_memory_stats,
    device_trace,
    enable_compile_cache,
    timed,
)

__all__ = [
    "compile_cache_dir",
    "device_memory_stats",
    "device_trace",
    "enable_compile_cache",
    "timed",
]
