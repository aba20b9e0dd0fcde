"""Device, dtype and precision configuration, profiling, the elastic
loop of the long solvers and small shared utilities of the PyTorch port
(counterpart of ``springcraft_tpu/utils``)."""

from . import elastic, profiling
from .config import default_dtype, enable_x64, resolve_backend, x64_enabled
from .elastic import LoopCheckpoint, resumable_loop, retry_on_failure
from .profiling import Timer, synchronize, timed

__all__ = [
    "enable_x64",
    "x64_enabled",
    "resolve_backend",
    "default_dtype",
    "elastic",
    "LoopCheckpoint",
    "resumable_loop",
    "retry_on_failure",
    "profiling",
    "Timer",
    "synchronize",
    "timed",
]
