"""Device, dtype and precision configuration, profiling and small shared
utilities of the PyTorch port (counterpart of ``springcraft_tpu/utils``;
its elastic loop, ``utils/elastic.py``, is not ported yet)."""

from . import profiling
from .config import default_dtype, enable_x64, resolve_backend, x64_enabled
from .profiling import Timer, synchronize, timed

__all__ = [
    "enable_x64",
    "x64_enabled",
    "resolve_backend",
    "default_dtype",
    "profiling",
    "Timer",
    "synchronize",
    "timed",
]
