"""
Device, dtype and precision configuration for the PyTorch port.

Counterpart of ``springcraft_tpu/utils/config.py``.  Importing this
module (which the package does on import) pins float32 matrix products
to full IEEE float32: TF32 keeps only about three decimal digits, the
Hopper form of the bf16 hazard that the JAX package guards against with
``precision='highest'`` on every contraction.

Device rules shared by every public entry point of the port:

* a tensor input keeps its own device; passing a different ``device``
  raises instead of moving it silently;
* a numpy input needs ``device`` passed explicitly;
* asking for ``"cuda"`` without a usable card raises — nothing falls
  back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "resolve_device",
    "as_tensor",
    "synchronize",
]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device):
    """``torch.device`` for `device`; raises when CUDA is asked for and
    no card is available."""
    if device is None:
        raise ValueError("device must be given explicitly, e.g. 'cuda' "
                         "or 'cpu'")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            f"is False")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_tensor(x, dtype, device=None):
    """`x` as a tensor of `dtype`.  A tensor keeps its device (`device`,
    when given, must name the same one); anything else needs
    `device`."""
    if isinstance(x, torch.Tensor):
        if device is not None and resolve_device(device) != x.device:
            raise ValueError(
                f"tensor lies on {x.device}, but device={device!r} was "
                f"requested; move it explicitly")
        return x.to(dtype=dtype)
    if device is None:
        raise ValueError(
            "a non-tensor input needs device= (e.g. 'cuda' or 'cpu')")
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=resolve_device(device))


def synchronize(device=None):
    """Wait for all work queued on the current CUDA device, or on
    `device` (a no-op for a CPU device)."""
    if device is None:
        torch.cuda.synchronize()
    elif torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
