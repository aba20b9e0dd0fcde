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
* a numpy input goes to ``device`` or, without one, to the current CUDA
  device: the entry points run on the card unless the caller asks for
  the CPU (``device="cpu"``);
* asking for CUDA (by name or by default) without a usable card raises
  — nothing falls back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "resolve_device",
    "as_tensor",
    "check_use_pallas",
    "enable_x64",
    "x64_enabled",
    "resolve_backend",
    "default_dtype",
]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None):
    """``torch.device`` for `device`, the current CUDA device for
    ``None``; raises ``RuntimeError`` when CUDA is asked for, by name or
    by default, and no card is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {'cuda (the default)' if device is None else device!r}"
            f" requested but torch.cuda.is_available() is False; pass "
            f"device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_tensor(x, dtype, device=None):
    """`x` as a tensor of `dtype`.  A tensor keeps its device (`device`,
    when given, must name the same one); anything else goes to `device`,
    by default the current CUDA device."""
    if isinstance(x, torch.Tensor):
        if device is not None and resolve_device(device) != x.device:
            raise ValueError(
                f"tensor lies on {x.device}, but device={device!r} was "
                f"requested; move it explicitly")
        return x.to(dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=resolve_device(device))


def check_use_pallas(use_pallas, device):
    """The JAX package's ``use_pallas=`` switch, read on `device`.

    ``"auto"``, ``None`` and ``True`` mean what every entry point of the
    port does anyway: the kernels on CUDA, their plain versions on the
    CPU.  ``False`` asks for the plain versions; they are for the CPU,
    so on a CUDA device it raises instead of running them on the card.
    """
    if use_pallas not in ("auto", None, True, False):
        raise ValueError(f"use_pallas must be 'auto', None, True or False, "
                         f"got {use_pallas!r}")
    if use_pallas is False and torch.device(device).type == "cuda":
        raise ValueError(
            "use_pallas=False asks for the plain PyTorch versions, which "
            "are for the CPU; on CUDA the port runs its kernels (pass "
            "use_pallas='auto', or device='cpu' for the plain versions)")


# ---------------------------------------------------------------------------
# The JAX package's precision switches, with their torch meaning
# ---------------------------------------------------------------------------
#
# JAX computes in float32 unless its x64 mode is on; torch has float64 on
# every device and no such mode.  What the switch still decides in torch is
# the default floating dtype of tensors made without one.


def enable_x64(enabled=True):
    """Make float64 (or, with ``enabled=False``, float32) torch's default
    floating dtype (``torch.set_default_dtype``).  Float64 tensors run on
    every device either way."""
    torch.set_default_dtype(torch.float64 if enabled else torch.float32)


def x64_enabled():
    """Whether torch's default floating dtype is float64."""
    return torch.get_default_dtype() == torch.float64


def default_dtype():
    """float64 when :func:`x64_enabled`, else float32 (numpy dtypes)."""
    return np.float64 if x64_enabled() else np.float32


def resolve_backend(dtype):
    """``"torch"`` for every `dtype` numpy knows: unlike JAX without x64
    mode, torch computes float64 itself, so nothing falls back to
    numpy."""
    np.dtype(dtype)
    return "torch"
