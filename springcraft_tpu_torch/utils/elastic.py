"""
Failure detection and elastic recovery for long-running device loops.

Counterpart of ``springcraft_tpu/utils/elastic.py`` (the port's own copy,
in torch's meaning).  The long solves of the port — the Chebyshev outer
loop of ``ops.matfree.lowest_modes_matfree[_gnm]`` and the staged
shift-invert of ``ops.modes.lowest_modes_shift_invert_staged`` — run one
outer iteration at a time from the host, so each iteration boundary is a
recovery point:

* :func:`is_device_failure` — classify an exception as a device failure
  (a CUDA error, torch's ``AcceleratorError``, the JAX runtime's error
  types and message fingerprints) or an ordinary bug;
* :func:`probe_device` — liveness check: a tiny sum on the device, in a
  worker thread with a wall-clock budget;
* :func:`retry_on_failure` — in-process retry for transient faults:
  synchronize and release the CUDA caching allocator's blocks, wait,
  probe, re-invoke;
* :class:`LoopCheckpoint` — atomic ``.npz`` snapshots of a loop carry,
  CUDA tensors fetched to the host (the JAX package's format: a snapshot
  of either package loads in the other);
* :func:`resumable_loop` — the composition: an outer-iteration loop
  with snapshot-on-step and resume-from-disk.

After a sticky CUDA error (an illegal address, a launch failure) the
process's CUDA context is lost: every later call on the card raises, the
probe too, so an in-process retry cannot help.  The recovery is to run
the same call again in a new process, which resumes from the last
snapshot instead of from iteration 0.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time

import numpy as np
import torch

from .config import resolve_device

__all__ = [
    "is_device_failure",
    "probe_device",
    "retry_on_failure",
    "LoopCheckpoint",
    "resumable_loop",
    "DeviceProbeTimeout",
]

# Exception type names that indicate the device / runtime layer failed
# (matched by name, so torch versions without AcceleratorError and the JAX
# package's runtime errors classify alike).
_FAILURE_TYPE_NAMES = frozenset({
    "AcceleratorError",
    "XlaRuntimeError",
    "JaxRuntimeError",
    "PjRtError",
})

# Message fingerprints of device-layer faults that can surface through
# generic RuntimeError/ValueError wrappers (torch before AcceleratorError,
# the port's kernel wrappers: "<entry>: CUDA error <code>: <message>").
_FAILURE_FINGERPRINTS = (
    "CUDA error",
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "INTERNAL",
    "ABORTED",
    "socket closed",
    "connection reset",
    "worker crashed",
    "device or resource busy",
    "failed to execute",
)

# Never device failures: ordinary bugs, and running out of device memory.
# The caching allocator has already released its free blocks and retried
# before it raises OutOfMemoryError, so the same step at the same sizes
# fails again after any wait; the caller decides what to make smaller.
_NEVER_DEVICE_FAILURES = (AssertionError, TypeError, IndexError, KeyError,
                          AttributeError, NameError,
                          torch.cuda.OutOfMemoryError)


class DeviceProbeTimeout(RuntimeError):
    """The device liveness probe did not complete within its budget."""


def is_device_failure(exc):
    """True if ``exc`` looks like a device failure rather than an
    ordinary Python bug.  Deliberately conservative: assertion/type/
    index errors and friends are never classified as device failures,
    so retries cannot mask real bugs; neither is
    ``torch.OutOfMemoryError``, which a retry at the same sizes meets
    again."""
    if isinstance(exc, DeviceProbeTimeout):
        return True
    if isinstance(exc, _NEVER_DEVICE_FAILURES):
        return False
    for klass in type(exc).__mro__:
        if klass.__name__ in _FAILURE_TYPE_NAMES:
            return True
    msg = str(exc)
    return any(f.lower() in msg.lower() for f in _FAILURE_FINGERPRINTS)


def probe_device(timeout=30.0, device=None):
    """Liveness check of `device` (the current CUDA device by default):
    sum ``arange(8)`` there and fetch the result, in a worker thread so a
    hung device cannot hang the caller.  Raises
    :class:`DeviceProbeTimeout` on budget exhaustion; re-raises whatever
    the probe raised (after a sticky CUDA error, the error again)."""
    device = resolve_device(device)
    result = {}

    def _probe():
        try:
            result["value"] = float(
                torch.arange(8.0, device=device).sum())
        except Exception as exc:  # noqa: BLE001 — reported to caller
            result["error"] = exc

    t = threading.Thread(target=_probe, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise DeviceProbeTimeout(
            f"device probe did not return within {timeout:.0f}s")
    if "error" in result:
        raise result["error"]
    if result.get("value") != 28.0:
        raise RuntimeError(
            f"device probe computed {result.get('value')!r}, expected 28.0")


def _release_device_memory():
    """Wait for the card and hand the caching allocator's free blocks
    back (advisory: after a sticky error both raise, and the probe that
    follows reports it)."""
    if not torch.cuda.is_initialized():
        return
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    except Exception:  # noqa: BLE001 — the probe reports a dead device
        pass


def retry_on_failure(fn, *args, retries=2, wait=5.0, probe=True,
                     probe_timeout=30.0, on_retry=None, **kwargs):
    """Call ``fn(*args, **kwargs)``; on a *device* failure
    (:func:`is_device_failure`) synchronize and empty the CUDA caching
    allocator, wait ``wait`` seconds, optionally probe the device, and
    re-invoke — up to ``retries`` times.  Non-device exceptions propagate
    immediately.  `probe`: ``True`` probes the current CUDA device, a
    device (``"cpu"``, ``"cuda:1"``, a ``torch.device``) probes that one,
    ``False`` none.  ``on_retry(attempt, exc)`` is called before each
    retry (for logging)."""
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 — filtered below
            if not is_device_failure(exc) or attempt >= retries:
                raise
            attempt += 1
            if on_retry is not None:
                on_retry(attempt, exc)
            _release_device_memory()
            if wait:
                time.sleep(wait)
            if probe is not False:
                probe_device(probe_timeout,
                             device=None if probe is True else probe)


def _host(value):
    """`value` as a NumPy array (tensors of any device fetched)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class LoopCheckpoint:
    """Atomic ``.npz`` snapshots of a flat loop-carry state.

    The state is a dict of tensors/arrays/scalars (tensors on any device
    are fetched to the host on save and restored as NumPy — the consuming
    step re-places them).  Writes go through a temp file + ``os.replace``
    so a crash mid-write can never leave a truncated snapshot.  The
    layout (the state's keys and ``__iteration__``) is the JAX package's.
    """

    def __init__(self, path, every=1):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.path = str(path)
        self.every = int(every)

    def save(self, iteration, state):
        payload = {"__iteration__": np.asarray(int(iteration))}
        for key, value in state.items():
            if key.startswith("__"):
                raise ValueError(f"state key {key!r} is reserved")
            payload[key] = _host(value)
        directory = os.path.dirname(os.path.abspath(self.path))
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez(fh, **payload)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def load(self):
        """``(iteration, state)`` of the snapshot, or ``None``."""
        if not os.path.exists(self.path):
            return None
        with np.load(self.path) as data:
            iteration = int(data["__iteration__"])
            state = {k: data[k] for k in data.files
                     if k != "__iteration__"}
        return iteration, state

    def clear(self):
        if os.path.exists(self.path):
            os.unlink(self.path)


def _restore(value, shape, dtype, device):
    """A loop carry's array — the tensor the last step returned, or a
    snapshot's NumPy array — as a tensor on `device`.  Raises
    ``ValueError`` unless it has the `shape` and `dtype` the loop
    carries: a snapshot of another call."""
    tensor = torch.as_tensor(value, device=device)
    if tuple(tensor.shape) != tuple(shape) or tensor.dtype != dtype:
        raise ValueError(
            f"the loop carries {dtype} of shape {tuple(shape)}, the "
            f"checkpoint {tensor.dtype} of shape {tuple(tensor.shape)}: "
            f"a snapshot of another call")
    return tensor


def resumable_loop(step, state, n_steps, *, checkpoint=None, stop=None,
                   retries=2, wait=5.0, probe=True, on_retry=None):
    """Run ``state = step(i, state)`` for ``i in range(n_steps)`` with
    elastic recovery.

    ``state`` is a dict of tensors/arrays/scalars.  Each step is wrapped
    in :func:`retry_on_failure` (`probe` as there); if ``checkpoint`` (a
    path or a :class:`LoopCheckpoint`) is given, the state is snapshotted
    every ``checkpoint.every`` completed iterations AND an existing
    snapshot is resumed from — so a process killed at iteration *j*
    restarts at *j*, not 0, with the state as NumPy arrays.  ``stop(state)
    -> bool`` ends the loop early.  The snapshot is cleared once the loop
    returns — either way the caller has its result; a snapshot only
    outlives a *crashed* run.  The loop never snapshots its last
    iteration, so a snapshot at iteration ``>= n_steps`` belongs to
    another loop: ``ValueError``, and the file is left as it is.

    Returns ``(state, completed_iterations)``.
    """
    ckpt = None
    if checkpoint is not None:
        ckpt = (checkpoint if isinstance(checkpoint, LoopCheckpoint)
                else LoopCheckpoint(checkpoint))
    start = 0
    if ckpt is not None:
        snapshot = ckpt.load()
        if snapshot is not None:
            start, state = snapshot
            if start >= n_steps:
                raise ValueError(
                    f"{ckpt.path} holds iteration {start} of a loop of "
                    f"{n_steps} steps, which never snapshots one: a "
                    f"snapshot of another call")
    completed = start
    for i in range(start, n_steps):
        state = retry_on_failure(step, i, state, retries=retries,
                                 wait=wait, probe=probe,
                                 on_retry=on_retry)
        completed = i + 1
        if stop is not None and stop(state):
            break
        if (ckpt is not None and completed % ckpt.every == 0
                and completed < n_steps):
            ckpt.save(completed, state)
    if ckpt is not None:
        ckpt.clear()
    return state, completed
