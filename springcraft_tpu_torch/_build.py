"""
Build, load and call the port's hand-written CUDA kernels.

Each source under ``csrc/`` compiles with its own ``nvcc``, all started
together, and the objects link into ONE shared library with a plain C
interface, named by a hash of the sources and flags and placed under
``build/kernels/`` at the root of the checkout (``.gitignore`` lists
it).  The library is built on first use and
loaded with :mod:`ctypes`; every pointer and the stream pass as
``c_void_p``.  Each C entry point launches on the stream it is given
and returns ``cudaGetLastError()``; :func:`launch` passes PyTorch's
current stream and turns a non-zero code into an exception.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

__all__ = ["NVCC_FLAGS", "SOURCES", "library_path", "load", "build_log",
           "route", "require_cuda_f32", "launch"]

_PKG = pathlib.Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
_LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
#: Register/spill report, written to the build log beside the library.
_REPORT_FLAGS = ("-Xptxas", "-v")

SOURCES = tuple(sorted(_CSRC.glob("*.cu")))
_HEADERS = tuple(sorted(_CSRC.glob("*.cuh")))

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double

#: C entry points and their argument types.
_SIGNATURES = {
    # coords, out, batch, n, kind, cutoff_sq, has_cutoff, tables, edges_sq,
    # atom_code, n_bins, n_edges, stream: one signature for the three
    # assembly entries, the last five read only by the tabulated family
    "sc_hessian_planes": (_P, _P, _I, _I, _I, _F, _I, _P, _P, _P, _I, _I, _P),
    "sc_hessian_xyz": (_P, _P, _I, _I, _I, _F, _I, _P, _P, _P, _I, _I, _P),
    "sc_kirchhoff": (_P, _P, _I, _I, _I, _F, _I, _P, _P, _P, _I, _I, _P),
    # coords, row_sums, batch, n, kind, cutoff_sq, has_cutoff, stream
    "sc_assembly_row_sums": (_P, _P, _I, _I, _I, _F, _I, _P),
    # coords, scale_h, ts, row_sums, out, batch, n, mp, kind, cutoff_sq,
    # has_cutoff, stream
    "sc_assembly_stitch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    # planes, scale_h, ts, out, batch, n, mp, stream
    "sc_regularize_stitch": (_P, _P, _P, _P, _I, _I, _I, _P),
    # panels, out, count, pb, stream
    "sc_panel_inverse": (_P, _P, _I, _I, _P),
    "sc_panel_inverse_full": (_P, _P, _I, _I, _P),
    "sc_panel_cholesky": (_P, _P, _I, _I, _P),
    # feed, lo, hi, counts, out, batch, n, w, n_iter, levels, stream
    "sc_banded_bisect": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # feed, shifts, pivot_floor, checkpoints, checkpoint_len, x_scratch,
    # out, batch, n, w, n_shifts, idx0, n_solves, seed, stream
    "sc_banded_eigvec": (_P, _P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I, _I,
                         _D, _P),
    # coords, ids, tile_ptr, col_tiles, counts, n, tile, kind, cutoff_sq,
    # has_cutoff, tables, edges_sq, atom_code (by slot), n_bins, n_edges,
    # stream
    "sc_pair_csr_count": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P, _P,
                          _P, _I, _I, _P),
    # coords, ids, tile_ptr, col_tiles, offsets, slots, k, then as
    # sc_pair_csr_count from n on
    "sc_pair_csr_fill": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                         _P, _P, _P, _I, _I, _P),
    # coords, row_ptr, slots, k, x, out, n, k columns, stream
    "sc_hessian_apply_pairs": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    # row_ptr, slots, k, x, out, n, k columns, stream
    "sc_kirchhoff_apply_pairs": (_P, _P, _P, _P, _P, _I, _I, _P),
    # coords, x, out, n, k, row_start, n_rows, kind, cutoff_sq, has_cutoff,
    # tables, edges_sq, atom_code, n_bins, n_edges, stream
    "sc_hessian_apply_dense": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P, _P,
                               _P, _I, _I, _P),
    # l, ldl, m, src, src row stride, src column stride, b, scale, part,
    # work, dst, dst row stride, ws, forward, f64, stream
    "sc_chol_solve": (_P, _L, _I, _P, _L, _L, _I, _P, _P, _P, _P, _L, _P, _I,
                      _I, _P),
    # error code -> message
    "sc_error_string": (_I,),
}

_lock = threading.Lock()
_lib = None


def library_path():
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256()
    for path in SOURCES + _HEADERS:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + _LINK_FLAGS).encode())
    return BUILD_DIR / f"springcraft_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = pathlib.Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the port's CUDA kernels are "
        "built from csrc/ on first use and need the CUDA toolkit")


def _build(target):
    target.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{target.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objects = [target.with_name(f"{tag}.{src.stem}.o") for src in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, *_REPORT_FLAGS, "-I", str(_CSRC), "-c",
                 "-o", str(obj), str(src)]
                for src, obj in zip(SOURCES, objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    outputs = [proc.communicate()[0] for proc in procs]
    tmp = target.with_name(f"{tag}.tmp")
    link = [nvcc, *_LINK_FLAGS, "-o", str(tmp), *map(str, objects)]
    failed = [" ".join(cmd) for cmd, proc in zip(compiles, procs)
              if proc.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        outputs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(" ".join(link))
    log = target.with_suffix(".log")
    log.write_text("".join(" ".join(cmd) + "\n" + out for cmd, out
                           in zip(compiles + [link], outputs)))
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed: {failed[0]}; see {log}\n"
                           + "".join(outputs))
    os.replace(tmp, target)


def load():
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            target = library_path()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.sc_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def build_log():
    """The compiler's report of the current library (registers, shared
    memory, spills), or ``None`` before the first build."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else None


def route(name, *tensors):
    """``"cpu"`` or ``"cuda"``: where the wrapper `name` runs for these
    inputs (its plain version, or its kernel).  Raises on inputs that
    lie on several devices, or on another device type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs lie on several devices "
                         f"{sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device type {kind!r}")
    return kind


def require_cuda_f32(name, **tensors):
    """Raise unless every tensor is contiguous float32, as the kernels
    take them."""
    for arg, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32 on CUDA, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def launch(entry, device, *args):
    """Call the C entry point `entry` with `args` and PyTorch's current
    stream on `device` (the device the tensors lie on), and raise when
    it returns a CUDA error."""
    lib = load()
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        code = getattr(lib, entry)(*args, stream)
    if code != 0:
        message = lib.sc_error_string(code).decode()
        raise RuntimeError(f"{entry}: CUDA error {code}: {message}")
