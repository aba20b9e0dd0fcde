"""
Checkpoint / resume for ENM models and analysis results.

Counterpart of ``springcraft_tpu/io.py`` (the port's own copy).  Model
state round-trips through one ``.npz`` file in the JAX package's layout —
``kind``, ``coord``, ``masses`` and whichever of the dual matrix caches
are populated (``matrix``, ``covariance``) — so a file saved by either
package loads in the other.  The port's models keep their matrices as
float64 tensors on their device: :func:`save_model` fetches them,
:func:`load_model` puts them back on `device`.  The force field itself is
reconstructed by the caller; matrices take precedence, so analyses resume
without recomputation.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.anm import ANM
from .models.gnm import GNM
from .utils.config import as_tensor
from .utils.elastic import _host

__all__ = ["save_model", "load_model", "save_results", "load_results"]


def save_model(path, model):
    """Serialize a :class:`GNM`/:class:`ANM` to an ``.npz`` file."""
    payload = {
        "kind": np.array("anm" if isinstance(model, ANM) else "gnm"),
        "coord": np.asarray(model._coord),
    }
    if model.masses is not None:
        payload["masses"] = np.asarray(model.masses)
    if model._matrix is not None:
        payload["matrix"] = _host(model._matrix)
    if model._covariance is not None:
        payload["covariance"] = _host(model._covariance)
    np.savez_compressed(path, **payload)


class _NullForceField:
    """Placeholder for models restored from checkpoints that carry their
    matrices; every route that would rebuild from the force field — the
    dense assembly, the matrix-free and mode solvers (which lower the
    field through ``to_params``) — raises a ``RuntimeError``."""

    cutoff_distance = None
    contact_shutdown = None
    contact_pair_off = None
    contact_pair_on = None
    natoms = None

    @staticmethod
    def _refuse():
        raise RuntimeError(
            "Model was restored from a checkpoint without a force field; "
            "assign a matrix or pass force_field= to load_model"
        )

    def force_constant(self, atom_i, atom_j, sq_distance):
        self._refuse()

    def to_params(self, natoms=None):
        self._refuse()


def load_model(path, force_field=None, device=None):
    """
    Restore a model saved with :func:`save_model`.

    Parameters
    ----------
    path : str
    force_field : ForceField, optional
        Attach a force field so the model can also recompute matrices
        from scratch; without it, only the checkpointed matrices are
        usable (which suffices for all observables).
    device : str or torch.device, optional
        Where the restored model lives and its matrices go; the current
        CUDA device by default.
    """
    with np.load(path, allow_pickle=False) as data:
        kind = str(data["kind"])
        coord = data["coord"]
        masses = data["masses"] if "masses" in data else None
        matrix = data["matrix"] if "matrix" in data else None
        covariance = data["covariance"] if "covariance" in data else None

    cls = ANM if kind == "anm" else GNM
    model = cls(coord, force_field or _NullForceField(), masses=masses,
                device=device)
    if matrix is not None:
        model._matrix = as_tensor(matrix, torch.float64, model._device)
    if covariance is not None:
        model._covariance = as_tensor(covariance, torch.float64,
                                      model._device)
    return model


def save_results(path, results):
    """Store a dict of observable arrays (e.g. a pipeline output; tensors
    on any device are fetched)."""
    np.savez_compressed(path, **{k: _host(v) for k, v in results.items()})


def load_results(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}
