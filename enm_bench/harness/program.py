"""
What the benchmark takes from the program under test, the PyTorch and
CUDA port ``springcraft_tpu_torch``: the package itself, its force-field
parameters for a configuration, and the one switch a control run turns.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

PACKAGE = "springcraft_tpu_torch"
#: Top-level modules that must not be loaded in a run's process: JAX and
#: the JAX package the port was made from (compared by the whole name
#: before the first dot).
FORBIDDEN = ("jax", "jaxlib", "flax", "springcraft_tpu")


def load():
    """The program's package."""
    return importlib.import_module(PACKAGE)


def forbidden_modules(modules):
    """The names among `modules` whose top-level name is forbidden."""
    return sorted(name for name in modules
                  if name.split(".", 1)[0] in FORBIDDEN)


def force_field(sct, config, structures):
    """The program's parameters of the configuration's force field: the
    invariant family's, or a tabulated family's compact parameters built
    by the program's host layer from the atoms' annotations."""
    field = config["force_field"]
    if field["family"] == "invariant":
        return sct.invariant_params(float(field["cutoff_A"]))
    n = structures.coords.shape[-2]
    atoms = sct.AtomArray(n)
    atoms.coord = structures.coords[0]
    atoms.atom_name = np.full(n, "CA")
    atoms.element = np.full(n, "C")
    atoms.chain_id = structures.chain_id
    atoms.res_id = structures.res_id
    atoms.res_name = structures.res_name
    tabulated = getattr(sct.TabulatedForceField, field["family"])
    return tabulated(atoms).to_compact_params()


def set_tf32(on):
    """TF32 in float32 matrix products on or off (the program turns it
    off when it is imported; a control run turns it on)."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
