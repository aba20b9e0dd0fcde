"""
Device meshes for multi-device execution.

Counterpart of ``springcraft_tpu/parallel/mesh.py``.  The JAX package
runs one process over a ``jax.sharding.Mesh`` of its devices, arrays
sharded over it and the collectives left to XLA.  The port keeps that
single-controller model: one process drives a list of ``torch.device``s,
each shard a tensor on its own device, and every copy between devices is
an explicit ``.to(device)`` (no process group).

Mesh axes, as in the JAX package:

* ``"ens"`` — data parallelism over conformer ensembles;
* ``"row"`` — row blocks of a mega-assembly Hessian.

A mesh may name one device more than once: four entries over ``cuda:0``
run every shard's index arithmetic on one card, and eight over the CPU
mirror the eight virtual devices of the JAX package's tests.

:class:`Sharding` splits one dimension of a tensor into equal contiguous
chunks over the mesh's flat device order (row-major over the grid, the
order in which ``P(("ens", "row"))`` splits an axis);
:class:`ShardedTensor` holds the chunks.  The JAX sharding types ``P``
and ``NamedSharding`` are not carried over.
"""

from __future__ import annotations

import typing

import torch

__all__ = ["make_mesh", "ensemble_sharding", "Mesh", "Sharding",
           "ShardedTensor"]


class Mesh(typing.NamedTuple):
    """An ``("ens", "row")`` grid of devices (tuples of
    ``torch.device``); hashable, so caches may key on it."""

    devices: tuple

    @property
    def shape(self):
        """``{"ens": E, "row": R}``, read as ``mesh.shape["row"]``."""
        return {"ens": len(self.devices), "row": len(self.devices[0])}

    @property
    def size(self):
        return len(self.devices) * len(self.devices[0])

    @property
    def flat(self):
        """The devices in the order a mesh-wide split takes them."""
        return tuple(dev for row in self.devices for dev in row)


def make_mesh(n_devices=None, row_axis=1, devices=None):
    """
    Build a 2D ``("ens", "row")`` mesh over `n_devices` devices.

    Parameters
    ----------
    n_devices : int, optional
        Number of devices to use (default: all of `devices`).
    row_axis : int
        Size of the ``"row"`` (model-parallel) axis; must divide
        `n_devices`.
    devices : sequence of torch.device or str, optional
        The devices, in mesh order; one may repeat.  Default: every CUDA
        device (``RuntimeError`` without one: there is no CPU fallback,
        pass CPU devices explicitly).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device (torch.cuda.is_available() is "
                "False); pass devices=[torch.device('cpu')] * n to build a "
                "CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(dev) for dev in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices % row_axis != 0:
        raise ValueError(
            f"row_axis={row_axis} does not divide n_devices={n_devices}"
        )
    if n_devices > len(devices):
        raise ValueError(f"n_devices={n_devices} exceeds the "
                         f"{len(devices)} devices given")
    flat = devices[:n_devices]
    return Mesh(tuple(tuple(flat[e * row_axis:(e + 1) * row_axis])
                      for e in range(n_devices // row_axis)))


class ShardedTensor(typing.NamedTuple):
    """A tensor split along `dim` into `shards`, each on its own device
    (the counterpart of a sharded global ``jax.Array``)."""

    shards: tuple
    dim: int

    @property
    def shape(self):
        sizes = list(self.shards[0].shape)
        sizes[self.dim] = sum(s.shape[self.dim] for s in self.shards)
        return torch.Size(sizes)

    @property
    def dtype(self):
        return self.shards[0].dtype

    def full(self, device=None):
        """The whole tensor on `device` (default: the first shard's)."""
        device = self.shards[0].device if device is None else device
        return torch.cat([s.to(device) for s in self.shards], dim=self.dim)


class Sharding(typing.NamedTuple):
    """Equal contiguous chunks of dimension `dim` over ``mesh.flat``."""

    mesh: Mesh
    dim: int = 0

    def bounds(self, size):
        """``[(start, stop), ...]`` of each device's chunk of `size`;
        ``ValueError`` unless the mesh divides `size`."""
        count = self.mesh.size
        if size % count:
            raise ValueError(f"dimension {self.dim} of size {size} must be "
                             f"divisible by the mesh size {count}")
        step = size // count
        return [(d * step, (d + 1) * step) for d in range(count)]

    def split(self, x):
        """`x` (a tensor on any device) as a :class:`ShardedTensor` of
        contiguous copies."""
        return ShardedTensor(tuple(
            x.narrow(self.dim, start, stop - start).to(dev, copy=True)
            .contiguous()
            for (start, stop), dev in zip(self.bounds(x.shape[self.dim]),
                                          self.mesh.flat)), self.dim)


def ensemble_sharding(mesh):
    """Sharding placing the leading (conformer) axis across the full
    mesh (both axes act as data parallelism for ensembles)."""
    return Sharding(mesh, 0)
