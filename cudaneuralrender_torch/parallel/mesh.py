"""Device meshes: a grid of devices with named axes.

The counterpart of the JAX package's ``parallel/mesh.py``. A ``Mesh`` is a
numpy array of ``torch.device``s with one name per axis (``data``: rays and
pixels, which are independent; ``model``: tensor-parallel weight shards or
expert-parallel geometries), and ``mesh.shape[axis]`` is an axis's size, as
in JAX. A device may repeat: ``make_mesh((8,), ("data",),
[torch.device("cuda")] * 8)`` is eight logical shards on one card, as JAX's
virtual CPU devices are eight shards on one host. A shard body is a loop
over the shards in the default stream (parallel/sharding.py), and every
collective is a sum, max or concatenation over the shards' tensors.

Across processes (parallel/multihost.py) each entry also carries the rank
that owns it (``process_ids``): a process runs only its own shards, and
``torch.distributed`` carries the collectives.

A sharding is a plain spec: a tuple with, per tensor dimension, the mesh
axis it is split over or ``None`` (JAX's ``PartitionSpec``); ``()`` is
replicated. ``device_put`` splits a tensor by a spec.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import mlp


class Mesh:
    """``devices``: an ndarray of ``torch.device`` of the mesh's shape;
    ``axis_names``: one name per axis; ``process_ids``: the rank owning
    each entry (all 0 in one process)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 process_ids: Optional[np.ndarray] = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a {devices.ndim}-d mesh")
        self.process_ids = (np.zeros(devices.shape, np.int64) if process_ids is None
                            else np.asarray(process_ids, np.int64).reshape(devices.shape))

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_entries(self, axis: str):
        """(device, owning rank) of each index along ``axis``: the entry at
        index 0 of every other axis, which holds the same shard as its
        replicas there."""
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[k]):
            index[k] = i
            out.append((self.devices[tuple(index)], int(self.process_ids[tuple(index)])))
        return out

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, devices={self.devices.ravel().tolist()})"


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current device>``, the name tensors report."""
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _default_devices():
    """Every card of this process (the card is the default; raises without one)."""
    mlp.resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data", "model"),
    devices=None,
    process_ids=None,
) -> Mesh:
    """A mesh over ``devices`` (default: every card of this process).

    Default shape: every device on the first (``data``) axis and size 1 on
    the others. ``process_ids`` (default all 0) name the rank owning each
    device, in the same order."""
    if devices is None:
        devices = _default_devices()
    devices = [_indexed(torch.device(d)) for d in devices]
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names,
                None if process_ids is None else np.asarray(process_ids).reshape(shape))


class NamedSharding(NamedTuple):
    """A spec on a mesh (JAX's ``NamedSharding``)."""

    mesh: Mesh
    spec: tuple


def data_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Split the leading (ray/pixel) dimension over ``axis``."""
    return NamedSharding(mesh, (axis,))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def tp_mlp_shardings(params, mesh: Mesh, axis: str = "model"):
    """Tensor-parallel specs for an MLP, one ``DenseParams(weight_spec,
    bias_spec)`` per layer. Megatron pairing: even layers split on their
    output features (w ``(None, axis)``, b ``(axis,)``: column parallel),
    odd layers on their input features (w ``(axis, None)``, b replicated: row parallel,
    whose partial products sum over ``axis``), the head replicated. One
    sum per pair of layers instead of a gather per layer."""
    del mesh  # the specs name the axis; device_put applies them to a mesh
    out = []
    n = len(params)
    for i in range(n):
        if i == n - 1:
            out.append(mlp.DenseParams((), ()))
        elif i % 2 == 0:
            out.append(mlp.DenseParams((None, axis), (axis,)))
        else:
            out.append(mlp.DenseParams((axis, None), ()))
    return tuple(out)


def device_put(x: torch.Tensor, spec: tuple, mesh: Mesh) -> np.ndarray:
    """Split ``x`` by ``spec`` over ``mesh``: an ndarray of the mesh's shape
    holding, at each entry, that device's piece (a slice of ``x`` moved to
    the entry's device; autograd flows back to ``x``). A dimension split
    over an axis must divide by the axis's size."""
    out = np.empty(mesh.devices.shape, dtype=object)
    for index in np.ndindex(mesh.devices.shape):
        piece = x
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            k = mesh.axis_names.index(axis)
            size = mesh.devices.shape[k]
            if x.shape[dim] % size:
                raise ValueError(f"dimension {dim} ({x.shape[dim]}) not divisible by "
                                 f"axis {axis!r} ({size})")
            step = x.shape[dim] // size
            piece = piece.narrow(dim, index[k] * step, step)
        out[index] = piece.to(mesh.devices[index])
    return out
