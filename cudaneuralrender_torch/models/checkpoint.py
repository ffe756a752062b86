"""Checkpoint I/O: Keras-HDF5 ingestion and the native npz format.

The PyTorch counterpart of the JAX package's ``models/checkpoint.py``: the
same file formats, read with h5py and numpy, so either package loads the
other's files. Keras files are walked like the reference's loader
(src/neuralNetwork.cpp:85-151): one top-level group per layer, one inner
group, a 1-D bias and a 2-D (in, out) kernel; layer order follows the
``layer_names`` attribute, falling back to a natural-numeric sort.

h5py is imported only to read or write a Keras file; the npz format needs
numpy alone (hosts without h5py load ``.npz`` checkpoints).
"""
from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np

from ..utils import memo as _memo
from . import mlp
from .mlp import MLP


def _natural_key(name: str):
    """'dense' < 'dense_1' < 'dense_2' < ... < 'dense_10'."""
    parts = re.split(r"(\d+)", name)
    return [int(p) if p.isdigit() else p for p in parts]


def _ordered_layer_names(f) -> List[str]:
    names = f.attrs.get("layer_names")
    if names is not None:
        return [n.decode() if isinstance(n, bytes) else str(n) for n in names]
    return sorted(f.keys(), key=_natural_key)


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("a Keras .h5 file needs the h5py package, which is not installed; "
                          ".npz checkpoints (save_pytree, load_pytree) need numpy alone") from e
    return h5py


def read_keras_h5(path: str):
    """The dense chain of a Keras HDF5 weight file as (w, b) ndarrays."""
    h5py = _h5py()

    layers = []
    with h5py.File(path, "r") as f:
        for name in _ordered_layer_names(f):
            obj = f[name]
            if not isinstance(obj, h5py.Group):
                raise ValueError(f"{path}: top-level object {name!r} is not a group")
            inner_names = list(obj.keys())
            if len(inner_names) != 1:
                raise ValueError(
                    f"{path}: layer group {name!r} has {len(inner_names)} children, expected 1"
                )
            inner = obj[inner_names[0]]
            w: Optional[np.ndarray] = None
            b: Optional[np.ndarray] = None
            for ds_name in inner.keys():
                ds = inner[ds_name]
                if not isinstance(ds, h5py.Dataset):
                    raise ValueError(f"{path}: {name}/{ds_name} is not a dataset")
                arr = np.asarray(ds)
                if arr.ndim == 1:
                    b = arr
                elif arr.ndim == 2:
                    w = arr
                else:
                    raise ValueError(
                        f"{path}: {name}/{ds_name} has rank {arr.ndim}; only dense layers supported"
                    )
            if w is None:
                raise ValueError(f"{path}: layer {name!r} has no 2-D kernel dataset")
            if b is None:
                b = np.zeros((w.shape[1],), dtype=w.dtype)
            layers.append((w, b))
    return layers


def load_keras_h5(path: str, *, device="cuda") -> MLP:
    """Load a Keras-exported dense-stack HDF5 file into an ``MLP`` on
    ``device`` (default the card)."""
    return mlp.from_numpy_params(read_keras_h5(path), device=device)


def save_keras_h5(path: str, params: MLP) -> None:
    """Write an MLP as a Keras-layout HDF5 weight file, the structure
    ``read_keras_h5`` (and the reference's loader) parses: one top-level
    group per layer named dense, dense_1, ..., an inner group of the same
    name holding ``kernel:0`` (in, out) and ``bias:0``, and the
    ``layer_names`` root attribute Keras writes (the JAX package's
    ``save_keras_h5``). Needs h5py."""
    h5py = _h5py()
    layers = mlp.to_numpy_params(params)
    names = [f"dense_{i}" if i else "dense" for i in range(len(layers))]
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n in names])
        for name, (w, b) in zip(names, layers):
            inner = f.create_group(name).create_group(name)
            inner.create_dataset("kernel:0", data=w)
            inner.create_dataset("bias:0", data=b)


def save_pytree(path: str, params: MLP) -> None:
    """Save an MLP as .npz (keys: w0,b0,w1,b1,... — the JAX package's format)."""
    arrays = {}
    for i, (w, b) in enumerate(mlp.to_numpy_params(params)):
        arrays[f"w{i}"] = w
        arrays[f"b{i}"] = b
    np.savez(path, **arrays)


def load_pytree(path: str, *, device="cuda") -> MLP:
    """Load an MLP saved by save_pytree (either package's) onto ``device``
    (default the card)."""
    with np.load(path) as data:
        n = len(data.files) // 2
        layers = [(data[f"w{i}"], data[f"b{i}"]) for i in range(n)]
    return mlp.from_numpy_params(layers, device=device)


def load(path: str, *, device="cuda") -> MLP:
    """Load a model by extension: .h5/.hdf5 -> Keras, .npz -> native, onto
    ``device`` (default the card; raises when there is none and the CPU was
    not asked for).

    Tags the loaded model with its absolute path (utils/memo.py) so the
    staged renderer's adaptive-schedule memo keys on geometry identity."""
    lower = path.lower()
    if lower.endswith((".h5", ".hdf5")):
        params = load_keras_h5(path, device=device)
    elif lower.endswith(".npz"):
        params = load_pytree(path, device=device)
    else:
        raise ValueError(f"unknown checkpoint format: {path}")
    _memo.tag_geometry(params, os.path.abspath(path))
    return params
