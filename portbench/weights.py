"""The weights a cell serves, made by the benchmark and handed to both sides.

A configuration names a weights file of the repository (``.npz`` with
``w0, b0, w1, ...`` in the Keras layout, ``w [in, out]``), its sha256, which
holds the file as it was when the cell was proven, and a widening factor.
The program and the plain reference get the same float32 arrays.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np


def load_npz(path: str) -> list:
    """[(w [in, out], b [out]), ...] float32, in layer order."""
    with np.load(path) as data:
        n = len([k for k in data.files if k.startswith("w")])
        return [(np.asarray(data[f"w{i}"], np.float32), np.asarray(data[f"b{i}"], np.float32))
                for i in range(n)]


def widen(layers, k: int, seed: int) -> list:
    """A net k times as wide that computes the same function: (w [in, out],
    b [out]) float32 arrays in, the same out.

    Each hidden unit j becomes k copies. Copy c takes the incoming column
    a*W[:, j] and bias a*b[j] (a in [0.5, 2], seeded), so it outputs
    a*ReLU(z_j) = ReLU(a*z_j); its outgoing row is (s_c/a)*W_next[j, :], with
    seeded shares s_c > 0 summing to 1 over the copies. A seeded permutation
    then reorders each hidden layer's units. The result equals the original
    net up to float32 rounding, while no two copies share a weight or a
    position. (A frozen copy of ``chip_smoke.widen``.)"""
    rng = np.random.default_rng(seed)
    ws = [np.asarray(w, np.float64) for w, _ in layers]
    bs = [np.asarray(b, np.float64) for _, b in layers]
    out_scale = None  # per input row of the current layer: s / a of the layer before
    perm_in = None
    result = []
    for i, (w, b) in enumerate(zip(ws, bs)):
        if out_scale is not None:  # expand and scale the rows, then permute them
            w = np.repeat(w, k, axis=0) * out_scale[:, None]
            w = w[perm_in]
        if i + 1 < len(ws):  # a hidden layer: expand, scale and permute its units
            n = w.shape[1]
            a = rng.uniform(0.5, 2.0, (n, k))
            s = rng.uniform(0.5, 1.5, (n, k))
            s /= s.sum(axis=1, keepdims=True)
            w = np.repeat(w, k, axis=1) * a.reshape(-1)[None, :]
            b = np.repeat(b, k) * a.reshape(-1)
            perm = rng.permutation(n * k)
            w, b = w[:, perm], b[perm]
            out_scale, perm_in = (s / a).reshape(-1), perm
        result.append((w.astype(np.float32), b.astype(np.float32)))
    return result


def layer_sizes(layers) -> list:
    """[n_in, hidden..., n_out] of a dense chain."""
    return [layers[0][0].shape[0]] + [w.shape[1] for w, _ in layers]


def make(config: dict, root: str, seed: int) -> list:
    """The configuration's layers: its weights file, widened ``widen`` times
    with a widening drawn from ``seed``. Checks the file's digest and the
    sizes the configuration states."""
    path = os.path.join(root, config["weights"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != config["weights_sha256"]:
        raise ValueError(f"{config['name']}: {config['weights']} has sha256 {digest}, "
                         f"not the {config['weights_sha256']} the cell was proven on")
    layers = load_npz(path)
    k = int(config.get("widen", 1))
    if k > 1:
        layers = widen(layers, k, seed)
    sizes = layer_sizes(layers)
    if sizes != list(config["layer_sizes"]):
        raise ValueError(f"{config['name']}: layer sizes {sizes} != {config['layer_sizes']}")
    return layers
