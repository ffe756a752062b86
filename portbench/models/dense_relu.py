"""The dense ReLU chain: ``h = x @ w + b``, ReLU after every layer but the
last (the reference renderer's Keras net, ``src/neuralNetwork.cpp:85-151``,
at any widths). Its weights are a repository ``.npz`` held to a sha256,
widened ``widen`` times from the seed (``portbench.weights``)."""
from __future__ import annotations

from .. import weights
from ..reference.render import Net

make = weights.make


def program(cnr, layers, device):
    return cnr.from_numpy_params(layers, device=device)


def reference_net(layers, device) -> Net:
    return Net(layers, device)


def flops_per_eval(config: dict) -> int:
    """2 * sum(fan_in * fan_out) over the chain's layers."""
    sizes = config["layer_sizes"]
    return 2 * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def bytes_per_eval(config: dict) -> int:
    """The weights are all an evaluation reads."""
    return 0
