"""The padded layer chain shared by the march kernel and its plain version.

The PyTorch counterpart of the JAX package's ``pallas/fused_mlp.py`` pieces
the march needs: ``pack_params`` builds the zero-padded [L, H, H] weight
stack and [L, H] biases the CUDA kernel stages into shared memory, and
``mlp_chain_plain`` is the plain PyTorch version of ``_mlp_chain``
(``fused_mlp.py:162``) on [T, H] activations (rays on rows, features on
columns — PyTorch's habit; the TPU kernel keeps them transposed).

Zero padding is exact: padded input features are zero, so weight rows
beyond a layer's true input width contribute nothing, and the head reads
only output column 0.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..models.mlp import MLP


def pack_params(params: MLP) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Pad an MLP to a uniform [L, H, H] weight stack + [L, H] biases on the
    parameters' device, H the widest layer. Returns (weights, biases, n_in,
    hidden)."""
    sizes = [int(params[0].w.shape[0])] + [int(l.w.shape[1]) for l in params]
    h = max(sizes)
    n_layers = len(params)
    dev = params[0].w.device
    weights = torch.zeros((n_layers, h, h), dtype=torch.float32, device=dev)
    biases = torch.zeros((n_layers, h), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for i, layer in enumerate(params):
            n_in_l, n_out_l = layer.w.shape
            weights[i, :n_in_l, :n_out_l] = layer.w
            biases[i, :n_out_l] = layer.b
    return weights, biases, sizes[0], h


def packed_params(params: MLP) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """``pack_params`` once per parameter state. The stack is kept on the
    module and rebuilt only when a parameter is replaced, moved or written
    in place (its storage or version counter changes), so a frame's march
    calls share one stack instead of packing at every launch."""
    key = tuple((p.data_ptr(), p._version) for p in params.parameters())
    cached = getattr(params, "_packed_stack", None)
    if cached is None or cached[0] != key:
        cached = (key, pack_params(params))
        params._packed_stack = cached
    return cached[1]


def mlp_chain_plain(weights: torch.Tensor, biases: torch.Tensor,
                    x: torch.Tensor, n_layers: int) -> torch.Tensor:
    """Run the padded layer chain on activations x [T, H]; ReLU on every
    layer but the last. Returns [T, H]; the SDF head is column 0."""
    for l in range(n_layers):
        y = x @ weights[l] + biases[l]
        if l + 1 < n_layers:
            y = torch.relu(y)
        x = y
    return x
