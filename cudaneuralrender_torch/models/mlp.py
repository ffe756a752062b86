"""Dense MLP used as the neural SDF.

The PyTorch counterpart of the JAX package's ``models/mlp.py``. Parameters
live in an ``nn.Module`` but keep the JAX layout — per layer ``w [in, out]``
and ``b [out]``, y = x @ w + b (Keras convention) — so the parity tests
compare like with like and ``from_numpy_params`` carries the JAX package's
arrays across unchanged.

Hidden layers use ReLU; the final layer is linear (the raw logit the
renderer consumes; the reference tags it "Tanh" but never applies it).

Every matmul here runs in float32. On the card that requires TF32 to be
off (``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's default):
TF32 keeps ~10 mantissa bits, far too coarse for the 1e-6 march epsilon.
The renderer checks this where it starts (render/renderer.py).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..kernels import elementwise


class DenseParams(NamedTuple):
    """One dense layer: y = x @ w + b.  w: (in, out), b: (out,)."""

    w: torch.Tensor
    b: torch.Tensor


class MLP(nn.Module):
    """The SDF network: ``len(self)`` dense layers; ``self[i]`` is layer i's
    ``DenseParams`` (the same tensors the module holds, no copy).

    Parameters default to ``requires_grad=False``: rendering differentiates
    the SDF with respect to points only, and a march over parameters that
    require grad would record an autograd graph at every step.
    """

    def __init__(self, layers: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 requires_grad: bool = False):
        super().__init__()
        self.weights = nn.ParameterList(
            [nn.Parameter(w, requires_grad=requires_grad) for w, _ in layers])
        self.biases = nn.ParameterList(
            [nn.Parameter(b, requires_grad=requires_grad) for _, b in layers])
        validate_chain(self)

    def __len__(self) -> int:
        return len(self.weights)

    def __getitem__(self, i: int) -> DenseParams:
        return DenseParams(self.weights[i], self.biases[i])

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply(self, x)

    @property
    def device(self) -> torch.device:
        return self.weights[0].device

    # The model interface the march kernels, the renderer and ``diff/`` take
    # a model through (``hash_grid.HashGridSDF`` has the other): a dense
    # chain is its own chain, reads the point (and frame) as its input, and
    # gathers from no table.

    #: Table entries one SDF evaluation gathers.
    gathers_per_eval = 0

    @property
    def chain(self) -> "MLP":
        """The dense chain the kernels' chain runs."""
        return self

    @property
    def num_inputs(self) -> int:
        """The model's inputs: the point's 3, or 4 with the frame."""
        return int(self.weights[0].shape[0])

    def grid(self):
        """The encoding's table and level words the kernels read: none."""
        return None

    def plain_inputs(self, x: torch.Tensor) -> torch.Tensor:
        """The chain's inputs for the model's inputs x [..., n_in]: x."""
        return x

    def check_render(self, config) -> None:
        """A dense chain renders every scene."""

    def require_dense(self, what: str) -> None:
        """A dense chain takes every path."""

    def shade_sdf_fn(self, config, frame):
        """The SDF of a render's shading normals:
        ``fused_mlp.neural_sdf_fn_grad_kernel``."""
        from ..kernels import fused_mlp

        return fused_mlp.neural_sdf_fn_grad_kernel(self, frame, config.num_inputs)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when no
    card is available. The package's entry points default to the card and
    never fall back to the CPU: the CPU is used only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} (the default) needs a CUDA device, but "
            "torch.cuda.is_available() is false; pass device='cpu' to run on the CPU")
    return dev


def from_numpy_params(layers, device="cuda", dtype=torch.float32) -> MLP:
    """Build an ``MLP`` from a list of (w [in, out], b [out]) arrays — the
    layout of the JAX package's parameter pytree (anything ``np.asarray``
    accepts, JAX arrays included) — on ``device`` (default the card)."""
    device = resolve_device(device)
    return MLP([
        (torch.tensor(np.asarray(w), dtype=dtype, device=device),
         torch.tensor(np.asarray(b), dtype=dtype, device=device))
        for w, b in layers
    ])


def to_numpy_params(params: MLP):
    """The inverse of ``from_numpy_params``: a list of (w, b) ndarrays."""
    return [(l.w.detach().cpu().numpy(), l.b.detach().cpu().numpy()) for l in params]


def init_mlp(
    generator: torch.Generator,
    sizes: Sequence[int] = (3, 32, 32, 32, 32, 32, 32, 32, 32, 1),
    device="cuda",
) -> MLP:
    """Random init (He for ReLU hidden layers, Glorot for the head), drawn
    from ``generator`` (a CPU generator) and moved to ``device`` (default
    the card). Default architecture matches the shipped geometry files: 9
    dense layers 3->32, 32->32 x7, 32->1."""
    device = resolve_device(device)
    layers = []
    for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        last = i == len(sizes) - 2
        scale = (2.0 / (n_in + n_out)) ** 0.5 if last else (2.0 / n_in) ** 0.5
        w = torch.randn((n_in, n_out), generator=generator) * scale
        layers.append((w.to(device), torch.zeros(n_out, device=device)))
    return MLP(layers)


class _TieStep(torch.autograd.Function):
    """``g * H(h, 1/2)`` (``elementwise.relu_tie_backward``: one kernel on
    the card), differentiable in g with the step held constant: its own
    backward is the same product with the incoming gradient. A second
    derivative (differentiable shading, the training step) sees only that
    product, as with the JAX package's step function."""

    @staticmethod
    def forward(ctx, g, h):
        ctx.save_for_backward(h)
        return elementwise.relu_tie_backward(g.contiguous(), h.contiguous())

    @staticmethod
    def backward(ctx, gg):
        (h,) = ctx.saved_tensors
        return _TieStep.apply(gg, h), None


class _TieReLU(torch.autograd.Function):
    """ReLU whose gradient at a pre-activation of exactly 0 is 1/2, as
    ``jnp.maximum(h, 0.0)``'s is (``torch.relu``'s is 0). The forward is
    ``torch.relu``; the backward is one kernel, as relu's is (``_TieStep``)."""

    @staticmethod
    def forward(ctx, h):
        ctx.save_for_backward(h)
        return torch.relu(h)

    @staticmethod
    def backward(ctx, g):
        (h,) = ctx.saved_tensors
        if torch.is_grad_enabled():  # create_graph: the product must be differentiable
            return _TieStep.apply(g, h.detach())
        return elementwise.relu_tie_backward(g.contiguous(), h.contiguous())


def relu_tie(h: torch.Tensor) -> torch.Tensor:
    """ReLU with JAX's gradient at ties (``_TieReLU``) where autograd
    records; ``torch.relu`` otherwise."""
    if torch.is_grad_enabled() and h.requires_grad:
        return _TieReLU.apply(h)
    return torch.relu(h)


def apply(params: MLP, x: torch.Tensor) -> torch.Tensor:
    """Forward pass. x: (..., n_in) -> (..., n_out); ReLU on every layer but
    the last. A pre-activation of exactly 0 gets the gradient 1/2, as the
    JAX package's ``jnp.maximum`` gives it (``relu_tie``): with
    ``torch.relu``'s 0, a zero-bias net's ray through the origin (every
    first-layer pre-activation 0) gets a zero SDF gradient and a NaN
    normal."""
    h = x
    n = len(params)
    for i, layer in enumerate(params):
        h = h @ layer.w + layer.b
        if i + 1 < n:
            h = relu_tie(h)
    return h


def apply_scalar(params: MLP, x: torch.Tensor) -> torch.Tensor:
    """(..., n_in) -> (...) for single-output networks (SDF value)."""
    return apply(params, x).squeeze(-1)


def num_weight_params(params: MLP) -> int:
    return sum(int(l.w.numel()) for l in params)


def num_bias_params(params: MLP) -> int:
    return sum(int(l.b.numel()) for l in params)


def num_params(params: MLP) -> int:
    return num_weight_params(params) + num_bias_params(params)


def layer_sizes(params: MLP) -> Tuple[int, ...]:
    """(n_in, hidden..., n_out) chain of the network."""
    sizes = [int(params[0].w.shape[0])]
    for l in params:
        sizes.append(int(l.w.shape[1]))
    return tuple(sizes)


def validate_chain(params: MLP) -> None:
    """Check layer i's output width feeds layer i+1's input width."""
    for i in range(len(params) - 1):
        n_out = params[i].w.shape[1]
        n_in = params[i + 1].w.shape[0]
        if n_out != n_in:
            raise ValueError(
                f"layer {i} outputs {n_out} features but layer {i+1} expects {n_in}"
            )
    for i, l in enumerate(params):
        if tuple(l.b.shape) != (l.w.shape[1],):
            raise ValueError(f"layer {i} bias shape {tuple(l.b.shape)} != ({l.w.shape[1]},)")
