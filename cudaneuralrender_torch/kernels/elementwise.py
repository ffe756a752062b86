"""Elementwise kernels of the backward passes (``csrc/elementwise.cu``).

``relu_tie_backward(g, h)`` is ``g * H(h, 1/2)``: the gradient of a ReLU
whose derivative at a pre-activation of exactly 0 is 1/2, the JAX
package's ``jnp.maximum(h, 0.0)`` gradient (``models/mlp.py``
``_TieReLU``). On CUDA tensors it launches the hand-written kernel, one
pass over g and h; on CPU tensors it runs ``relu_tie_backward_plain``.
A build or launch failure on the card raises: there is no fallback.

``RELU_TIE_LAUNCHES`` counts the kernel's launches (plain-version calls do
not count).
"""
from __future__ import annotations

import torch

from . import build

#: Launches of the CUDA relu_tie_backward kernel in this process.
RELU_TIE_LAUNCHES = 0


def reset_launch_counts() -> None:
    """Set ``RELU_TIE_LAUNCHES`` to 0."""
    global RELU_TIE_LAUNCHES
    RELU_TIE_LAUNCHES = 0


def relu_tie_backward_plain(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``g * torch.heaviside(h, 1/2)``: the kernel's plain version."""
    # A 0-dim CPU tensor is a scalar operand on any device, with no copy.
    return g * torch.heaviside(h, torch.tensor(0.5, dtype=h.dtype))


def relu_tie_backward(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``g * H(h, 1/2)`` for float32 ``g`` and ``h`` of one shape: the
    kernel on the card (contiguous tensors on one device), the plain
    version on the CPU."""
    global RELU_TIE_LAUNCHES
    if g.device.type != "cuda":
        return relu_tie_backward_plain(g, h)
    if g.dtype != torch.float32 or h.dtype != torch.float32:
        raise ValueError(f"relu_tie_backward takes float32, got {g.dtype} and {h.dtype}")
    if g.shape != h.shape or g.device != h.device:
        raise ValueError(f"relu_tie_backward: g {tuple(g.shape)} on {g.device} and "
                         f"h {tuple(h.shape)} on {h.device} differ")
    if not (g.is_contiguous() and h.is_contiguous()):
        raise ValueError("relu_tie_backward: g and h must be contiguous")
    out = torch.empty_like(g)
    if g.numel() == 0:
        return out
    lib = build.load_library()
    dev = g.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = lib.cnr_relu_tie_backward(index, g.data_ptr(), h.data_ptr(), out.data_ptr(),
                                    g.numel(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"relu_tie_backward launch failed: "
                           f"{lib.cnr_error_string(err).decode()} ({err})")
    RELU_TIE_LAUNCHES += 1
    return out
