"""The padded layer chain and the fused forward kernel (K3).

The PyTorch counterpart of the JAX package's ``pallas/fused_mlp.py``:

  * ``pack_params`` builds the zero-padded [L, H, H] weight stack and [L, H]
    biases the CUDA kernels read, H the smallest of ``KERNEL_WIDTHS`` that
    holds the widest layer;
  * ``mlp_chain_plain`` is the plain PyTorch version of ``_mlp_chain``
    (``fused_mlp.py:162``) on [T, H] activations (rays on rows, features on
    columns — PyTorch's habit; the TPU kernel keeps them transposed);
  * ``mlp_forward`` is the counterpart of ``mlp_forward_pallas``
    (``fused_mlp.py:194``): on CUDA tensors it launches the hand-written
    kernel in ``csrc/chain.cuh``, on CPU tensors it runs
    ``mlp_forward_plain``; ``neural_sdf_fn_kernel`` wraps it as an SDF, the
    counterpart of ``neural_sdf_fn_pallas`` (``config.use_pallas``).

Zero padding is exact: padded input features are zero, so weight rows
beyond a layer's true input width contribute nothing, and the head reads
only output column 0.

``MLP_LAUNCHES`` counts launches of the forward kernel (plain-version calls
do not count).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..models.mlp import MLP
from . import build

#: The hidden widths the CUDA kernels are instantiated for.
KERNEL_WIDTHS = (32, 64, 128, 256)

#: Launches of the CUDA forward kernel in this process.
MLP_LAUNCHES = 0


def min_rows(device: torch.device) -> int:
    """Least batch the plain versions hand the layer chain on ``device``.

    BLAS libraries switch to other kernels, which sum in another order, for
    a few rows (the CPU's matrix-vector path at one row, cuBLAS's small-M
    kernels), and a point's SDF would then depend on how many points are
    evaluated beside it. On the H100, cuBLAS sums a 256-wide layer in
    another order below 1024 rows, and in the kernels' order from 1024 rows
    up at every width (bit for bit; chip_smoke.py phase 9 prints the sweep)."""
    return 1024 if device.type == "cuda" else 256


def reset_launch_counts() -> None:
    """Set ``MLP_LAUNCHES`` to 0."""
    global MLP_LAUNCHES
    MLP_LAUNCHES = 0


def padded_width(widest: int) -> int:
    """The smallest kernel width that holds a layer ``widest`` wide."""
    for h in KERNEL_WIDTHS:
        if widest <= h:
            return h
    raise ValueError(
        f"a {widest}-wide layer is wider than the kernels' {KERNEL_WIDTHS[-1]} "
        "(ROADMAP section 2: K1 beyond width 256)")


def pack_params(params: MLP) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Pad an MLP to a uniform [L, H, H] weight stack + [L, H] biases on the
    parameters' device, H = ``padded_width`` of the widest layer. Returns
    (weights, biases, n_in, hidden)."""
    sizes = [int(params[0].w.shape[0])] + [int(l.w.shape[1]) for l in params]
    h = padded_width(max(sizes))
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
    in place (its storage or version counter changes), so a frame's kernel
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


def check_tensor(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's wrapper hands the kernel."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def mlp_forward_plain(weights: torch.Tensor, biases: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel, on any device: x
    [B, n_in] points through the padded chain. Returns the head [B]."""
    n, n_in = x.shape
    h = weights.shape[1]
    xp = torch.zeros((max(n, min_rows(x.device)), h), dtype=torch.float32, device=x.device)
    xp[:n, :n_in] = x
    return mlp_chain_plain(weights, biases, xp, weights.shape[0])[:n, 0]


def _mlp_forward_cuda(weights: torch.Tensor, biases: torch.Tensor,
                      x: torch.Tensor) -> torch.Tensor:
    global MLP_LAUNCHES
    n_layers, hidden = weights.shape[0], weights.shape[1]
    if hidden not in KERNEL_WIDTHS:
        raise ValueError(f"the forward kernel is built for widths {KERNEL_WIDTHS}, "
                         f"not {hidden}")
    n, n_in = x.shape
    if not 1 <= n_in <= 4:
        raise ValueError(f"the forward kernel takes 1 to 4 inputs per point, not {n_in}")
    dev = x.device
    check_tensor("x", x, torch.float32, (n, n_in), dev)
    check_tensor("weights", weights, torch.float32, (n_layers, hidden, hidden), dev)
    check_tensor("biases", biases, torch.float32, (n_layers, hidden), dev)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    lib = build.load_library()
    err = lib.cnr_mlp_forward(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        x.data_ptr(), weights.data_ptr(), biases.data_ptr(), n_layers, hidden, n_in, n,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"forward kernel launch failed: {lib.cnr_error_string(err).decode()} ({err})")
    MLP_LAUNCHES += 1
    return out


def mlp_forward(weights: torch.Tensor, biases: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Fused forward pass: weights [L, H, H] and biases [L, H] from
    ``pack_params``, x [B, n_in] points. Returns [B] raw logits (the
    single-output head).

    CPU tensors run the plain version; CUDA tensors launch the kernel (or
    raise). The kernel has no gradient: differentiable callers use the
    plain chain (``render.renderer.scene_fn(for_grad=True)``)."""
    if x.device.type == "cpu":
        return mlp_forward_plain(weights, biases, x)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_forward runs on cpu or cuda tensors, not {x.device}")
    return _mlp_forward_cuda(weights, biases, x)


def neural_sdf_fn_kernel(params: MLP, frame=0.0, num_inputs: int = 3):
    """An SdfFn over (..., 3) points backed by the forward kernel — the
    counterpart of ``neural_sdf_fn_pallas`` and a drop-in for
    ``render.renderer.neural_sdf_fn`` where no gradient is taken.
    ``num_inputs=4`` appends the frame number as a 4th input."""
    weights, biases, _, _ = packed_params(params)

    def fn(p: torch.Tensor) -> torch.Tensor:
        flat = p.reshape(-1, p.shape[-1])
        if num_inputs == 4:
            f = torch.full((flat.shape[0], 1), float(frame), dtype=flat.dtype,
                           device=flat.device)
            flat = torch.cat([flat, f], dim=-1)
        return mlp_forward(weights, biases, flat.contiguous()).reshape(p.shape[:-1])

    return fn
