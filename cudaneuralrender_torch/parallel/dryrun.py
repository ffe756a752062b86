"""Multi-shard dry run: every parallel path once, on logical shards.

The counterpart of the JAX package's ``parallel/dryrun.py``, on a mesh of
``n_devices`` logical shards of one device (the card by default):
  * DP/SP: a dense render with the rays split over the ``data`` axis (the
    sequence-parallel analogue: rays are the sequence);
  * TP + DP: an SDF-regression training step with Megatron-paired
    tensor-parallel weights over ``model`` (``mesh.tp_mlp_shardings``: each
    shard multiplies its slice, the row-parallel layers' partial products
    are summed, the column-parallel outputs concatenated) and the batch
    over ``data``; its loss and gradients must equal the unsharded step's;
  * EP: an expert-parallel step over a stack of geometry nets, a
    ``model`` shard's experts each;
  * the sharded train step on the dense march, the staged sharded render
    (the plain rungs, then the march kernel's), and the staged sharded
    solve feeding the sharded train step.

No pipeline parallelism: a 9-layer 32-wide MLP has no pipeline dimension.
"""
from __future__ import annotations

import torch

from ..diff import train as train_lib
from ..models import mlp
from ..ops.camera import Camera
from ..utils.config import RenderConfig
from . import mesh as mesh_lib
from .sharding import (
    pixel_train_step_sharded,
    render_image_sharded,
    render_image_sharded_staged,
    solve_surface_sharded,
)

# The TP step's gradients against the unsharded step's: the sharded sums
# run in another order (the partial products of each row-parallel layer).
TP_RTOL, TP_ATOL = 1e-5, 1e-7


def _mesh_shape(n: int):
    return (n // 2, 2) if n % 2 == 0 and n > 1 else (n, 1)


def _tp_apply(pieces, specs, mesh: mesh_lib.Mesh, pts_pieces) -> torch.Tensor:
    """The MLP forward with tensor-parallel weights: every data shard's
    prediction [batch / dp], concatenated. ``pieces[i]`` is layer i's (w, b)
    split by ``specs[i]`` (``mesh.device_put``: one piece per mesh entry),
    ``pts_pieces`` the batch split over ``data``."""
    dp, mp = mesh.devices.shape
    out = []
    for d in range(dp):
        h, split = pts_pieces[d, 0], False  # split: h holds mp column pieces
        for i, ((w, b), spec) in enumerate(zip(pieces, specs)):
            last = i == len(specs) - 1
            if spec.w == (None, "model"):  # column parallel: each shard its outputs
                h = [h @ w[d, m] + b[d, m] for m in range(mp)]
                split = True
            elif spec.w == ("model", None):  # row parallel: partial products summed
                h = torch.stack([h[m] @ w[d, m] for m in range(mp)]).sum(0) + b[d, 0]
                split = False
            else:  # replicated: the split activations gathered first
                h = (torch.cat(h, dim=-1) if split else h) @ w[d, 0] + b[d, 0]
                split = False
            if not last:
                h = [torch.relu(x) for x in h] if split else torch.relu(h)
        out.append(h[..., 0])
    return torch.cat(out)


def _net(seed: int, dev) -> mlp.MLP:
    """``init_mlp``'s net (zero biases, as the JAX dry run's) from a seed."""
    return mlp.init_mlp(torch.Generator().manual_seed(seed), device=dev)


def _check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dry run: {what}")


def run(n_devices: int, device="cuda") -> None:
    """Every parallel path once on ``n_devices`` logical shards of
    ``device`` (default the card). Raises if a path fails or the TP step's
    gradients leave the unsharded step's."""
    dev = mlp.resolve_device(device)
    devices = [dev] * n_devices
    dp, mp = _mesh_shape(n_devices)
    mesh = mesh_lib.make_mesh((dp, mp), ("data", "model"), devices)
    gen = torch.Generator().manual_seed(0)

    # ---- DP/SP: a sharded dense render at a tiny size ----------------------
    # height = dp keeps the ray count divisible by the data axis.
    cfg = RenderConfig(width=16, height=dp, scene="sphere", max_steps=32)
    img = render_image_sharded(None, Camera(), cfg, mesh)
    _check(tuple(img.shape) == (cfg.height, cfg.width, 4), f"image shape {tuple(img.shape)}")

    # ---- TP + DP: an SDF-regression step, tensor-parallel weights ----------
    hidden = 8 * mp  # divisible by the model axis
    params = mlp.init_mlp(gen, sizes=(3, hidden, hidden, hidden, 1), device=dev)
    state = train_lib.init_train_state(params)
    specs = mesh_lib.tp_mlp_shardings(state.params, mesh)
    batch = 16 * dp
    pts = torch.rand((batch, 3), generator=gen).to(dev) * 2 - 1
    target = torch.linalg.vector_norm(pts, dim=-1) - 0.5
    pieces = [(mesh_lib.device_put(l.w, s.w, mesh), mesh_lib.device_put(l.b, s.b, mesh))
              for l, s in zip(state.params, specs)]
    pred = _tp_apply(pieces, specs, mesh, mesh_lib.device_put(pts, ("data", None), mesh))
    loss = torch.mean((pred - target) ** 2)
    leaves = train_lib._flat(state.params)
    grads = torch.autograd.grad(loss, leaves)
    ref_loss = torch.mean((mlp.apply_scalar(state.params, pts) - target) ** 2)
    ref_grads = torch.autograd.grad(ref_loss, leaves)
    torch.testing.assert_close(loss, ref_loss, rtol=TP_RTOL, atol=TP_ATOL)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=TP_RTOL, atol=TP_ATOL)
    state = train_lib._update(state, grads, 1e-3)
    _check(all(bool(torch.isfinite(x).all()) for x in train_lib._flat(state.params)),
           "the TP step's parameters are not finite")

    # ---- EP: an expert-parallel (multi-geometry) step -----------------------
    n_experts = mp * 2
    experts = [train_lib.init_train_state(mlp.init_mlp(gen, sizes=(3, 16, 16, 1), device=dev))
               for _ in range(n_experts)]
    per_shard = n_experts // mp
    preds = [mlp.apply_scalar(e.params, pts) for m in range(mp)
             for e in experts[m * per_shard:(m + 1) * per_shard]]
    e_loss = torch.mean((torch.stack(preds) - target[None, :]) ** 2)
    e_grads = torch.autograd.grad(e_loss, [x for e in experts for x in train_lib._flat(e.params)])
    k = len(train_lib._flat(experts[0].params))
    experts = [train_lib._update(e, e_grads[i * k:(i + 1) * k], 1e-3)
               for i, e in enumerate(experts)]
    _check(bool(torch.isfinite(e_loss)), f"EP loss {float(e_loss.detach())}")

    # ---- the sharded train step, the dense march inside ---------------------
    dmesh = mesh_lib.make_mesh((n_devices,), ("data",), devices)
    r_params = _net(3, dev)
    r_cfg = RenderConfig(width=16, height=n_devices, scene="neural_raw", max_steps=16)
    tgt = torch.zeros((r_cfg.height, r_cfg.width, 4), device=dev)
    _, r_loss = pixel_train_step_sharded(train_lib.init_train_state(r_params), Camera(), tgt,
                                         r_cfg, dmesh)
    _check(bool(torch.isfinite(r_loss)), f"sharded train step loss {float(r_loss)}")

    # ---- the staged sharded render, solve and train step --------------------
    s_params = _net(4, dev)
    cam = Camera(rotation_y=25.0)
    # The plain rungs at a modest size, then the march kernel's shard body
    # (coarse pass and refine rungs in the kernel) at a small one.
    s_cfg = RenderConfig(width=64, height=8 * n_devices, scene="neural_raw", max_steps=600,
                         march_impl="staged", coarse_pallas=False, refine_pallas=False)
    img = render_image_sharded_staged(s_params, cam, s_cfg, dmesh)
    _check(tuple(img.shape) == (s_cfg.height, s_cfg.width, 4), f"staged image {img.shape}")
    k_cfg = RenderConfig(width=32, height=4 * n_devices, scene="neural_raw", max_steps=64,
                         march_impl="staged")
    img_k = render_image_sharded_staged(s_params, cam, k_cfg, dmesh)
    _check(tuple(img_k.shape) == (k_cfg.height, k_cfg.width, 4), f"kernel image {img_k.shape}")
    t_star, hit = solve_surface_sharded(s_params, cam, k_cfg, dmesh)
    s_tgt = torch.zeros((k_cfg.height, k_cfg.width, 4), device=dev)
    _, s_loss = pixel_train_step_sharded(train_lib.init_train_state(s_params), cam, s_tgt,
                                         k_cfg, dmesh, t_star=t_star, hit=hit)
    _check(bool(torch.isfinite(s_loss)), f"staged train step loss {float(s_loss)}")
