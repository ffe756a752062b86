"""Losses for inverse rendering and SDF distillation.

The PyTorch counterpart of the JAX package's ``diff/losses.py``. Every
shading chain here runs in FP32, so ``config.grad_shade_precision``
selects nothing (as ``renderer.shade_fn`` states for
``shade_precision``): the JAX package's HIGH shading chain is a TPU
matmul-pass setting with no counterpart in these plain chains.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models import mlp
from ..models.mlp import MLP
from ..ops import camera as camera_lib
from ..ops import compaction, march, shading
from ..ops.camera import Camera
from ..render.renderer import _device_of, _require_fp32_matmul, scene_fn
from ..utils.config import RenderConfig
from .implicit import implicit_surface_t, render_image_diff


def pixel_loss(
    params: MLP, camera: Camera, config: RenderConfig, target: torch.Tensor,
    matcap: Optional[torch.Tensor] = None, frame: float = 0.0, *,
    t_star: Optional[torch.Tensor] = None, hit: Optional[torch.Tensor] = None,
    compact_cap: Optional[int] = None,
) -> torch.Tensor:
    """Mean squared error of a differentiable render against a target
    [H, W, 4] image.

    ``t_star``/``hit``: a precomputed gradient-severed surface solve
    (diff/solve.py's ``solve_surface``): the march leaves the differentiated
    work entirely.

    ``compact_cap`` (requires t_star/hit): differentiate the shading of
    ONLY the hit rays, packed into a [compact_cap] bucket. Background
    pixels contribute a constant residual summed without autograd, so the
    loss value equals the dense formula while the differentiated work
    shrinks from the whole image to the foreground. The caller must pick
    compact_cap >= the hit count (``compaction.capacity_pow2_of`` on the
    solve's hit count, as train.pixel_train_step_fast does): an overflow
    would drop hit pixels from the loss.
    """
    if compact_cap is not None:
        if t_star is None or hit is None:
            raise ValueError("compact_cap requires a precomputed t_star/hit")
        return _pixel_loss_compact(params, camera, config, target, matcap, frame,
                                   t_star, hit, compact_cap)
    img = render_image_diff(params, camera, config, matcap, frame, t_star=t_star, hit=hit)
    return torch.mean((img - target) ** 2)


def _shade_bucket(params, config: RenderConfig, frame, cam_to_world, world_to_cam, pos,
                  t_sub, matcap):
    """Differentiable colours of a packed bucket of rays (pixel indices
    ``pos``, severed surface parameters ``t_sub``). Every evaluation sits
    at the solved surface, so the compose may be surface-local."""
    f = scene_fn(params, config, frame, for_grad=True, surface_local=True)
    origin = cam_to_world[:, 3]
    d_sub = camera_lib.ray_dirs_from_index(
        cam_to_world, pos, config.height, config.width, config.focal)
    t = implicit_surface_t(f, origin, d_sub, t_sub)
    points = origin + d_sub * t[:, None]
    return shading.shade(
        f, points, d_sub, mode=config.shading, normal_mode=config.normal_mode,
        normal_eps=config.normal_eps, world_to_cam=world_to_cam, matcap=matcap,
        differentiable=True)


def _pixel_loss_compact(params, camera, config, target, matcap, frame, t_star, hit,
                        cap: int) -> torch.Tensor:
    _require_fp32_matmul()
    dev = _device_of(params)
    cam_to_world, world_to_cam = camera_lib.view_matrices(camera, dev)
    hit = hit.detach()
    tgt = target.reshape(-1, 4)
    # Pack the hit lanes into a dense prefix with one sort; every sorted
    # leaf is a severed constant, so the sort never enters the backward
    # pass. Directions are rebuilt from the carried pixel index.
    pos = torch.arange(tgt.shape[0], dtype=torch.int32, device=dev)
    pos_h, t_h, tgt_h = compaction.sort_pack_leaves(hit, (pos, t_star.detach(), tgt))
    valid = torch.arange(min(cap, tgt.shape[0]), device=dev) < hit.sum()
    colors = _shade_bucket(params, config, frame, cam_to_world, world_to_cam, pos_h[:cap],
                           t_h[:cap], matcap)
    fg = torch.sum(torch.where(valid[:, None], colors - tgt_h[:cap], 0.0) ** 2)
    # Background residual: a miss renders the constant 0 (no parameter
    # dependence), so it is summed without autograd.
    bg = torch.sum(torch.where(hit[:, None], 0.0, tgt ** 2))
    return (fg + bg) / tgt.numel()


def pixel_loss_packed(
    params: MLP, camera: Camera, config: RenderConfig, target: torch.Tensor,
    pos: torch.Tensor, t_packed: torch.Tensor, conv: torch.Tensor, cap: int,
    within: Optional[int] = None, matcap: Optional[torch.Tensor] = None,
    frame: float = 0.0,
) -> torch.Tensor:
    """``pixel_loss`` with ``compact_cap``, consuming the solve's PACKED
    bundle (diff/solve.py's ``solve_surface_packed_async``): the solve
    skips its whole-image restore sort, and the hit pack here sorts only
    the first ``within`` lanes (``renderer._conv_within``: in the mixed
    path every converged lane lives in the first refine bucket), with the
    target rows gathered by the carried pixel index.

    The loss value equals the dense formula up to summation order: the
    background residual is the total target energy minus the hit rows'
    energy, and the hits follow the bundle's packed order.
    """
    _require_fp32_matmul()
    dev = _device_of(params)
    cam_to_world, world_to_cam = camera_lib.view_matrices(camera, dev)
    pos, t_packed, conv = pos.detach(), t_packed.detach(), conv.detach()
    tgt = target.reshape(-1, 4)
    n = pos.shape[0]
    w = within if (within is not None and within < n) else n
    cap = min(cap, w)  # the bucket can never exceed the sorted prefix
    pos_h, t_h = compaction.sort_pack_leaves(conv[:w], (pos[:w], t_packed[:w]))
    pos_sub = pos_h[:cap]
    valid = torch.arange(cap, device=dev) < conv.sum()
    colors = _shade_bucket(params, config, frame, cam_to_world, world_to_cam, pos_sub,
                           t_h[:cap], matcap)
    tgt_sub = tgt[pos_sub.long()]
    fg = torch.sum(torch.where(valid[:, None], colors - tgt_sub, 0.0) ** 2)
    hit_energy = torch.sum(torch.where(valid[:, None], tgt_sub ** 2, 0.0))
    bg = torch.sum(tgt ** 2) - hit_energy
    return (fg + bg) / tgt.numel()


def silhouette_loss(
    params: MLP, camera: Camera, config: RenderConfig, target_mask: torch.Tensor,
    sharpness: float = 50.0,
) -> torch.Tensor:
    """Soft-mask loss giving gradients to *non-hit* rays.

    The implicit pixel gradient exists only where rays converge. The
    minimum SDF value along each ray (64 fixed-depth samples) squashed
    through a sigmoid approximates the hit probability; binary cross
    entropy against the target mask moves the surface toward uncovered
    pixels and away from covered ones. It evaluates 64 points a ray under
    autograd: keep it to small images.
    """
    _require_fp32_matmul()
    dev = _device_of(params)
    cam_to_world, _ = camera_lib.view_matrices(camera, dev)
    origin, dirs = camera_lib.generate_rays(
        cam_to_world, config.height, config.width, config.focal)
    f = scene_fn(params, config, 0.0, for_grad=True)
    tnear, tfar, hit = march.intersect_sphere(
        origin, dirs, config.bound_center, config.bound_radius)
    tnear = torch.clamp(tnear, min=0.0)
    alphas = torch.linspace(0.0, 1.0, 64, device=dev)
    ts = tnear[:, None] + (tfar - tnear)[:, None] * alphas[None, :]  # [N, S]
    pts = origin + dirs[:, None, :] * ts[..., None]  # [N, S, 3]
    d = f(pts.reshape(-1, 3)).reshape(ts.shape)
    # amin shares the gradient among tied minima, as jnp.min does.
    min_d = torch.amin(torch.where(hit[:, None], d, torch.inf), dim=-1)
    min_d = torch.where(hit, min_d, 1.0)
    p_hit = torch.sigmoid(-sharpness * min_d)  # inside/near -> 1
    tgt = target_mask.reshape(-1).to(torch.float32)
    eps = 1e-6
    bce = -(tgt * torch.log(p_hit + eps) + (1 - tgt) * torch.log(1 - p_hit + eps))
    return torch.mean(bce)


def sdf_distillation_loss(params: MLP, points: torch.Tensor,
                          target_d: torch.Tensor) -> torch.Tensor:
    """MSE on raw SDF logits at sample points (teacher-student distillation,
    or fitting an analytic SDF)."""
    pred = mlp.apply_scalar(params, points)
    return torch.mean((pred - target_d) ** 2)


def eikonal_loss(params: MLP, points: torch.Tensor) -> torch.Tensor:
    """|grad f| = 1 regularizer: keeps the learned field a metric SDF, so
    sphere-tracing steps stay valid. The spatial gradient records its own
    graph (``create_graph``), so the loss reaches the parameters."""
    with torch.enable_grad():
        p = points.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(mlp.apply_scalar(params, p).sum(), p, create_graph=True)
    norms = torch.linalg.vector_norm(g, dim=-1)
    return torch.mean((norms - 1.0) ** 2)
