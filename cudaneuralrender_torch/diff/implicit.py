"""Differentiable rendering via the implicit function theorem.

The PyTorch counterpart of the JAX package's ``diff/implicit.py``. The
march runs WITHOUT gradients to convergence, then the gradient of the
surface parameter t* is recovered from the implicit function theorem: with
f(theta, o + t d) = 0 at the surface,

    dt*/dtheta = - (df/dtheta) / (grad_x f . d)

realized as the reattachment t = t0 - f_theta(x0) / detach(grad f . d),
where t0 and x0 carry no gradient. The forward value is one Newton step
from t0; the backward pass is the exact implicit gradient, in memory
independent of the march's length.

Every differentiated SDF is ``renderer.scene_fn(..., for_grad=True)``, the
plain chain: the fused forward kernel (K3) has no gradient. The severed
dense solve may take K3 (``config.use_pallas``): it runs under
``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.mlp import MLP
from ..ops import camera as camera_lib
from ..ops import march, shading
from ..ops.camera import Camera
from ..render.renderer import _device_of, _require_fp32_matmul, scene_fn
from ..utils.config import RenderConfig


def _raw_gradient(f, points: torch.Tensor) -> torch.Tensor:
    """Unnormalized spatial gradient of the SDF at points (..., 3), as a
    constant (no graph)."""
    with torch.enable_grad():
        p = points.detach().reshape(-1, 3).requires_grad_(True)
        (g,) = torch.autograd.grad(f(p).sum(), p)
    return g.reshape(points.shape)


def implicit_surface_t(f, origin: torch.Tensor, dirs: torch.Tensor,
                       t_star: torch.Tensor) -> torch.Tensor:
    """Reattach gradients to a converged ray parameter t_star.

    f must close over the parameters being differentiated; the returned t
    has the same forward value (up to one Newton step) but a backward rule
    implementing dt/dtheta = -f_theta / (grad_x f . d)."""
    t0 = t_star.detach()
    x0 = (origin + dirs * t0[:, None]).detach()
    g = _raw_gradient(f, x0)
    denom = torch.sum(g * dirs, dim=-1)
    # Guard near-tangent rays (|grad.d| ~ 0 -> unstable gradient).
    denom = torch.where(denom >= 0, torch.clamp(denom, min=1e-3),
                        torch.clamp(denom, max=-1e-3))
    return t0 - f(x0) / denom


@torch.no_grad()
def _solve_t_dense(params: MLP, config: RenderConfig, frame, origin, dirs):
    """Gradient-severed surface solve: the dense whole-image march (reads
    the host once a step). The trajectory is a constant with respect to
    the parameters; their sensitivity re-enters through the implicit step.
    Used when the caller did not precompute (t_star, hit) with
    diff/solve.py's ``solve_surface``."""
    result = march.sphere_trace(
        scene_fn(params, config, frame), origin.detach(), dirs.detach(),
        max_steps=config.max_steps, march_eps=config.march_eps,
        bound_center=config.bound_center, bound_radius=config.bound_radius)
    return result.t, result.hit


def _rays(params: MLP, camera: Camera, config: RenderConfig):
    dev = _device_of(params)
    cam_to_world, world_to_cam = camera_lib.view_matrices(camera, dev)
    origin, dirs = camera_lib.generate_rays(
        cam_to_world, config.height, config.width, config.focal)
    return origin, dirs, world_to_cam


def render_depth_diff(
    params: MLP, camera: Camera, config: RenderConfig, frame: float = 0.0, *,
    t_star: Optional[torch.Tensor] = None, hit: Optional[torch.Tensor] = None,
):
    """Differentiable depth map: returns (t [H*W], hit [H*W] bool, no grad
    on hit). Depth isolates the implicit-surface gradient from the shading.

    ``t_star``/``hit`` (both or neither): a precomputed gradient-severed
    surface solve, e.g. from diff/solve.py's ``solve_surface``. When
    omitted the dense march runs here."""
    if (t_star is None) != (hit is None):
        raise ValueError("pass both t_star and hit, or neither")
    params.require_dense("differentiable rendering")
    _require_fp32_matmul()
    origin, dirs, _ = _rays(params, camera, config)
    f = scene_fn(params, config, frame, for_grad=True)
    if t_star is None:
        t_star, hit = _solve_t_dense(params, config, frame, origin, dirs)
    t = implicit_surface_t(f, origin, dirs, t_star)
    return t, hit.detach()


def render_image_diff(
    params: MLP, camera: Camera, config: RenderConfig,
    matcap: Optional[torch.Tensor] = None, frame: float = 0.0, *,
    t_star: Optional[torch.Tensor] = None, hit: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable render [H, W, 4]: gradients flow from pixels to the
    parameters through the implicit surface point and the shading normal
    (``shading.shade(..., differentiable=True)``).

    Non-hit pixels are background with zero gradient (silhouette gradients
    need a soft mask loss, losses.silhouette_loss).

    ``t_star``/``hit`` (both or neither): a precomputed gradient-severed
    surface solve from diff/solve.py's ``solve_surface``. With them this is
    one SDF evaluation and one SDF gradient per pixel (plus shading);
    without them the dense march runs here, gradient-severed."""
    if (t_star is None) != (hit is None):
        raise ValueError("pass both t_star and hit, or neither")
    params.require_dense("differentiable rendering")
    _require_fp32_matmul()
    origin, dirs, world_to_cam = _rays(params, camera, config)
    f = scene_fn(params, config, frame, for_grad=True)
    if t_star is None:
        t_star, hit = _solve_t_dense(params, config, frame, origin, dirs)
    hit = hit.detach()
    t = implicit_surface_t(f, origin, dirs, t_star)
    points = origin + dirs * t[:, None]
    colors = shading.shade(
        f, points, dirs, mode=config.shading, normal_mode=config.normal_mode,
        normal_eps=config.normal_eps, world_to_cam=world_to_cam, matcap=matcap,
        differentiable=True)
    rgba = torch.where(hit[:, None], colors, 0.0)
    return rgba.reshape(config.height, config.width, 4)
