"""Camera model: view matrices and per-pixel eye-ray generation.

The PyTorch counterpart of the JAX package's ``ops/camera.py``, with the
same conventions (reference src/main.cpp:207-222 and initMarcher,
src/volumeRender_kernel.cu:305-322):
  * camera-to-world M = Rx(-rx) @ Ry(-ry) @ Translate(-T);
  * eye origin = M @ [0,0,0,1]; the default T=(0,0,-2) orbits at distance 2;
  * ray dir = normalize([u, v, -focal]) rotated by M's linear part, with
    u = x/W*2-1, v = y/H*2-1 and pixel id = y*W + x (row 0 = image bottom);
  * normal matrix = inverse(M) (world -> camera), used for matcap lookup.

All math runs in float32 on the device the caller names.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class Camera:
    """Orbit camera: rotation in degrees, translation in world units."""

    rotation_x: float = 0.0
    rotation_y: float = 0.0
    translation: Tuple[float, float, float] = (0.0, 0.0, -2.0)

    @classmethod
    def from_cli(cls, rx: float = 0.0, ry: float = 0.0, zoom: float = 2.0,
                 tx: float = 0.0, ty: float = 0.0) -> "Camera":
        """Mirror the reference CLI: -rx -ry -z (main.cpp:591-626).
        zoom z means viewTranslation.z = -z (default -2); tx/ty pan."""
        return cls(rotation_x=rx, rotation_y=ry, translation=(tx, ty, -zoom))


def pose_tensor(camera: Camera, device="cpu") -> torch.Tensor:
    """The camera's pose [rotation_x, rotation_y, tx, ty, tz] as a float32
    tensor on ``device``. On the card the values go through pinned host
    memory by a copy that does not block: a copy from pageable memory waits
    until the device has run everything queued before it, which would cost
    a pipelined turntable its overlap."""
    vals = torch.tensor([float(camera.rotation_x), float(camera.rotation_y),
                         *(float(v) for v in camera.translation)], dtype=torch.float32)
    device = torch.device(device)
    if device.type != "cuda":
        return vals.to(device)
    return vals.pin_memory().to(device, non_blocking=True)


def _rot_x(deg: torch.Tensor) -> torch.Tensor:
    a = torch.deg2rad(deg)
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([
        torch.stack([one, zero, zero]),
        torch.stack([zero, c, -s]),
        torch.stack([zero, s, c]),
    ])


def _rot_y(deg: torch.Tensor) -> torch.Tensor:
    a = torch.deg2rad(deg)
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack([
        torch.stack([c, zero, s]),
        torch.stack([zero, one, zero]),
        torch.stack([-s, zero, c]),
    ])


def view_matrices(camera, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (cam_to_world [3,4], world_to_cam [4,4]) on ``device``.
    ``camera`` is a Camera, or its ``pose_tensor`` already on the device (a
    CUDA graph's static input), from which the matrices are built with the
    same operations."""
    pose = camera if isinstance(camera, torch.Tensor) else pose_tensor(camera, device)
    r = _rot_x(-pose[0]) @ _rot_y(-pose[1])
    t = pose[2:5]
    trans = r @ (-t)  # M = R @ Translate(-t)
    cam_to_world = torch.cat([r, trans[:, None]], dim=1)
    # Inverse of [R | R@(-t); 0 0 0 1] is [R^T | t; 0 0 0 1].
    world_to_cam = torch.eye(4, dtype=torch.float32, device=pose.device)
    world_to_cam[:3, :3] = r.T
    world_to_cam[:3, 3] = t
    return cam_to_world, world_to_cam


def ray_dirs_from_index(
    cam_to_world: torch.Tensor, idx: torch.Tensor, height: int, width: int,
    focal: float = 2.0,
) -> torch.Tensor:
    """World-space ray directions [N, 3] for flat pixel indices idx [N]
    (= y*W + x). A pure function of the index and the camera, so the staged
    renderer carries only the index and recomputes directions per bucket."""
    r = cam_to_world[:, :3]
    x = (idx % width).to(torch.float32)
    y = torch.div(idx, width, rounding_mode="floor").to(torch.float32)
    u = (x / width) * 2.0 - 1.0
    v = (y / height) * 2.0 - 1.0
    d_cam = torch.stack([u, v, torch.full_like(u, -focal)], dim=-1)
    d_cam = d_cam / torch.linalg.vector_norm(d_cam, dim=-1, keepdim=True)
    return d_cam @ r.T


def generate_rays(
    cam_to_world: torch.Tensor, height: int, width: int, focal: float = 2.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel eye rays. Returns (origin [3], dirs [H*W, 3]); the origin is
    shared by all rays (pinhole)."""
    origin = cam_to_world[:, 3].contiguous()
    idx = torch.arange(height * width, dtype=torch.int32, device=cam_to_world.device)
    return origin, ray_dirs_from_index(cam_to_world, idx, height, width, focal)
