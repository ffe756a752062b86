"""Surface normals and shading (facing-ratio + matcap).

The PyTorch counterpart of the JAX package's ``ops/shading.py``
(reference src/volumeRender_kernel.cu:361-413). Normals come from
``torch.autograd.grad`` of the SDF with respect to the points, so shading
needs autograd: it runs under ``torch.enable_grad()``, and a render must
not run under ``torch.inference_mode()`` (inference tensors cannot enter
autograd).
"""
from __future__ import annotations

import numpy as np
import torch

from .sdf import SdfFn

# Tetrahedron vertices for the 4-tap normal estimate
# (reference tetrahedronVerts, volumeRender_kernel.cu:38-43).
TETRAHEDRON_VERTS = np.array(
    [
        [1.0, -1.0, -1.0],
        [-1.0, -1.0, 1.0],
        [-1.0, 1.0, -1.0],
        [1.0, 1.0, 1.0],
    ],
    dtype=np.float32,
)

# fl(1/255) in float32, applied as a multiply (see unpack_rgba_u32).
_INV_255 = float(np.float32(1.0 / 255.0))


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def autodiff_normals(sdf_fn: SdfFn, points: torch.Tensor, *,
                     differentiable: bool = False) -> torch.Tensor:
    """Exact unit normals: normalize(grad sdf). points (..., 3) -> (..., 3).

    Each SDF value depends on its own point only, so the gradient of the
    sum is every point's own gradient (the JAX package's vmap(grad)).

    By default the normals are constants: the points are detached and the
    gradient records no graph, which is all a render needs.
    ``differentiable=True`` keeps the incoming points in the graph and
    records the gradient's own graph, so a loss on the normals reaches the
    parameters ``sdf_fn`` closes over and the points (the training path,
    diff/implicit.py)."""
    with torch.enable_grad():
        p = points.reshape(-1, 3)
        if not (differentiable and p.requires_grad):
            p = p.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(sdf_fn(p).sum(), p, create_graph=differentiable)
    return _normalize(g).reshape(points.shape)


def tetrahedron_normals(sdf_fn: SdfFn, points: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """4-tap finite-difference normals (reference surfaceNormal,
    volumeRender_kernel.cu:362-377): n = normalize(sum_i v_i * sdf(p + v_i*eps));
    the four offsets evaluate as one [4N, 3] batch."""
    verts = torch.as_tensor(TETRAHEDRON_VERTS, device=points.device)
    flat = points.reshape(-1, 3)
    offs = flat[:, None, :] + verts[None, :, :] * eps
    d = sdf_fn(offs.reshape(-1, 3)).reshape(-1, 4)
    return _normalize(d @ verts).reshape(points.shape)


def pack_rgba_u32(colors: torch.Tensor) -> torch.Tensor:
    """[..., 4] float rgba in [0,1] -> [...] packed a<<24|b<<16|g<<8|r.

    Rounding mirrors the reference's rgbaFloatToInt
    (volumeRender_kernel.cu:266-274): saturate to [0,1], scale by 255,
    truncate. PyTorch's uint32 supports few bit operations, so the packed
    value is held in int64 (its low 32 bits are the u32 word).
    """
    c = (torch.clamp(colors, 0.0, 1.0) * 255.0).to(torch.int64)
    return (c[..., 3] << 24) | (c[..., 2] << 16) | (c[..., 1] << 8) | c[..., 0]


def unpack_rgba_u32(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_rgba_u32: [...] packed -> [..., 4] float rgba.

    Multiplies by fl(1/255) — never divides — so trunc(result*255)
    recovers every byte exactly, as in the JAX package."""
    packed = packed.to(torch.int64)
    u8 = torch.stack(
        [packed & 0xFF, (packed >> 8) & 0xFF, (packed >> 16) & 0xFF, (packed >> 24) & 0xFF],
        dim=-1,
    )
    return u8.to(torch.float32) * _INV_255


def facing_color(normals: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Facing-ratio grayscale (reference facingColor,
    volumeRender_kernel.cu:381-384): max(0, dot(n, -dir)) in rgb, alpha=1."""
    ratio = torch.clamp(torch.sum(normals * -dirs, dim=-1), min=0.0)
    return torch.stack([ratio, ratio, ratio, torch.ones_like(ratio)], dim=-1)


def matcap_color(normals: torch.Tensor, world_to_cam: torch.Tensor,
                 matcap: torch.Tensor) -> torch.Tensor:
    """Matcap lookup (reference matCapColor, volumeRender_kernel.cu:388-413):
    eye-space normal, [-1,1] -> texel by truncation, nearest gather.
    matcap [Hm, Wm, C] float in [0,1], row 0 = first PNG row."""
    n_eye = _normalize(normals @ world_to_cam[:3, :3].T)
    hm, wm = matcap.shape[0], matcap.shape[1]
    ux = (n_eye[..., 0] * 0.5 + 0.5) * (wm - 1)
    uy = (n_eye[..., 1] * 0.5 + 0.5) * (hm - 1)
    ix = torch.clamp(ux.to(torch.int32), 0, wm - 1).long()
    iy = torch.clamp(uy.to(torch.int32), 0, hm - 1).long()
    texels = matcap[iy, ix]
    if texels.shape[-1] == 3:
        texels = torch.cat([texels, torch.ones_like(texels[..., :1])], dim=-1)
    return texels


def shade(
    sdf_fn: SdfFn, points: torch.Tensor, dirs: torch.Tensor, *,
    mode: str = "facing", normal_mode: str = "autodiff", normal_eps: float = 1e-5,
    world_to_cam: torch.Tensor | None = None, matcap: torch.Tensor | None = None,
    differentiable: bool = False,
) -> torch.Tensor:
    """rgba colours for surface points. points/dirs (..., 3) -> (..., 4).

    ``differentiable=True`` makes autodiff normals carry gradients to the
    SDF's parameters and the points (``autodiff_normals``); the
    tetrahedron normals are differentiable either way."""
    if normal_mode == "autodiff":
        normals = autodiff_normals(sdf_fn, points, differentiable=differentiable)
    elif normal_mode == "tetrahedron":
        normals = tetrahedron_normals(sdf_fn, points, normal_eps)
    else:
        raise ValueError(f"unknown normal_mode {normal_mode!r}")
    if mode == "facing":
        return facing_color(normals, dirs)
    if mode == "matcap":
        if matcap is None or world_to_cam is None:
            raise ValueError("matcap shading requires a matcap texture and world_to_cam")
        return matcap_color(normals, world_to_cam, matcap)
    raise ValueError(f"unknown shading mode {mode!r}")
