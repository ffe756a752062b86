"""Analytic SDF primitives, CSG operators and scene composition.

The PyTorch counterpart of the JAX package's ``ops/sdf.py`` (the reference's
__device__ SDF library, src/volumeRender_kernel.cu:63-230), with the same
names. Every function maps batched points ``p`` (..., 3) to distances
(...,) in float32; the sequential CSG chains (the 9-sphere union, the
300-cylinder drill) run as Python loops in the order of the JAX package's
``lax.scan``.

Float32 arithmetic follows the JAX package's compiled programs where the
two frameworks differ: XLA folds a division by a constant into a
multiplication by the constant's float32 reciprocal, so ``x / k`` is
written ``x * _recip(k)`` here (PyTorch's CUDA division by a Python scalar
does the same; its CPU division does not), and every product and sum is
rounded on its own, as PyTorch's elementwise operators do.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

# SdfFn: points (..., 3) -> distances (...,)
SdfFn = Callable[[torch.Tensor], torch.Tensor]


def _recip(k: float) -> float:
    """The float32 reciprocal of a constant divisor, as XLA folds it."""
    return float(np.float32(1.0) / np.float32(k))


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


# Constants already on a device, keyed by (bytes, shape, device); see
# device_constant.
_CONSTANTS: dict = {}


def device_constant(values, device) -> torch.Tensor:
    """``values`` as a float32 tensor on ``device``, copied from the host
    once per (values, device) and shared by every later call, so callers
    must not write into it. A copy from pageable host memory waits for the
    device's queue to drain and cannot be captured in a CUDA graph; a frame
    that builds its constants through here copies none."""
    arr = np.ascontiguousarray(values, dtype=np.float32)
    key = (arr.tobytes(), arr.shape, str(torch.device(device)))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.from_numpy(arr.copy()).to(device)
    return t


def _const(x, p: torch.Tensor) -> torch.Tensor:
    """A constant operand of an SDF over points ``p``: a tensor as given, on
    ``p``'s device and type; anything else through ``device_constant``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=p.dtype, device=p.device)
    return device_constant(x, p.device)


def frame_tensor(frame, device) -> torch.Tensor:
    """The frame number as a [] float32 tensor on ``device``: ``frame``
    itself when it is one (a CUDA graph's static input, read afresh at each
    replay), else a tensor filled on the device with ``frame`` rounded to
    float32, with no copy from the host."""
    device = torch.device(device)
    if isinstance(frame, torch.Tensor):
        if frame.dtype != torch.float32 or frame.dim() != 0 or frame.device.type != device.type:
            raise ValueError(f"a frame tensor must be a [] float32 tensor on {device}, not "
                             f"{frame.dtype} {tuple(frame.shape)} on {frame.device}")
        return frame
    return torch.full((), float(np.float32(frame)), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Primitives (reference volumeRender_kernel.cu:67-101)
# ---------------------------------------------------------------------------

def sphere(p: torch.Tensor, radius: float, center=None) -> torch.Tensor:
    """Signed distance to a sphere (reference :67-71)."""
    if center is not None:
        p = p - _const(center, p)
    return _norm(p) - radius


def box(p: torch.Tensor, half_extent, round_radius: float = 0.0) -> torch.Tensor:
    """Signed distance to an axis-aligned (rounded) box (reference :81-89)."""
    q = torch.abs(p) - _const(half_extent, p)
    outside = _norm(torch.clamp(q, min=0.0))
    inside = torch.clamp(torch.amax(q, dim=-1), max=0.0)
    return outside + inside - round_radius


def plane(p: torch.Tensor, height: float = 0.5) -> torch.Tensor:
    """Horizontal plane at y = height (reference :91-94)."""
    return p[..., 1] - height


def cylinder(p: torch.Tensor, c) -> torch.Tensor:
    """Infinite cylinder in the reference's parameterization (:96-101):
    ``length((p.x, p.y) - (c.x, c.z)) - c.y``, an infinite cylinder along z
    centered at (c.x, c.z) in the xy-plane with radius c.y."""
    c = _const(c, p)
    d = torch.stack([p[..., 0] - c[..., 0], p[..., 1] - c[..., 2]], dim=-1)
    return _norm(d) - c[..., 1]


# ---------------------------------------------------------------------------
# Operators (reference :103-149)
# ---------------------------------------------------------------------------

def displace(p: torch.Tensor, d: torch.Tensor, freq: float = 5.0,
             amp: float = 0.05) -> torch.Tensor:
    """Sine-product displacement (reference :103-110)."""
    s = torch.sin(freq * p[..., 0]) * torch.sin(freq * p[..., 1]) * torch.sin(freq * p[..., 2])
    return d + s * amp


def round_op(d: torch.Tensor, radius: float) -> torch.Tensor:
    """Round the surface outward (reference :112-115)."""
    return d - radius


def onion(d: torch.Tensor, thickness: float) -> torch.Tensor:
    """Hollow shell of given thickness (reference :117-121)."""
    return torch.abs(d) - thickness


def intersect(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    return torch.maximum(d1, d2)


def union(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    return torch.minimum(d1, d2)


def subtract(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """d1 minus d2 (reference :133-136)."""
    return torch.maximum(d1, -d2)


def smooth_subtract(d1: torch.Tensor, d2: torch.Tensor, k: float) -> torch.Tensor:
    """Polynomial smooth subtraction (reference :138-142)."""
    h = torch.clamp(0.5 - 0.5 * (d1 + d2) * _recip(k), 0.0, 1.0)
    mix = d1 * (1.0 - h) - d2 * h
    return mix + k * h * (1.0 - h)


def smooth_union(d1: torch.Tensor, d2: torch.Tensor, k: float) -> torch.Tensor:
    """Polynomial smooth union (reference :144-149)."""
    h = torch.clamp(0.5 + 0.5 * (d2 - d1) * _recip(k), 0.0, 1.0)
    mix = d2 * (1.0 - h) + d1 * h
    return mix - k * h * (1.0 - h)


# ---------------------------------------------------------------------------
# Composite demo scenes (reference :151-196)
# ---------------------------------------------------------------------------

def _many_sphere_centers() -> np.ndarray:
    """The 9 sphere centers of manySphere (reference :176-196), before the
    frame-dependent z shift. cP starts at (p.x, p.y-0.6, p.z-0.7); every
    3rd iteration bumps y by 0.4 and resets x to p.x+0.5; each iteration
    subtracts 0.4 from x after use. The offsets are added to p, so the
    world-space centers are their negation."""
    centers = []
    y = -0.6
    x = 0.0
    for i in range(9):
        if i % 3 == 0:
            y += 0.4
            x = 0.5
        centers.append((x, y, -0.7))
        x -= 0.4
    return -np.asarray(centers, dtype=np.float32)


_MANY_SPHERE_CENTERS = _many_sphere_centers()
# many_sphere_z's constants, float32 values.
_SPHERE_Z0 = float(np.float32(-0.7))
_SPHERE_Z_STEP = float(np.float32(2.0 * 0.7 / 360.0))


def many_sphere_z(frame) -> float:
    """The spheres' animated z offset ``-0.7 + frame * (2*0.7/360)`` in
    float32 (the constant rounded to float32, then one multiply and one
    add, each rounded), as the JAX package computes it from a float32
    frame (a [] tensor is read on the host). The value is exactly
    representable in float32."""
    z = np.float32(_SPHERE_Z0) + np.float32(float(frame)) * np.float32(_SPHERE_Z_STEP)
    return float(z)


def many_sphere(p: torch.Tensor, neural_d: torch.Tensor, frame,
                do_union: bool = True) -> torch.Tensor:
    """Nine animated spheres smooth-combined with the neural SDF (reference
    :176-196). The frame moves the spheres along z: the world center's z is
    ``-many_sphere_z(frame)``, computed on the device from ``frame_tensor``
    by the same two float32 roundings, so a float frame and a [] tensor
    holding it give the same distances."""
    z = frame_tensor(frame, p.device) * _SPHERE_Z_STEP + _SPHERE_Z0
    base = device_constant(_MANY_SPHERE_CENTERS, p.device)
    centers = torch.cat([base[:, :2], (-z).to(base.dtype).expand(base.shape[0], 1)], dim=1)
    d = neural_d
    for c in centers:
        sd = sphere(p - c, 0.1)
        d = smooth_union(d, sd, 0.01) if do_union else smooth_subtract(d, sd, 0.01)
    return d


def _many_cylinder_centers() -> np.ndarray:
    """The 300 cylinder offsets of manyCylinderCut (reference :156-174).

    cP starts at (p.x, p.y-0.5, p.z); every 20th iteration bumps y by 0.1
    and resets x to p.x+0.9; each iteration smooth-subtracts a cylinder
    with c=(0.02,0.02,0.02) evaluated at cP, then shifts x by -0.1. The
    accumulated (dx, dy) offsets are folded into a table."""
    offs = []
    y = -0.5
    x = 0.0
    for i in range(300):
        if i % 20 == 0:
            y += 0.1
            x = 0.9
        offs.append((x, y))
        x -= 0.1
    return np.asarray(offs, dtype=np.float32)


_MANY_CYL_OFFSETS = _many_cylinder_centers()


def many_cylinder_cut(p: torch.Tensor, neural_d: torch.Tensor) -> torch.Tensor:
    """300-cylinder drill pattern smooth-subtracted from the neural SDF
    (reference :156-174). Sequential smooth operations depend on their
    order, so this runs the whole chain in table order."""
    px, py = p[..., 0], p[..., 1]
    d = neural_d
    for ox, oy in _MANY_CYL_OFFSETS.tolist():
        # cylinder(cP, c) with cP = p + (ox, oy, 0), c = (0.02,)*3.
        dx = px + ox - 0.02
        dy = py + oy - 0.02
        cyl = torch.sqrt(dx * dx + dy * dy) - 0.02
        d = smooth_subtract(d, cyl, 0.01)
    return d


def many_cylinder_cut_windowed(p: torch.Tensor, neural_d: torch.Tensor,
                               window: int = 3) -> torch.Tensor:
    """Dense-layout twin of the march kernel's grid window
    (kernels/scenes.py): only the window x window cells around each
    point's nearest grid cell are composed, in (row, col) order. Exact
    wherever the scene distance exceeds the window's band (-0.1 for
    window 3, -0.2 for 5). Used for shading normals, whose points sit on
    the surface; the march's exactness contract keeps the full chain."""
    if window not in (1, 3, 5):
        raise ValueError(f"cyl_window must be 1, 3 or 5, not {window}")
    px, py = p[..., 0], p[..., 1]
    c0 = torch.floor((px + 0.88) * _recip(0.1) + 0.5)
    r0 = torch.floor((0.42 - py) * _recip(0.1) + 0.5)
    d = neural_d
    half = window // 2
    for dr in range(-half, half + 1):
        for dc in range(-half, half + 1):
            c = c0 + float(dc)
            r = r0 + float(dr)
            valid = (c >= 0.0) & (c <= 19.0) & (r >= 0.0) & (r <= 14.0)
            dx = px + (0.9 - 0.1 * c) - 0.02
            dy = py + (-0.4 + 0.1 * r) - 0.02
            cyl = torch.sqrt(dx * dx + dy * dy) - 0.02
            cyl = torch.where(valid, cyl, 1e9)
            d = smooth_subtract(d, cyl, 0.01)
    return d


def displacement_pattern(p: torch.Tensor, neural_d: torch.Tensor) -> torch.Tensor:
    """Sine displacement over tanh(neural) (reference :151-154)."""
    return displace(p, torch.tanh(neural_d))


# ---------------------------------------------------------------------------
# Scene registry
# ---------------------------------------------------------------------------

def make_scene(name: str, neural_fn: Optional[SdfFn] = None, frame=0.0,
               cyl_window: Optional[int] = None) -> SdfFn:
    """Compose a scene SDF from the raw neural field and CSG wrappers:
      * "neural_raw"  — the raw pre-tanh logit (reference checked-in behaviour)
      * "neural_tanh" — tanh of the logit
      * "many_sphere" / "many_sphere_cut" / "many_cylinder_cut" /
        "displacement" — the reference's demo scenes
      * "sphere"      — analytic sphere of radius 0.9, for tests

    ``cyl_window``: surface-local callers (shading normals) pass
    RenderConfig.cyl_window to get the windowed many_cylinder_cut compose;
    None keeps the complete 300-term chain.
    """
    if name == "sphere":
        return lambda p: sphere(p, 0.9)
    if neural_fn is None:
        raise ValueError(f"scene {name!r} requires a neural SDF function")
    if name == "neural_raw":
        return neural_fn
    if name == "neural_tanh":
        return lambda p: torch.tanh(neural_fn(p))
    if name == "many_sphere":
        return lambda p: many_sphere(p, neural_fn(p), frame, do_union=True)
    if name == "many_sphere_cut":
        return lambda p: many_sphere(p, neural_fn(p), frame, do_union=False)
    if name == "many_cylinder_cut":
        if cyl_window is not None:
            return lambda p: many_cylinder_cut_windowed(p, neural_fn(p), cyl_window)
        return lambda p: many_cylinder_cut(p, neural_fn(p))
    if name == "displacement":
        return lambda p: displacement_pattern(p, neural_fn(p))
    raise ValueError(f"unknown scene {name!r}")
