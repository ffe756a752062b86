"""Scene composition inside the march kernel.

The counterpart of the JAX package's ``pallas/scenes.py``. The march
kernel (csrc/march.cuh) composes the scene right after the layer chain,
each march step, where the reference's sceneSDF runs inside its march
kernel. ``compose_fn`` is that compose's plain version, in this package's
layout:

    compose(pts [T, 3], d [T], frame) -> [T]

It follows the JAX package's kernel-layout arithmetic, which is not quite
the dense module's (ops/sdf.py): the sphere chain is unrolled, and
many_cylinder_cut composes only a window of its 20 x 15 grid of drill
holes around each point instead of the 300-term chain.

Bit parity with the kernel: every product and sum is its own rounded
float32 operation (PyTorch's elementwise operators never contract a
multiply-add; the kernel spells each one with a round-to-nearest
intrinsic), and a division by a constant is a multiplication by the
constant's float32 reciprocal (``ops.sdf._recip``), on the CPU and on
the card alike.
"""
from __future__ import annotations

import torch

from ..ops import sdf as sdf_ops
from ..ops.sdf import _recip

#: Scene name -> the kernel's scene id (csrc/march.cuh, ``Scene``).
SCENE_IDS = {
    "neural_raw": 0,
    "neural_tanh": 1,
    "many_sphere": 2,
    "many_sphere_cut": 3,
    "many_cylinder_cut": 4,
    "displacement": 5,
}

KERNEL_SCENES = frozenset(SCENE_IDS)

#: many_cylinder_cut grid windows the kernel is instantiated for.
CYL_WINDOWS = (1, 3, 5)


def kernel_supported(scene: str) -> bool:
    """Scenes the march kernel can march (the analytic-only 'sphere' has
    no layer chain and stays on the plain dense path)."""
    return scene in KERNEL_SCENES


def _smooth_union(d1, d2, k):
    h = torch.clamp(0.5 + 0.5 * (d2 - d1) * _recip(k), 0.0, 1.0)
    return d2 * (1.0 - h) + d1 * h - k * h * (1.0 - h)


def _smooth_subtract(d1, d2, k):
    h = torch.clamp(0.5 - 0.5 * (d1 + d2) * _recip(k), 0.0, 1.0)
    return d1 * (1.0 - h) - d2 * h + k * h * (1.0 - h)


def _many_sphere(pts, d, frame, do_union):
    # ops/sdf.many_sphere with the 9-center chain unrolled (reference
    # :176-196); the centers' z is frame-animated.
    px, py, pz = pts[:, 0], pts[:, 1], pts[:, 2]
    dz = pz + sdf_ops.many_sphere_z(frame)  # center z = -z
    for cx, cy, _ in sdf_ops._MANY_SPHERE_CENTERS.tolist():
        dx = px - cx
        dy = py - cy
        sd = torch.sqrt(dx * dx + dy * dy + dz * dz) - 0.1
        d = _smooth_union(d, sd, 0.01) if do_union else _smooth_subtract(d, sd, 0.01)
    return d


def _many_cylinder_cut(pts, d, window: int):
    """ops/sdf.many_cylinder_cut through a (window x window) grid window.

    The 300 cylinders form a regular 20 x 15 grid (spacing 0.1): column c
    has center x = -0.88 + 0.1c, row r center y = 0.42 - 0.1r.
    smooth_subtract with k=0.01 is the identity wherever d_scene + d_cyl
    >= 0.01, so a cylinder matters only within 0.03 + |d_scene| of the
    point. The 5 x 5 cells around the nearest cell reproduce the full chain
    for every point with d_scene > -0.2, the 3 x 3 cells for d_scene > -0.1
    (omitted cylinders sit >= ~0.11 away); the march stops at the surface
    and never evaluates deeper points. Window 1 is a conservative
    approximation for the coarse pass only. Cells are visited in (row, col)
    order, the reference loop's order restricted to the non-identity
    subset; cells off the grid compose as a cylinder 1e9 away.
    """
    half = window // 2
    px, py = pts[:, 0], pts[:, 1]
    c0 = torch.floor((px + 0.88) * _recip(0.1) + 0.5)  # nearest column
    r0 = torch.floor((0.42 - py) * _recip(0.1) + 0.5)  # nearest row
    for dr in range(-half, half + 1):
        for dc in range(-half, half + 1):
            c = c0 + float(dc)
            r = r0 + float(dr)
            valid = (c >= 0.0) & (c <= 19.0) & (r >= 0.0) & (r <= 14.0)
            ox = 0.9 - 0.1 * c
            oy = -0.4 + 0.1 * r
            dx = px + ox - 0.02
            dy = py + oy - 0.02
            cyl = torch.sqrt(dx * dx + dy * dy) - 0.02
            cyl = torch.where(valid, cyl, 1e9)
            d = _smooth_subtract(d, cyl, 0.01)
    return d


def _displacement(pts, d):
    s = torch.sin(5.0 * pts[:, 0]) * torch.sin(5.0 * pts[:, 1]) * torch.sin(5.0 * pts[:, 2])
    return torch.tanh(d) + s * 0.05


def compose_fn(scene: str, cyl_window: int = 5):
    """Kernel-layout scene composition, or None for scenes the kernel
    does not march. ``cyl_window`` selects many_cylinder_cut's grid
    window (RenderConfig.cyl_window / cyl_window_coarse)."""
    if scene == "neural_raw":
        return lambda pts, d, frame: d
    if scene == "neural_tanh":
        return lambda pts, d, frame: torch.tanh(d)
    if scene == "many_sphere":
        return lambda pts, d, frame: _many_sphere(pts, d, frame, True)
    if scene == "many_sphere_cut":
        return lambda pts, d, frame: _many_sphere(pts, d, frame, False)
    if scene == "many_cylinder_cut":
        if cyl_window not in CYL_WINDOWS:
            raise ValueError(f"cyl_window must be 1, 3 or 5, not {cyl_window}")
        return lambda pts, d, frame: _many_cylinder_cut(pts, d, cyl_window)
    if scene == "displacement":
        return lambda pts, d, frame: _displacement(pts, d)
    return None
