"""Scene-adaptive bounding-sphere fitting.

The PyTorch counterpart of the JAX package's ``ops/bounds.py``. The
reference hardcodes its cull/budget sphere at r=1.2 around the origin
(volumeRender_kernel.cu:325-328). A tighter sphere kills sky rays inside
the bound's silhouette in fewer steps and shortens the budget of grazing
rays. Every hit point lies inside the fitted sphere, so the reference's
budget invariant (total march <= tfar) still covers every hit; step counts
change, so this is a mixed-path option (march_precision="full" keeps the
configured bound).

The fit probes the scene SDF on a coarse grid over the configured bound's
cube, keeps cells within a Lipschitz threshold of the surface, and returns
the smallest axis-aligned covering sphere plus margins for the grid
resolution and the network's error.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def fit_bound_sphere(
    sdf_fn, base_center, base_radius: float, *, res: int = 48,
    err_margin: float = 0.05, device=None,
) -> Tuple[Tuple[float, float, float], float]:
    """Fit a tight bounding sphere around the zero level set of ``sdf_fn``.

    Probes a res³ grid spanning the base sphere's cube (points on
    ``device``, default the CPU; it must be where ``sdf_fn``'s weights
    live). A cell is surface-adjacent when |d| <= cell diagonal +
    err_margin (the margin absorbs the neural field's departure from
    1-Lipschitz). Returns (center, radius) as Python floats, or the base
    bound when nothing qualifies or the fit is not smaller.
    """
    base_center = np.asarray(base_center, np.float32)
    axis = np.linspace(-base_radius, base_radius, res, dtype=np.float32)
    cell = float(axis[1] - axis[0])
    gx, gy, gz = np.meshgrid(axis, axis, axis, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3) + base_center

    with torch.no_grad():
        d = sdf_fn(torch.as_tensor(pts, device=device)).cpu().numpy()
    thresh = cell * np.sqrt(3.0) + err_margin
    near = np.abs(d) <= thresh
    if not near.any():
        return tuple(float(v) for v in base_center), float(base_radius)

    p = pts[near]
    lo, hi = p.min(axis=0), p.max(axis=0)
    center = (lo + hi) / 2.0
    radius = float(np.linalg.norm(p - center, axis=1).max() + cell + err_margin)
    if radius >= base_radius:
        return tuple(float(v) for v in base_center), float(base_radius)
    return tuple(float(v) for v in center), radius
