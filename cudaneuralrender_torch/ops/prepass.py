"""Cone-traced low-resolution depth prepass: empty-space skipping ahead of
the march (``RenderConfig.prepass_factor``).

The PyTorch counterpart of the JAX package's ``ops/prepass.py``. A
(H/f x W/f) grid of rays marches through the scene SDF with cone-safe
steps, then every full-resolution ray starts at the 3x3 min-pooled safe
depth of its low-resolution neighbourhood.

Soundness (the cone-tracing argument): a full-resolution ray from the same
pinhole origin stays within ``t * s`` of its nearest low-resolution ray at
parameter ``t``, where ``s`` is the low-resolution grid's diagonal ray
spacing. Stepping the low-resolution ray by ``(d - (s*t + m)) / (1 + s)``
keeps ``d(x) >= s*t + m`` along the whole walked segment, so every point of
every covered full-resolution ray stays at least ``m`` outside the surface
up to the recorded stop depth. Rays whose whole neighbourhood reaches
budget exhaustion are dead on arrival: sky pixels never march at full
resolution. ``m`` must dominate the SDF's error; the renderer passes the
coarse epsilon.

The loop is plain PyTorch over every low-resolution ray, masked (JAX's
``while_loop``). It reads ``any(active)`` on the host once every
``march.HOST_CHECK_EVERY`` steps, not every step: a step with no active
ray changes nothing, so the result equals the step-by-step loop's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .march import HOST_CHECK_EVERY, MarchState, init_state
from .sdf import SdfFn

_FAR = 1e30


def cone_trace(
    f: SdfFn, origin: torch.Tensor, dirs: torch.Tensor, spacing: float, *,
    margin: float, bound_center, bound_radius: float, max_steps: int = 256,
) -> torch.Tensor:
    """March low-resolution rays with cone-safe steps; return each ray's
    safe depth t_stop [N]: the parameter below which the ray's whole cone
    is provably empty (margin outside). _FAR for rays whose cone never
    meets the surface (budget death or a bounding-sphere miss)."""
    st = init_state(origin, dirs, bound_center, bound_radius)
    t, budget, active = st.t, st.budget, st.active
    t_stop = torch.full_like(t, _FAR)
    for i in range(max_steps):
        if i % HOST_CHECK_EVERY == 0 and not bool(active.any()):
            break
        d = f(origin + dirs * t[:, None])
        step = (d - (spacing * t + margin)) / (1.0 + spacing)
        arrived = active & (step <= 0.0)
        walk = active & ~arrived
        step = torch.where(walk, step, 0.0)
        budget = budget - step
        miss = walk & (budget <= 0.0)
        # arrived rays freeze their safe depth; missed rays stay _FAR
        t_stop = torch.where(arrived, t, t_stop)
        t = torch.where(walk & ~miss, t + step, t)
        active = walk & ~miss
    # Rays still active at step exhaustion: their current t is safe.
    return torch.where(active, t, t_stop)


def prepass_init(
    f: SdfFn, origin: torch.Tensor, dirs: torch.Tensor, height: int, width: int,
    factor: int, *, margin: float, bound_center, bound_radius: float,
) -> MarchState:
    """Full-resolution MarchState initialised from a cone-traced prepass.

    ``dirs`` [H*W, 3] in image order. The low-resolution grid is the
    strided subset of the full-resolution rays (row y = i*f of the full
    grid is row i of the H/f grid). Every full-resolution ray starts at the
    min-pooled safe depth of its 3x3 low-resolution neighbourhood, its
    budget charged for the skipped distance; rays whose whole neighbourhood
    missed are dead on arrival."""
    hl, wl = height // factor, width // factor
    dirs_l = dirs.reshape(height, width, 3)[::factor, ::factor].reshape(-1, 3)
    # Diagonal NDC spacing of the low-resolution grid (ray directions are
    # unit vectors from one origin; |d1 - d2| <= the NDC offset).
    spacing = 2.0 * float((1.0 / hl) ** 2 + (1.0 / wl) ** 2) ** 0.5
    t_stop = cone_trace(f, origin, dirs_l, spacing, margin=margin,
                        bound_center=bound_center, bound_radius=bound_radius)

    # 3x3 min-pool of the low-resolution depth map ("SAME": JAX pads with
    # _FAR, max_pool2d of the negation with +inf; every window holds its
    # own centre, a real value <= _FAR, so the minima are the same), then a
    # nearest upsample.
    t_map = t_stop.reshape(1, 1, hl, wl)
    t_min = -F.max_pool2d(-t_map, 3, stride=1, padding=1)[0, 0]
    t_up = t_min.repeat_interleave(factor, dim=0).repeat_interleave(factor, dim=1).reshape(-1)

    state = init_state(origin, dirs, bound_center, bound_radius)
    dead = t_up >= _FAR
    t_start = torch.maximum(state.t, torch.where(dead, state.t, t_up))
    return MarchState(
        t=t_start,
        budget=state.budget - (t_start - state.t),
        active=state.active & ~dead,
        converged=state.converged,
        steps=state.steps,
    )
