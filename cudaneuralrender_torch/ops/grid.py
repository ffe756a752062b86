"""Baked distance-grid acceleration: empty-space skipping without the MLP
(``RenderConfig.grid_res``).

The PyTorch counterpart of the JAX package's ``ops/grid.py``. The scene SDF
is baked into a coarse res^3 grid once per frame (res^3 evaluations), and
rays march through the grid with conservative steps:

    step = trilinear(grid, x) - safety,   safety = the cell diagonal

which cannot cross the surface as long as the SDF is 1-Lipschitz (the
assumption sphere tracing itself makes: trilinear interpolation of a
1-Lipschitz field errs by at most half a cell diagonal, and the other half
covers the variation inside a cell). A ray stops walking where the grid
distance falls under ``exit_dist`` (the march takes it from there) or its
budget dies (a miss that never evaluated the MLP).

The walk is plain PyTorch over every lane, masked (JAX's ``while_loop``):
eight gathers and the lerps a step. It reads its loop flag on the host once
every ``march.HOST_CHECK_EVERY`` steps, and the step counter lives on the
device and advances only on steps the JAX loop runs (``steps += cond``): a
step with the flag down changes nothing else, so ``t``, the budget, the
masks and ``steps`` (which the march carries on against ``max_steps``)
equal the step-by-step loop's.
"""
from __future__ import annotations

import torch

from .march import HOST_CHECK_EVERY, MarchState
from .sdf import SdfFn


def bake(f: SdfFn, res: int, bound: float, *, device="cuda") -> torch.Tensor:
    """Sample the scene SDF at the centres of a res^3 grid over
    [-bound, bound]^3 on ``device`` (default the card); re-baked every
    frame, so animated and CSG scenes need no invalidation."""
    axis = torch.arange(res, dtype=torch.float32, device=device)
    axis = (axis + 0.5) / res * (2 * bound) - bound
    gx, gy, gz = torch.meshgrid(axis, axis, axis, indexing="ij")
    pts = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
    return f(pts).reshape(res, res, res)


def trilinear(grid: torch.Tensor, x: torch.Tensor, bound: float) -> torch.Tensor:
    """Trilinear interpolation of ``grid`` at world points x (..., 3).

    Coordinates clamp to the cell-centre lattice (every march point lies
    inside the bounding sphere, which the lattice covers)."""
    res = grid.shape[0]
    c = (x + bound) / (2 * bound) * res - 0.5  # cell-centre coordinates
    c = torch.clamp(c, 0.0, res - 1.000001)
    i0 = torch.floor(c).to(torch.int64)
    frac = c - i0
    i1 = torch.clamp(i0 + 1, max=res - 1)
    flat = grid.reshape(-1)

    def at(ix, iy, iz):
        return torch.take(flat, (ix * res + iy) * res + iz)

    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]

    c00 = at(x0, y0, z0) * (1 - fx) + at(x1, y0, z0) * fx
    c10 = at(x0, y1, z0) * (1 - fx) + at(x1, y1, z0) * fx
    c01 = at(x0, y0, z1) * (1 - fx) + at(x1, y0, z1) * fx
    c11 = at(x0, y1, z1) * (1 - fx) + at(x1, y1, z1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def grid_march(
    grid: torch.Tensor, origin: torch.Tensor, dirs: torch.Tensor, state: MarchState, *,
    bound: float, max_steps: int, grid_steps: int = 128, safety: float | None = None,
    exit_factor: float = 2.0,
) -> MarchState:
    """Advance rays through the baked grid until near the surface or a miss.

    Rays whose interpolated distance is above ``exit_dist`` step by
    (distance - safety); the rest hold position and stay active for the
    march. Convergence is never declared here. The budget decrements by the
    distance moved, so a ray that exhausts it inside the grid is a miss
    that never evaluated the MLP. The loop runs while some ray walks, for
    at most ``grid_steps`` steps and while ``steps < max_steps``."""
    res = grid.shape[0]
    if safety is None:
        safety = (2 * bound / res) * (3.0 ** 0.5)
    exit_dist = exit_factor * safety
    t, budget, active, steps = state.t, state.budget, state.active, state.steps
    cond = None
    # steps - start <= i < grid_steps inside this loop: the JAX loop's
    # grid_steps test always holds here.
    for i in range(grid_steps):
        if cond is not None and i % HOST_CHECK_EVERY == 0 and not bool(cond):
            break
        step = trilinear(grid, origin + dirs * t[:, None], bound) - safety
        walk = active & (step > exit_dist)
        cond = (steps < max_steps) & walk.any()
        walk = walk & cond
        step = torch.where(walk, step, 0.0)
        budget = budget - step
        miss = walk & (budget <= 0.0)
        t = torch.where(walk & ~miss, t + step, t)
        active = active & ~miss
        steps = steps + cond.to(steps.dtype)
    return MarchState(t=t, budget=budget, active=active, converged=state.converged,
                      steps=steps)
