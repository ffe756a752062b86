"""Sphere tracing through an SDF: the plain (dense, masked) march.

The PyTorch counterpart of the JAX package's ``ops/march.py``. Every ray's
state is a flat [N] tensor; a step evaluates the SDF on all rays and
updates them under masks, ordered exactly like singleMarch
(src/volumeRender_kernel.cu:459-476):
  1. dist = sdf(point)
  2. budget -= dist; if budget <= 0 -> miss (ray never moves this step)
  3. point += dir * dist
  4. if dist < eps -> converged

These loops run eagerly and read ``active.any()`` on the host once per
step. The staged renderer uses them only where a rung's bucket is the whole
image (small images) and on its rare host-driven continuation; its hot
rungs go through the march kernel (kernels/megakernel.py).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .sdf import SdfFn, device_constant


class MarchState(NamedTuple):
    """Per-ray march state (flat [N] tensors; points are recomputed as
    origin + dir * t each step)."""

    t: torch.Tensor          # [N] float32 distance travelled along the ray
    budget: torch.Tensor     # [N] float32 remaining march budget
    active: torch.Tensor     # [N] bool: still marching
    converged: torch.Tensor  # [N] bool: hit surface
    steps: torch.Tensor      # [] int32 iterations executed (stays on device)


class MarchResult(NamedTuple):
    t: torch.Tensor          # [N] ray parameter of the final point
    hit: torch.Tensor        # [N] bool: converged on the surface
    steps: torch.Tensor      # [] int32 steps taken by the loop
    active: torch.Tensor     # [N] bool: unresolved at loop exit


def _steps_tensor(steps: int, device) -> torch.Tensor:
    # Filled on the device: a copy from the host would wait for its queue.
    return torch.full((), int(steps), dtype=torch.int32, device=device)


def intersect_sphere(
    origin: torch.Tensor, dirs: torch.Tensor, center, radius: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Analytic ray/sphere intersection (reference intersectSphere,
    volumeRender_kernel.cu:200-215). origin [3] or [N,3]; dirs [N,3].
    Returns (tnear [N], tfar [N], hit [N] bool); grazing rays (disc == 0)
    miss, as in the reference."""
    center = center if isinstance(center, torch.Tensor) else device_constant(center, dirs.device)
    q = origin - center.to(dirs.dtype)
    a = torch.sum(dirs * dirs, dim=-1)
    b = 2.0 * torch.sum(q * dirs, dim=-1)
    c = torch.sum(q * q, dim=-1) - radius * radius
    disc = b * b - 4.0 * a * c
    hit = disc > 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    tnear = (-b - sq) / (2.0 * a)
    tfar = (-b + sq) / (2.0 * a)
    return tnear, tfar, hit


def init_state(origin: torch.Tensor, dirs: torch.Tensor, bound_center,
               bound_radius: float, t_init: torch.Tensor | None = None,
               warm_margin: float = 0.0) -> MarchState:
    """Per-ray init: bounding-sphere cull, start at the sphere's near
    intersection with the budget tfar (reference initMarcher,
    volumeRender_kernel.cu:293-358). Rays that miss start inactive.

    ``t_init`` [N] (temporal warm start): each ray's suggested start depth
    from an earlier frame of a smooth camera path; non-finite or
    non-positive lanes mean "no suggestion" (cold). A warm lane starts at
    ``clip(t_init - warm_margin, tnear, tfar)`` with the budget reduced to
    keep ``budget == tfar - (t - tnear)``. The caller probes the warm points
    for lanes that start inside the surface (render/renderer.py
    ``_warm_guard``)."""
    tnear, tfar, hit = intersect_sphere(origin, dirs, bound_center, bound_radius)
    tnear = torch.clamp(tnear, min=0.0)
    zero = torch.zeros_like(tnear)
    t = torch.where(hit, tnear, zero)
    budget = torch.where(hit, tfar, zero)
    if t_init is not None:
        warm = hit & torch.isfinite(t_init) & (t_init > 0.0)
        t_w = torch.minimum(torch.maximum(t_init - warm_margin, tnear), tfar)
        t = torch.where(warm, t_w, t)
        budget = torch.where(warm, tfar - (t_w - tnear), budget)
    return MarchState(
        t=t,
        budget=budget,
        active=hit,
        converged=torch.zeros_like(hit),
        steps=_steps_tensor(0, dirs.device),
    )


def march_step(sdf_fn: SdfFn, origin: torch.Tensor, dirs: torch.Tensor,
               s: MarchState, march_eps: float) -> MarchState:
    """One dense masked sphere-trace step over all rays (singleMarch order)."""
    pts = origin + dirs * s.t[:, None]
    dist = sdf_fn(pts)
    budget = s.budget - torch.where(s.active, dist, torch.zeros_like(dist))
    miss = s.active & (budget <= 0.0)
    moved = s.active & ~miss
    t = torch.where(moved, s.t + dist, s.t)
    conv_now = moved & (dist < march_eps)
    return MarchState(
        t=t,
        budget=budget,
        active=moved & ~conv_now,
        converged=s.converged | conv_now,
        steps=s.steps + 1,
    )


def sphere_trace(
    sdf_fn: SdfFn, origin: torch.Tensor, dirs: torch.Tensor, *,
    max_steps: int = 6000, march_eps: float = 1e-6,
    bound_center=(0.0, 0.0, 0.0), bound_radius: float = 1.2,
) -> MarchResult:
    """Dense masked sphere trace until every ray resolves or max_steps."""
    s = init_state(origin, dirs, bound_center, bound_radius)
    s = march_stage(sdf_fn, origin, dirs, s, num_steps=max_steps,
                    max_steps=max_steps, march_eps=march_eps)
    return MarchResult(t=s.t, hit=s.converged, steps=s.steps, active=s.active)


def sphere_trace_unrolled(
    sdf_fn: SdfFn, origin: torch.Tensor, dirs: torch.Tensor, *,
    num_steps: int, march_eps: float = 1e-6,
    bound_center=(0.0, 0.0, 0.0), bound_radius: float = 1.2,
) -> MarchResult:
    """Fixed-length dense march of exactly ``num_steps`` steps."""
    s = init_state(origin, dirs, bound_center, bound_radius)
    for _ in range(num_steps):
        s = march_step(sdf_fn, origin, dirs, s, march_eps)
    return MarchResult(t=s.t, hit=s.converged, steps=s.steps, active=s.active)


def march_stage(
    sdf_fn: SdfFn, origin: torch.Tensor, dirs: torch.Tensor, state: MarchState,
    *, num_steps, max_steps: int, march_eps: float,
    relax_omega: float = 0.0, newton: bool = False, omega_max: float = 8.0,
) -> MarchState:
    """Advance an existing state by up to ``num_steps`` steps (stops early
    when no ray is active, and at ``max_steps`` in total).

    ``relax_omega`` > 1 enables over-relaxed stepping for this stage
    (``march_stage_relaxed``); 0/1 keeps the reference's plain stepping.
    """
    if relax_omega and relax_omega > 1.0:
        return march_stage_relaxed(
            sdf_fn, origin, dirs, state,
            num_steps=num_steps, max_steps=max_steps, march_eps=march_eps,
            omega=relax_omega, newton=newton, omega_max=omega_max,
        )
    step = start = int(state.steps)
    limit = min(max_steps, start + int(num_steps))
    s = state
    while step < limit and bool(s.active.any()):
        s = march_step(sdf_fn, origin, dirs, s, march_eps)
        step += 1
    return s._replace(steps=_steps_tensor(step, dirs.device))


def march_stage_relaxed(
    sdf_fn: SdfFn, origin: torch.Tensor, dirs: torch.Tensor, state: MarchState,
    *, num_steps, max_steps: int, march_eps: float,
    omega: float = 1.4, newton: bool = False, omega_max: float = 8.0,
) -> MarchState:
    """Over-relaxed sphere tracing stage (Keinert et al. 2014), the same
    masked per-ray state machine as the JAX package's.

    Each active ray steps ``omega * d``. When consecutive safety spheres
    stop overlapping (``d + prev_r < step_len`` after an overstep) the ray
    backtracks to the previous plain-step position and steps plainly once
    (``step_len < 0`` marks the backtrack), then re-arms. The budget is
    charged the distance actually travelled (backtracks refund it); the
    convergence test still compares the raw SDF value with eps.

    ``newton=True`` makes the factor adaptive per ray from the secant slope
    of the SDF along the ray, g = (prev_r - d) / step_len: the ray steps
    clip(1/g, 1, omega_max) * d while g > 0, ``omega`` * d where g <= 0
    (receding), and plainly before its first move. Oversteps are still
    checked and backtracked as above.
    """
    step = start = int(state.steps)
    limit = min(max_steps, start + int(num_steps))
    s = state
    prev_r = torch.zeros_like(s.t)
    step_len = torch.zeros_like(s.t)
    zero = torch.zeros_like(s.t)
    while step < limit and bool(s.active.any()):
        pts = origin + dirs * s.t[:, None]
        d = sdf_fn(pts)
        overstepped = step_len > prev_r
        sor_fail = s.active & overstepped & (d + prev_r < step_len)
        near = s.active & ~sor_fail & (d < march_eps)
        if newton:
            valid = step_len > 0.0
            g = (prev_r - d) / torch.clamp(step_len, min=1e-20)
            adaptive = torch.clamp(1.0 / torch.clamp(g, min=1.0 / omega_max), 1.0,
                                   float(omega_max))
            om = torch.where(valid & (g > 0.0), adaptive,
                             torch.where(valid, torch.full_like(d, float(omega)),
                                         torch.ones_like(d)))
        else:
            om = torch.where(step_len < 0.0, torch.ones_like(d),
                             torch.full_like(d, float(omega)))
        stepv = torch.where(sor_fail, prev_r - step_len, torch.where(near, d, om * d))
        budget = s.budget - torch.where(s.active, stepv, zero)
        miss = s.active & ~sor_fail & (budget <= 0.0)
        moved = s.active & ~miss
        conv_now = moved & near
        s = MarchState(
            t=torch.where(moved, s.t + stepv, s.t),
            budget=budget,
            active=moved & ~conv_now,
            converged=s.converged | conv_now,
            steps=s.steps,
        )
        prev_r = torch.where(moved & ~sor_fail, d, prev_r)
        step_len = torch.where(moved, stepv, step_len)
        step += 1
    return s._replace(steps=_steps_tensor(step, dirs.device))
