"""Fast surface solve for the differentiable path.

The PyTorch counterpart of the JAX package's ``diff/solve.py``. The march
of a differentiable render is gradient-severed (every parameter
sensitivity re-enters through diff/implicit.py's reattachment), so the t*
solve may use any solver: here the staged scheduler of the inference path
(``renderer._scheduled_march``), whose coarse pass and refine rungs run in
the march kernel on the card.

    t_star, hit = solve_surface(params, camera, config)   # no gradients
    loss = pixel_loss(params, camera, config, target, t_star=t_star, hit=hit)

``solve_surface`` follows ``render_staged``'s control flow: a refine-bucket
overflow retries with a widened schedule, and a step-starved "full"
truncation falls back to the dense march. The whole solve runs under
``torch.no_grad()``, and the fast path reads the host once, for the stats
vector.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import camera as camera_lib
from ..ops import compaction, march
from ..ops.camera import Camera
from ..render import renderer as renderer_lib
from ..render import schedule
from ..utils.config import RenderConfig


def _make_check(stats: torch.Tensor, config: RenderConfig):
    """The deferred fast-path check of the async solves: fetches (or
    receives already fetched) the stats vector, applies
    ``schedule.schedule_ok`` and reports into ``stats_out``."""

    def check(stats_out: Optional[dict] = None, values=None) -> bool:
        if values is None:
            values = stats.cpu().numpy()
        st = schedule.decode(values, config)
        ok = schedule.schedule_ok(st, config)
        if stats_out is not None:
            stats_out.update(st.record(config, ok))
        return ok

    check.stats = stats  # the device tensor, for fused fetches
    return check


def _march_packed(params, camera: Camera, config: RenderConfig, frame):
    """Ray generation and ``renderer._scheduled_march``, with the frame's
    stats vector (``schedule.encode``; the converged count in place of the
    shaded hits); the bundle stays packed."""
    dev = renderer_lib._device_of(params)
    cam_to_world, _ = camera_lib.view_matrices(camera, dev)
    origin, dirs = camera_lib.generate_rays(
        cam_to_world, config.height, config.width, config.focal)
    pr, steps, refine_overflow, rungs = renderer_lib._scheduled_march(
        params, cam_to_world, origin, dirs, config, frame)
    return pr, schedule.encode(pr.active.sum(dtype=torch.int32), steps,
                               pr.converged.sum(dtype=torch.int32), refine_overflow, rungs)


@torch.no_grad()
def _solve_scheduled(params, camera: Camera, config: RenderConfig, frame):
    """The staged t* solve: the scheduled march, then a restore to image
    order of the two payloads the grad step reads. Returns (t [N],
    hit [N], stats)."""
    pr, stats = _march_packed(params, camera, config, frame)
    t, hit = compaction.sort_restore_leaves(pr.pos, (pr.t, pr.converged))
    return t, hit, stats


@torch.no_grad()
def _solve_dense(params, camera: Camera, config: RenderConfig, frame):
    """The dense whole-image solve (the exact march in the reference's
    order): the correctness fallback."""
    dev = renderer_lib._device_of(params)
    cam_to_world, _ = camera_lib.view_matrices(camera, dev)
    origin, dirs = camera_lib.generate_rays(
        cam_to_world, config.height, config.width, config.focal)
    result = march.sphere_trace(
        renderer_lib.scene_fn(params, config, frame), origin, dirs,
        max_steps=config.max_steps, march_eps=config.march_eps,
        bound_center=config.bound_center, bound_radius=config.bound_radius)
    return result.t, result.hit


def solve_surface_async(params, camera: Camera, config: RenderConfig, frame: float = 0.0):
    """Dispatch the staged t* solve WITHOUT the host stats check.

    Returns ``(t, hit, check)``: t/hit are device tensors that downstream
    work (the grad step) can be queued on at once, and ``check()`` later
    fetches the stats and returns True iff the fast path sufficed. If it
    returns False the caller discards the downstream results and redoes
    the work through the synchronous ``solve_surface``."""
    params.require_dense("the training surface solve")
    frame = float(frame)
    config = schedule.memo_lookup(params, config)
    t, hit, stats = _solve_scheduled(params, camera, config, frame)
    return t, hit, _make_check(stats, config)


def solve_surface(params, camera: Camera, config: RenderConfig, frame: float = 0.0, *,
                  stats_out: Optional[dict] = None):
    """Solve every ray's surface parameter through the staged scheduler.

    Returns ``(t_star [N], hit [N])`` in image order, on the parameters'
    device. A refine-bucket overflow retries with a widened schedule (and
    teaches the schedule memo); a schedule that leaves budgeted rays
    unresolved, or a step-starved "full"-precision truncation, falls back
    to the dense exact march."""
    params.require_dense("the training surface solve")
    frame = float(frame)
    orig_config = config
    config = schedule.memo_lookup(params, config)
    t, hit, stats = _solve_scheduled(params, camera, config, frame)
    st = schedule.decode(stats.cpu().numpy(), config)
    ok = schedule.schedule_ok(st, config)
    if stats_out is not None:
        stats_out.update(st.record(config, ok))
    if ok:
        return t, hit

    if st.refine_overflow > 0:
        # render_staged's retry rule: resize the caps from this solve's own
        # rung stats, or double every bucket; when that no longer changes
        # the config the overflow cannot clear, so finish densely.
        widened = schedule.widen_or_retune(config, st)
        if widened != config:
            result = solve_surface(params, camera, widened, frame, stats_out=stats_out)
            schedule.memo_teach(params, orig_config, widened)
            if stats_out is not None:
                stats_out.update(fast_path=False)  # the retry's own update said True
            return result

    # Also rays left unresolved (no staged continuation here), and a "full"
    # march out of steps (exact truncation, as render_staged re-renders).
    if stats_out is not None:
        stats_out.update(fast_path=False, dense_fallback=True)
    return _solve_dense(params, camera, config, frame)


@torch.no_grad()
def _solve_scheduled_packed(params, camera: Camera, config: RenderConfig, frame):
    """The staged t* solve returning the PACKED bundle (no restore sort):
    the compacted grad step re-packs by hit anyway
    (losses.pixel_loss_packed). Returns (pos, t, conv, stats)."""
    pr, stats = _march_packed(params, camera, config, frame)
    return pr.pos, pr.t, pr.converged, stats


def solve_surface_packed_async(params, camera: Camera, config: RenderConfig,
                               frame: float = 0.0):
    """The packed-bundle twin of ``solve_surface_async``: returns (pos, t,
    conv, within, check), where ``within`` bounds the prefix that holds
    every converged lane (None when the bundle gives no bound; callers then
    use the image-order path). Same deferred-check contract."""
    params.require_dense("the training surface solve")
    frame = float(frame)
    config = schedule.memo_lookup(params, config)
    pos, t, conv, stats = _solve_scheduled_packed(params, camera, config, frame)
    return pos, t, conv, schedule.conv_within(config), _make_check(stats, config)
