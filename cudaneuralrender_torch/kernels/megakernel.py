"""The march kernel: the whole sphere trace of every ray in one launch.

The counterpart of the JAX package's ``pallas/megakernel.py``.
``march_state`` continues an existing march state (the counterpart of
``march_pallas_state``): on CUDA tensors it launches the hand-written
kernel in ``csrc/march.cuh``; on CPU tensors it runs ``march_state_plain``,
the same per-ray semantics in plain PyTorch. There is no fallback between
the two: a CUDA tensor either goes through the kernel or raises.

The kernel composes every scene of ``scenes.KERNEL_SCENES`` after the
layer chain; the plain version composes with ``scenes.compose_fn``.
many_cylinder_cut's grid window is ``config.cyl_window`` unless a call
overrides it (``cyl_window``; the staged renderer's coarse pass passes
``config.cyl_window_coarse``).

Per-ray semantics (both versions): each ray marches while it is active,
``step < max_steps`` and, for a bounded call, ``step - start < num_steps``;
singleMarch update order; optional constant over-relaxation; the resolve
step per ray (see csrc/march.cuh). Both precisions of the JAX package
(DEFAULT for the coarse phase, HIGHEST for the refine rungs) run in FP32
here, so the call takes no precision argument.

The kernel marches nets of every width of ``fused_mlp.KERNEL_WIDTHS``
(32, 64, 128, 256), the net padded to the smallest that holds it; the plain
version marches any width ``pack_params`` accepts.

``KERNEL_LAUNCHES`` counts kernel launches (plain-version calls do not
count), ``SCENE_LAUNCHES`` the same launches per scene and
``WIDTH_LAUNCHES`` per padded width, so a run can show that its main path,
each scene's compose and each width's chain went through the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.mlp import MLP
from ..ops import camera as camera_lib
from ..ops import march as march_lib
from ..ops import shading
from ..ops.camera import Camera
from ..utils.config import RenderConfig
from . import build, scenes
from .fused_mlp import KERNEL_WIDTHS, check_tensor, min_rows, mlp_chain_plain, packed_params

#: Launches of the CUDA march kernel in this process.
KERNEL_LAUNCHES = 0

#: The same launches by scene name.
SCENE_LAUNCHES = {name: 0 for name in sorted(scenes.KERNEL_SCENES)}

#: The same launches by padded hidden width.
WIDTH_LAUNCHES = {h: 0 for h in KERNEL_WIDTHS}


def _new_steps(state: march_lib.MarchState, lane_steps: torch.Tensor,
               num_steps: Optional[int], max_steps: int) -> torch.Tensor:
    """The scheduler's step counter after a call (megakernel.py:356-364):
    the deepest lane's step when run to dry, else the bounded advance."""
    if num_steps is None:
        return lane_steps.max().to(torch.int32)
    return torch.clamp(state.steps + num_steps, max=max_steps).to(torch.int32)


def reset_launch_counts() -> None:
    """Set ``KERNEL_LAUNCHES`` and every ``SCENE_LAUNCHES`` and
    ``WIDTH_LAUNCHES`` entry to 0."""
    global KERNEL_LAUNCHES
    KERNEL_LAUNCHES = 0
    for counts in (SCENE_LAUNCHES, WIDTH_LAUNCHES):
        for key in counts:
            counts[key] = 0


def _window(config: RenderConfig, cyl_window: Optional[int]) -> int:
    return config.cyl_window if cyl_window is None else int(cyl_window)


def kernel_scene(config: RenderConfig, cyl_window: Optional[int] = None):
    """The kernel's (scene id, cylinder window) for a call; raises for a
    scene or window the kernel has no instantiation of."""
    window = _window(config, cyl_window)
    if config.scene not in scenes.SCENE_IDS:
        raise ValueError(
            f"the march kernel does not support scene {config.scene!r}; "
            "the plain march path handles it")
    if window not in scenes.CYL_WINDOWS:
        raise ValueError(f"cyl_window must be one of {scenes.CYL_WINDOWS}, not {window}")
    return scenes.SCENE_IDS[config.scene], window


def _compose(config: RenderConfig, cyl_window: Optional[int]):
    _, window = kernel_scene(config, cyl_window)
    return scenes.compose_fn(config.scene, window)


def march_state_plain(
    params: MLP, origin: torch.Tensor, dirs: torch.Tensor,
    state: march_lib.MarchState, config: RenderConfig, frame: float = 0.0, *,
    march_eps: Optional[float] = None, num_steps: Optional[int] = None,
    relax_omega: float = 0.0, return_resolve: bool = False,
    cyl_window: Optional[int] = None,
):
    """Plain PyTorch version of the march kernel, on any device.

    Each step evaluates only the rays still active (per-ray results do not
    depend on which rays march together) and reads the active count on the
    host, so it suits the CPU and comparisons, not the hot path.
    """
    compose = _compose(config, cyl_window)
    weights, biases, n_in, hidden = packed_params(params)
    if n_in != config.num_inputs:
        raise ValueError(f"model has {n_in} inputs but config.num_inputs={config.num_inputs}")
    n_layers = weights.shape[0]
    eps = config.march_eps if march_eps is None else march_eps
    relax = bool(relax_omega and relax_omega > 1.0)
    start = int(state.steps)
    limit = config.max_steps if num_steps is None else min(config.max_steps, start + num_steps)

    t = state.t.clone()
    budget = state.budget.clone()
    act = state.active.clone()
    conv = torch.zeros_like(act)
    res = torch.full(act.shape, start, dtype=torch.int32, device=act.device)
    prev_r = torch.zeros_like(t)
    step_len = torch.zeros_like(t)
    step = start
    while step < limit:
        idx = act.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        ti = t[idx]
        # origin + dir * t with ONE rounding, like the kernel's fmaf (exact
        # f32 product in f64, then a single rounding back to f32).
        pts = (origin.double() + dirs[idx].double() * ti.double()[:, None]).float()
        # Pad small batches, so a ray's SDF does not depend on how many rays
        # march beside it (fused_mlp.min_rows).
        x = torch.zeros((max(idx.numel(), min_rows(t.device)), hidden), dtype=torch.float32,
                        device=t.device)
        x[:idx.numel(), :3] = pts
        if n_in == 4:
            x[:, 3] = frame
        d = mlp_chain_plain(weights, biases, x, n_layers)[:idx.numel(), 0]
        d = compose(pts, d, frame)
        if relax:
            pr, sl = prev_r[idx], step_len[idx]
            sor_fail = (sl > pr) & (d + pr < sl)
            near = ~sor_fail & (d < eps)
            om = torch.where(sl < 0.0, torch.ones_like(d), torch.full_like(d, float(relax_omega)))
            stepv = torch.where(sor_fail, pr - sl, torch.where(near, d, om * d))
        else:
            sor_fail = torch.zeros_like(d, dtype=torch.bool)
            near = d < eps
            stepv = d
        bi = budget[idx] - stepv
        moved = sor_fail | ~(bi <= 0.0)
        conv_now = moved & near
        still = moved & ~conv_now
        budget[idx] = bi
        t[idx] = torch.where(moved, ti + stepv, ti)
        conv[idx] = conv[idx] | conv_now
        act[idx] = still
        res[idx] = torch.where(still, res[idx], torch.full_like(res[idx], step + 1))
        if relax:
            prev_r[idx] = torch.where(moved & ~sor_fail, d, pr)
            step_len[idx] = torch.where(moved, stepv, sl)
        step += 1
    lane_steps = torch.where(act, torch.full_like(res, step), res)
    out = march_lib.MarchState(
        t=t, budget=budget, active=act & state.active,
        converged=conv | state.converged,
        steps=_new_steps(state, lane_steps, num_steps, config.max_steps),
    )
    return (out, lane_steps) if return_resolve else out


def _march_state_cuda(
    params: MLP, origin: torch.Tensor, dirs: torch.Tensor,
    state: march_lib.MarchState, config: RenderConfig, frame: float,
    march_eps: Optional[float], num_steps: Optional[int], relax_omega: float,
    return_resolve: bool, cyl_window: Optional[int],
):
    global KERNEL_LAUNCHES
    scene_id, window = kernel_scene(config, cyl_window)
    weights, biases, n_in, hidden = packed_params(params)
    if hidden not in KERNEL_WIDTHS:
        raise ValueError(f"the march kernel is built for widths {KERNEL_WIDTHS}, "
                         f"not {hidden}")
    if n_in != config.num_inputs:
        raise ValueError(f"model has {n_in} inputs but config.num_inputs={config.num_inputs}")
    dev = dirs.device
    n = dirs.shape[0]
    check_tensor("dirs", dirs, torch.float32, (n, 3), dev)
    check_tensor("origin", origin, torch.float32, (3,), dev)
    check_tensor("state.t", state.t, torch.float32, (n,), dev)
    check_tensor("state.budget", state.budget, torch.float32, (n,), dev)
    check_tensor("state.active", state.active, torch.bool, (n,), dev)
    check_tensor("state.steps", state.steps, torch.int32, (), dev)
    n_layers = len(params)
    check_tensor("weights", weights, torch.float32, (n_layers, hidden, hidden), dev)
    check_tensor("biases", biases, torch.float32, (n_layers, hidden), dev)
    eps = config.march_eps if march_eps is None else march_eps
    omega = float(relax_omega) if relax_omega and relax_omega > 1.0 else 0.0

    t = torch.empty_like(state.t)
    budget = torch.empty_like(state.budget)
    active = torch.empty_like(state.active)
    conv = torch.empty_like(state.active)
    lane_steps = torch.empty((n,), dtype=torch.int32, device=dev)

    lib = build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.cnr_march(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        dirs.data_ptr(), origin.data_ptr(), state.t.data_ptr(),
        state.budget.data_ptr(), state.active.data_ptr(), state.steps.data_ptr(),
        weights.data_ptr(), biases.data_ptr(),
        n_layers, hidden, config.num_inputs, float(frame), scene_id, window,
        n, config.max_steps, -1 if num_steps is None else int(num_steps),
        float(eps), omega,
        t.data_ptr(), budget.data_ptr(), active.data_ptr(), conv.data_ptr(),
        lane_steps.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(
            f"march kernel launch failed: {lib.cnr_error_string(err).decode()} ({err})")
    KERNEL_LAUNCHES += 1
    SCENE_LAUNCHES[config.scene] += 1
    WIDTH_LAUNCHES[hidden] += 1
    out = march_lib.MarchState(
        t=t, budget=budget, active=active & state.active,
        converged=conv | state.converged,
        steps=_new_steps(state, lane_steps, num_steps, config.max_steps),
    )
    return (out, lane_steps) if return_resolve else out


def march_state(
    params: MLP, origin: torch.Tensor, dirs: torch.Tensor,
    state: march_lib.MarchState, config: RenderConfig, frame: float = 0.0, *,
    march_eps: Optional[float] = None, num_steps: Optional[int] = None,
    relax_omega: float = 0.0, return_resolve: bool = False,
    cyl_window: Optional[int] = None,
):
    """Continue an existing march state inside the march kernel.

    ``num_steps=None`` marches every ray to dry (or ``config.max_steps``);
    an int bounds the call to that many steps past ``state.steps``.
    ``relax_omega`` > 1 turns on constant over-relaxation.
    ``return_resolve=True`` also returns each ray's resolve step [n] int32
    (the staged renderer's difficulty key). ``cyl_window`` overrides
    ``config.cyl_window`` for this call.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if dirs.device.type == "cpu":
        return march_state_plain(
            params, origin, dirs, state, config, frame, march_eps=march_eps,
            num_steps=num_steps, relax_omega=relax_omega,
            return_resolve=return_resolve, cyl_window=cyl_window)
    if dirs.device.type != "cuda":
        raise ValueError(f"march_state runs on cpu or cuda tensors, not {dirs.device}")
    return _march_state_cuda(
        params, origin, dirs, state, config, frame, march_eps, num_steps,
        relax_omega, return_resolve, cyl_window)


def march(params: MLP, origin: torch.Tensor, dirs: torch.Tensor,
          config: RenderConfig, frame: float = 0.0):
    """March every ray from a cold start. Returns (t [N], hit [N] bool)."""
    state = march_lib.init_state(origin, dirs, config.bound_center, config.bound_radius)
    out = march_state(params, origin, dirs, state, config, frame)
    return out.t, out.converged


def render_image_kernel(params: MLP, camera: Camera, config: RenderConfig,
                        matcap: Optional[torch.Tensor] = None,
                        frame: float = 0.0) -> torch.Tensor:
    """Full render with the kernel march and plain dense shading
    (march_impl="megakernel"), the counterpart of ``render_image_pallas``:
    the march composes with ``config.cyl_window``, the shading normals
    differentiate the dense scene through the plain chain. Returns
    [H, W, 4] float rgba, row 0 = bottom."""
    if not scenes.kernel_supported(config.scene):
        raise ValueError(
            f"the march kernel does not support scene {config.scene!r}; use render_image")
    from ..render.renderer import scene_fn

    dev = params.device
    cam_to_world, world_to_cam = camera_lib.view_matrices(camera, dev)
    origin, dirs = camera_lib.generate_rays(
        cam_to_world, config.height, config.width, config.focal)
    t, hit = march(params, origin, dirs, config, frame)
    points = origin + dirs * t[:, None]
    colors = shading.shade(
        scene_fn(params, config, frame, for_grad=True), points, dirs,
        mode=config.shading, normal_mode=config.normal_mode,
        normal_eps=config.normal_eps, world_to_cam=world_to_cam, matcap=matcap,
    )
    rgba = torch.where(hit[:, None], colors, torch.zeros_like(colors))
    return rgba.reshape(config.height, config.width, 4)
