"""The march kernel: the whole sphere trace of every ray in one launch.

The counterpart of the JAX package's ``pallas/megakernel.py``.
``march_state`` continues an existing march state (the counterpart of
``march_pallas_state``); ``march_raygen`` marches from a cold start, each
ray built inside the kernel from its pixel index (the counterpart of
``march_pallas_raygen``, K5). On CUDA tensors each launches the
hand-written kernel in ``csrc/march.cuh``; on CPU tensors each runs its
plain version (``march_state_plain``, ``march_raygen_plain``), the same
per-ray semantics in plain PyTorch. There is no fallback between the two: a
CUDA tensor either goes through the kernel or raises.

The kernel composes every scene of ``scenes.KERNEL_SCENES`` after the
layer chain; the plain version composes with ``scenes.compose_fn``.
many_cylinder_cut's grid window is ``config.cyl_window`` unless a call
overrides it (``cyl_window``; the staged renderer's coarse pass passes
``config.cyl_window_coarse``).

Per-ray semantics (both versions): each ray marches while it is active,
``step < max_steps`` and, for a bounded call, ``step - start < num_steps``;
singleMarch update order; optional constant over-relaxation; the resolve
step per ray (see csrc/march.cuh).

``frame`` is a float or a [] float32 tensor on the rays' device; the
kernel reads it from device memory (``ops.sdf.frame_tensor``), so a CUDA
graph of a frame renders whatever frame its caller copied in before a
replay (render/renderer.py ``_ChunkGraph``).

``precision`` names the JAX package's matmul precision of the call:
"default" and "highest" run the chain in FP32 (DEFAULT is the coarse
phase's under ``coarse_precision="default"``, HIGHEST the refine rungs');
"high" runs the emulated Precision.HIGH three-pass chain K2h
(``fused_mlp.mlp_chain_3pass_plain``) on the bfloat16 halves of the
weights (the coarse phase's by default, and the HIGH ladder phase of
``mid_eps``). Any other name raises. The
kernel runs the FP32 chain as 3xTF32 on the tensor cores over a warp's
rays at every width (``tensor_core_chain``), in their own order
(``fused_mlp.mlp_chain_3xtf32_mma`` models it).

The kernel marches nets of every width of ``fused_mlp.KERNEL_WIDTHS``
(32, 64, 128, 256, 512, 1024), the net padded to the smallest that holds
it; the plain version marches any width ``pack_params`` accepts. A
``models.hash_grid.HashGridSDF`` marches through the same kernels with its
encoding as the chain's input stage (its MLP at width 64, ``neural_raw``
only: ``csrc/hash_grid.cuh``). A model gives the kernels its ``chain``, its
``grid()`` (the encoding's table, or none) and ``plain_inputs`` (the plain
version's chain inputs); each call counts its table gathers
(``gathers_per_eval``).

At widths 32, 64 and 128 the FP32 chain marches in one of two modes,
chosen per launch by ``ray_lanes`` from the call's place in the staged
march (``split_chain``): a ray per thread on the tensor cores, or a ray per
warp with the chain of its point split over the warp's lanes on FFMA
(csrc/march.cuh ``march_split_kernel``; at 128 a warp in each CTA of a
4-CTA cluster that holds the stack, csrc/hidden128_split.cu), for the
refine ladder's later rungs, where a few stragglers march for hundreds of
steps; a frame's coarse call (``coarse=True``) always marches a ray per
thread. A ray per warp sums each output in input order from zero, the plain
version's order, and gives its results bit for bit.

Launch counts (plain-version calls do not count): ``KERNEL_LAUNCHES``
counts ``march_state``'s launches, ``SCENE_LAUNCHES`` the same launches per
scene, ``WIDTH_LAUNCHES`` per padded width, ``PRECISION_LAUNCHES`` per
precision, ``THREE_PASS_LAUNCHES`` the "high" ones per width and
``SPLIT_LAUNCHES`` the ray-per-warp ones per width; ``RAYGEN_LAUNCHES``
counts ``march_raygen``'s. A run can so show that its main path, each
scene's compose, each width's chain, the three-pass chain and the
ray-split mode went through the kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.mlp import MLP
from ..ops import march as march_lib
from ..ops import sdf
from ..utils import trace
from ..utils.config import RenderConfig
from . import build, scenes
from .fused_mlp import (
    KERNEL_WIDTHS, chain_in_blocks, check_tensor, mlp_chain_3pass_plain, mlp_chain_plain,
    packed_hi_lo, packed_mma, packed_params, plain_rows,
)

#: The precisions a march call takes (the JAX package's Precision names).
PRECISIONS = ("default", "high", "highest")

#: The padded widths at which the kernel runs the FP32 chain on the tensor
#: cores a ray per thread: every width (csrc/chain.cuh ``chain_sdf_tf32``).
TENSOR_CORE_FP32_WIDTHS = KERNEL_WIDTHS

#: The padded widths at which the FP32 chain also marches a ray per warp:
#: at 32 and 64 on one warp, the stack in its block's shared memory; at 128
#: on a warp of each CTA of a 4-CTA cluster, the stack split over the
#: cluster's shared memory (csrc/hidden128_split.cu).
SPLIT_WIDTHS = (32, 64, 128)

#: The deepest net a width's ray-split mode holds on chip, where it has a
#: bound: at 128, 13 layers fill a CTA's 227 KB of shared memory.
SPLIT_MAX_LAYERS = {128: 13}

#: ``ray_lanes``' bound: a bounded refine call of at least this many steps
#: (the staged renderer's (32, 64) rung) marches a ray per warp.
SPLIT_MIN_STEPS = 64

#: Launches of the CUDA march kernel by ``march_state`` in this process.
KERNEL_LAUNCHES = 0

#: The same launches by scene name.
SCENE_LAUNCHES = {name: 0 for name in sorted(scenes.KERNEL_SCENES)}

#: The same launches by padded hidden width.
WIDTH_LAUNCHES = {h: 0 for h in KERNEL_WIDTHS}

#: The same launches by precision.
PRECISION_LAUNCHES = {p: 0 for p in PRECISIONS}

#: The same launches at precision "high" (the three-pass chain) by width.
THREE_PASS_LAUNCHES = {h: 0 for h in KERNEL_WIDTHS}

#: The same launches in the ray-split mode (a ray per warp) by width.
SPLIT_LAUNCHES = {h: 0 for h in KERNEL_WIDTHS}

#: Launches of the kernel by ``march_raygen`` (K5) in this process.
RAYGEN_LAUNCHES = 0

#: The lanes that march one ray in the ray-split mode: a warp.
SPLIT_LANES = 32

#: The padded width at which a ray per thread marches a block's group of
#: rays at once, the warps splitting each layer's columns over the group's
#: activations in shared memory (csrc/hidden128_group.cuh), and the rays of
#: a group: the lockstep unit there (csrc/chain.cuh ``kGroupRays``). At the
#: other widths a warp's 32 rays step together.
SHARED_WIDTH = 128
SHARED_GROUP = 64
#: The threads (rays) of a block there (csrc/chain.cuh ``kGroupBlock``),
#: whose groups take turns.
SHARED_BLOCK = 128


def lockstep_lanes(hidden: int, lanes: int) -> int:
    """The lanes that step together in a launch of ``lanes`` lanes a ray at
    a padded width: a ray per warp, its own ray (1); a ray per thread, a
    block's group at SHARED_WIDTH and a warp elsewhere."""
    if lanes != 1:
        return 1
    return SHARED_GROUP if hidden == SHARED_WIDTH else 32


def _new_steps(state: march_lib.MarchState, lane_steps: torch.Tensor,
               num_steps: Optional[int], max_steps: int) -> torch.Tensor:
    """The scheduler's step counter after a call (megakernel.py:356-364):
    the deepest lane's step when run to dry, else the bounded advance."""
    if num_steps is None:
        return lane_steps.max().to(torch.int32)
    return torch.clamp(state.steps + num_steps, max=max_steps).to(torch.int32)


def reset_launch_counts() -> None:
    """Set ``KERNEL_LAUNCHES``, ``RAYGEN_LAUNCHES`` and every entry of the
    per-scene, per-width, per-precision and per-mode counts to 0."""
    global KERNEL_LAUNCHES, RAYGEN_LAUNCHES
    KERNEL_LAUNCHES = RAYGEN_LAUNCHES = 0
    for counts in (SCENE_LAUNCHES, WIDTH_LAUNCHES, PRECISION_LAUNCHES, THREE_PASS_LAUNCHES,
                   SPLIT_LAUNCHES):
        for key in counts:
            counts[key] = 0


def split_chain(hidden: int, precision: str, n_layers: Optional[int] = None) -> bool:
    """Whether the kernel also marches the chain at a padded width and
    precision (and depth, where given) a ray per warp: the FP32 chain at
    ``SPLIT_WIDTHS``, no deeper than ``SPLIT_MAX_LAYERS``."""
    if precision == "high" or hidden not in SPLIT_WIDTHS:
        return False
    return n_layers is None or n_layers <= SPLIT_MAX_LAYERS.get(hidden, n_layers)


def tensor_core_chain(hidden: int, precision: str, lanes: int = 1) -> bool:
    """Whether the kernel's chain at a padded width and precision, marching
    ``lanes`` lanes a ray, sums on the tensor cores, in their own order
    rather than its plain version's: the three-pass chain at every width,
    the FP32 chain a ray per thread at ``TENSOR_CORE_FP32_WIDTHS``. A ray
    per warp (``split_chain``) sums on FFMA in the plain version's order."""
    return lanes == 1 or not split_chain(hidden, precision)


def ray_lanes(hidden: int, precision: str, num_steps: Optional[int],
              coarse: bool = False, n_layers: Optional[int] = None) -> int:
    """The lanes that march one ray in a launch: SPLIT_LANES (the ray-split
    mode, a warp a ray) or 1 (a thread a ray).

    The split mode exists for the FP32 chain at widths 32, 64 and 128
    (``split_chain``). A straggler's step runs several times faster in it
    than in its warp's thread, while many rays march slower (each weight
    serves one ray, not a warp's 32, and on FFMA, not the tensor cores). A
    launch cannot see its active count without syncing the host, so the
    call's place in the staged march stands in for it: a frame's coarse
    call (``coarse``) marches every ray, a ray per thread; a refine call
    run to dry (``num_steps`` None: the terminal rung) or bounded at
    SPLIT_MIN_STEPS steps or more (the ladder's later rungs) holds the
    stragglers, a few percent of its lanes or less, a ray per warp; a
    shorter bounded call (the first rungs, a third to three quarters of
    their lanes active) a ray per thread. The share follows the rung's
    place in the ladder at every image size, where a lane count does not
    (PERF.md has the per-rung times in both modes)."""
    if coarse or not split_chain(hidden, precision, n_layers):
        return 1
    return SPLIT_LANES if num_steps is None or num_steps >= SPLIT_MIN_STEPS else 1


def _check_ray_lanes(value: int, hidden: int, precision: str, n_layers: int) -> None:
    """Raise unless a ``_ray_lanes`` override is 1, or SPLIT_LANES where the
    chain is the FP32 one at 32, 64 or 128 (``split_chain``)."""
    if value not in (1, SPLIT_LANES):
        raise ValueError(f"_ray_lanes must be 1 or {SPLIT_LANES}, not {value!r}")
    if value != 1 and not split_chain(hidden, precision, n_layers):
        raise ValueError(f"the ray-split mode runs the FP32 chain at widths {SPLIT_WIDTHS} "
                         f"only ({SPLIT_MAX_LAYERS[128]} layers at most at 128), not "
                         f"{n_layers} layers at width {hidden} at precision {precision!r}")


def _check_inputs(params, config: RenderConfig) -> None:
    """Raise unless the model renders ``config`` and takes its inputs."""
    params.check_render(config)
    if params.num_inputs != config.num_inputs:
        raise ValueError(f"model has {params.num_inputs} inputs but "
                         f"config.num_inputs={config.num_inputs}")


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, not {precision!r}")


def _chain_plain(params: MLP, precision: str):
    """The plain chain of a precision: x [T, H] -> [T, H]."""
    weights, biases, _, _ = packed_params(params)
    n_layers = weights.shape[0]
    if precision == "high":
        w_hi, w_lo = packed_hi_lo(params)
        return lambda x: mlp_chain_3pass_plain(w_hi, w_lo, biases, x, n_layers)
    return lambda x: mlp_chain_plain(weights, biases, x, n_layers)


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
    precision: str = "highest", relax_omega: float = 0.0,
    return_resolve: bool = False, cyl_window: Optional[int] = None,
    coarse: bool = False, chain=None, trace=None,
):
    """Plain PyTorch version of the march kernel, on any device.

    Each step evaluates only the rays still active (per-ray results do not
    depend on which rays march together) and reads the active count on the
    host, so it suits the CPU and comparisons, not the hot path. ``coarse``
    is ``march_state``'s, which picks the kernel's mode: the plain version
    has one. ``chain``
    (x [T, H] -> [T, H], the head column 0) marches with another chain in
    place of the precision's plain one: a check replays the kernel's own
    chain through it. ``trace``, if given, is called once a step with a
    dict of the marching lanes (``idx``), their points, distances, state
    before the step (budget, prev_r, step_len) and decisions (sor_fail,
    near, moved): where two marches part (``chip_smoke.undecided_lanes``).
    """
    _check_precision(precision)
    frame = float(frame)  # a [] tensor on the card is read here: the plain version syncs anyway
    compose = _compose(config, cyl_window)
    _, _, n_in, hidden = packed_params(params.chain)
    _check_inputs(params, config)
    chain = _chain_plain(params.chain, precision) if chain is None else chain
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
        # march beside it (fused_mlp.plain_rows).
        x = torch.zeros((plain_rows(idx.numel(), hidden, t.device), hidden), dtype=torch.float32,
                        device=t.device)
        inputs = params.plain_inputs(pts)
        x[:idx.numel(), :inputs.shape[1]] = inputs
        if n_in == 4:
            x[:, 3] = frame
        d = chain_in_blocks(chain, x)[:idx.numel(), 0]
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
        if trace is not None:
            trace(dict(step=step, idx=idx, pts=pts, d=d, budget=budget[idx],
                       prev_r=prev_r[idx], step_len=step_len[idx], sor_fail=sor_fail,
                       near=near, moved=moved))
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


def _kernel_weights(params: MLP, config: RenderConfig, precision: str, dev, lanes: int = 1):
    """The stack a launch of ``lanes`` lanes a ray reads, checked:
    (weights, biases, n_layers, hidden). At "high" the bfloat16 halves in
    fragment order (``packed_mma(params, "bf16")``); else, a ray per thread,
    the FP32 values in tf32 fragment order (``packed_mma(params, "tf32")``),
    and a ray per warp the FP32 stack [L, H, H]; biases [L, H] float32."""
    chain = params.chain
    weights, biases, _, hidden = packed_params(chain)
    if hidden not in KERNEL_WIDTHS:
        raise ValueError(f"the march kernel is built for widths {KERNEL_WIDTHS}, "
                         f"not {hidden}")
    _check_inputs(params, config)
    n_layers = len(chain)
    if precision == "high":
        weights = packed_mma(chain, "bf16")
        check_tensor("weights", weights, torch.bfloat16,
                     (n_layers, hidden // 16, hidden // 8, 32, 8), dev)
    elif tensor_core_chain(hidden, precision, lanes):
        weights = packed_mma(chain, "tf32")
        check_tensor("weights", weights, torch.float32,
                     (n_layers, hidden // 8, hidden // 8, 32, 2), dev)
    else:
        check_tensor("weights", weights, torch.float32, (n_layers, hidden, hidden), dev)
    check_tensor("biases", biases, torch.float32, (n_layers, hidden), dev)
    return weights, biases, n_layers, hidden


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _grid_args(params):
    """The encoding's table and level words a launch passes (NULL for a
    model without one, whose chain reads the point)."""
    grid = params.grid()
    return (None, None) if grid is None else (grid[0].data_ptr(), grid[1].data_ptr())


def _outputs(n: int, dev):
    """t, budget, active, converged, lane steps: what a launch writes."""
    f32 = dict(dtype=torch.float32, device=dev)
    flag = dict(dtype=torch.bool, device=dev)
    return (torch.empty((n,), **f32), torch.empty((n,), **f32), torch.empty((n,), **flag),
            torch.empty((n,), **flag), torch.empty((n,), dtype=torch.int32, device=dev))


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.cnr_error_string(err).decode()} ({err})")


def _march_state_cuda(
    params: MLP, origin: torch.Tensor, dirs: torch.Tensor,
    state: march_lib.MarchState, config: RenderConfig, frame: float,
    march_eps: Optional[float], num_steps: Optional[int], relax_omega: float,
    return_resolve: bool, cyl_window: Optional[int], precision: str = "highest",
    lanes: Optional[int] = None, coarse: bool = False,
):
    global KERNEL_LAUNCHES
    scene_id, window = kernel_scene(config, cyl_window)
    dev = dirs.device
    n = dirs.shape[0]
    if lanes is None:
        lanes = ray_lanes(packed_params(params.chain)[3], precision, num_steps, coarse,
                          len(params.chain))
    weights, biases, n_layers, hidden = _kernel_weights(params, config, precision, dev, lanes)
    check_tensor("dirs", dirs, torch.float32, (n, 3), dev)
    check_tensor("origin", origin, torch.float32, (3,), dev)
    check_tensor("state.t", state.t, torch.float32, (n,), dev)
    check_tensor("state.budget", state.budget, torch.float32, (n,), dev)
    check_tensor("state.active", state.active, torch.bool, (n,), dev)
    check_tensor("state.steps", state.steps, torch.int32, (), dev)
    eps = config.march_eps if march_eps is None else march_eps
    omega = float(relax_omega) if relax_omega and relax_omega > 1.0 else 0.0

    t, budget, active, conv, lane_steps = _outputs(n, dev)
    # The 128-wide ray-split mode's ray counter, zero at launch.
    work = (torch.zeros((1,), dtype=torch.int32, device=dev)
            if lanes != 1 and hidden == 128 else None)
    lib = build.load_library()
    frame_t = sdf.frame_tensor(frame, dev)
    check_tensor("frame", frame_t, torch.float32, (), dev)
    err = lib.cnr_march(
        _device_index(dev),
        dirs.data_ptr(), origin.data_ptr(), state.t.data_ptr(),
        state.budget.data_ptr(), state.active.data_ptr(), state.steps.data_ptr(),
        weights.data_ptr(), biases.data_ptr(), n_layers, hidden, config.num_inputs,
        frame_t.data_ptr(), *_grid_args(params), scene_id, window, int(precision == "high"),
        lanes,
        n, config.max_steps, -1 if num_steps is None else int(num_steps),
        float(eps), omega,
        t.data_ptr(), budget.data_ptr(), active.data_ptr(), conv.data_ptr(),
        lane_steps.data_ptr(), None if work is None else work.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, lib, "march kernel")
    KERNEL_LAUNCHES += 1
    SCENE_LAUNCHES[config.scene] += 1
    WIDTH_LAUNCHES[hidden] += 1
    PRECISION_LAUNCHES[precision] += 1
    if precision == "high":
        THREE_PASS_LAUNCHES[hidden] += 1
    if lanes != 1:
        SPLIT_LAUNCHES[hidden] += 1
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
    precision: str = "highest", relax_omega: float = 0.0,
    return_resolve: bool = False, cyl_window: Optional[int] = None,
    coarse: bool = False, _ray_lanes: Optional[int] = None,
):
    """Continue an existing march state inside the march kernel.

    ``num_steps=None`` marches every ray to dry (or ``config.max_steps``);
    an int bounds the call to that many steps past ``state.steps``.
    ``precision`` is "default" or "highest" (FP32 chain) or "high" (the
    three-pass chain K2h). ``relax_omega`` > 1 turns on constant
    over-relaxation. ``return_resolve=True`` also returns each ray's
    resolve step [n] int32 (the staged renderer's difficulty key).
    ``cyl_window`` overrides ``config.cyl_window`` for this call.
    ``coarse=True`` marks a frame's coarse call, every ray of the frame
    from its cold start: it marches a ray per thread (``ray_lanes``).
    ``_ray_lanes`` (1 or SPLIT_LANES) overrides ``ray_lanes``' choice of
    mode, for the checks that hold each mode against the plain version.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    _check_precision(precision)
    if _ray_lanes is not None:
        _check_ray_lanes(_ray_lanes, packed_params(params.chain)[3], precision,
                         len(params.chain))
    if dirs.device.type == "cpu":
        out, lane_steps = march_state_plain(
            params, origin, dirs, state, config, frame, march_eps=march_eps,
            num_steps=num_steps, precision=precision, relax_omega=relax_omega,
            return_resolve=True, cyl_window=cyl_window)
    elif dirs.device.type == "cuda":
        out, lane_steps = _march_state_cuda(
            params, origin, dirs, state, config, frame, march_eps, num_steps, relax_omega,
            True, cyl_window, precision, _ray_lanes, coarse)
    else:
        raise ValueError(f"march_state runs on cpu or cuda tensors, not {dirs.device}")
    if trace.enabled():
        # The kernel's mode, on the CPU too: the count is the launch's.
        hidden = packed_params(params.chain)[3]
        lanes = _ray_lanes or ray_lanes(hidden, precision, num_steps, coarse, len(params.chain))
        _count_march(state, lane_steps, hidden, lanes, params.gathers_per_eval)
    return (out, lane_steps) if return_resolve else out


def _count_march(state: march_lib.MarchState, lane_steps: torch.Tensor, hidden: int,
                 lanes: int, gathers: int = 0) -> None:
    """``trace.count("march", ...)`` for one march call at padded width
    ``hidden``, ``lanes`` lanes a ray, from its entry state and its
    ``lane_steps``: ``lanes`` the call's lanes, ``active_in`` those active
    at entry, ``useful`` the steps its rays marched (sum of
    ``lane_steps - start``) and ``slots`` the lane-steps the launch held:
    for each run of consecutive lanes that step together
    (``lockstep_lanes``: a warp, a block's group at SHARED_WIDTH, a ray
    alone a ray per warp), the run's lanes x the steps of its deepest lane.
    A call marched a ray per warp also counts its lanes as ``split_lanes``,
    and one marched through a block's group as ``shared_lanes``. With
    ``gathers`` table entries an evaluation, also ``gathers``, useful x that
    (a dense chain reads no table, and counts none)."""
    steps = lane_steps - state.steps
    unit = lockstep_lanes(hidden, lanes)
    pad = -steps.shape[0] % unit
    runs = (torch.nn.functional.pad(steps, (0, pad)) if pad else steps).view(-1, unit)
    slots = runs.amax(1).sum() * unit
    mode = ({"split_lanes": steps.shape[0]} if lanes != 1 else
            {"shared_lanes": steps.shape[0]} if hidden == SHARED_WIDTH else {})
    useful = steps.sum()
    table = dict(gathers=useful * gathers) if gathers else {}
    trace.count("march", lanes=steps.shape[0], active_in=state.active.sum(), useful=useful,
                slots=slots, **mode, **table)


def raygen_state(cam_to_world: torch.Tensor, pos: torch.Tensor, config: RenderConfig):
    """The rays and the cold-start state of pixel indices pos [n] int32, by
    the formula K5 uses inside the kernel (pallas/megakernel.py:105-135;
    not ``camera.ray_dirs_from_index``, which normalises another way):
    u = x/W*2-1 (the division as a product with the float32 reciprocal),
    dirs = R @ ([u, v, -f] / sqrt(u^2 + v^2 + f^2)) as explicit three-term
    sums, then the bounding-sphere init of ``march.init_state``. Lanes with
    pos < 0 are pad lanes and start inactive. Returns (origin [3], dirs
    [n, 3], state)."""
    c2w = cam_to_world.float()
    origin = c2w[:, 3].contiguous()
    x = torch.remainder(pos, config.width).float()  # floor division, as JAX's % and //
    y = torch.div(pos, config.width, rounding_mode="floor").float()
    inv_w = float(np.float32(1.0) / np.float32(config.width))
    inv_h = float(np.float32(1.0) / np.float32(config.height))
    u = (x * inv_w) * 2.0 - 1.0
    v = (y * inv_h) * 2.0 - 1.0
    fw = -float(config.focal)
    inv = 1.0 / torch.sqrt(u * u + v * v + fw * fw)
    du, dv, dw = u * inv, v * inv, fw * inv
    r = c2w[:, :3]
    dirs = torch.stack([r[i, 0] * du + r[i, 1] * dv + r[i, 2] * dw for i in range(3)], dim=1)
    qx, qy, qz = (origin[i] - float(config.bound_center[i]) for i in range(3))
    dx, dy, dz = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (qx * dx + qy * dy + qz * dz)
    c = qx * qx + qy * qy + qz * qz - float(config.bound_radius) * float(config.bound_radius)
    disc = b * b - 4.0 * a * c
    hit = disc > 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    tnear = torch.clamp((-b - sq) / (2.0 * a), min=0.0)
    tfar = (-b + sq) / (2.0 * a)
    zero = torch.zeros_like(tnear)
    state = march_lib.MarchState(
        t=torch.where(hit, tnear, zero), budget=torch.where(hit, tfar, zero),
        active=hit & (pos >= 0), converged=torch.zeros_like(hit),
        steps=torch.zeros((), dtype=torch.int32, device=pos.device))
    return origin, dirs.contiguous(), state


def march_raygen_plain(
    params: MLP, cam_to_world: torch.Tensor, pos: torch.Tensor, config: RenderConfig,
    frame: float = 0.0, *, march_eps: Optional[float] = None, precision: str = "highest",
    relax_omega: float = 0.0, return_resolve: bool = False,
    cyl_window: Optional[int] = None,
):
    """Plain version of K5, on any device: ``raygen_state``, then
    ``march_state_plain`` run to dry from step 0."""
    origin, dirs, state = raygen_state(cam_to_world, pos, config)
    return march_state_plain(
        params, origin, dirs, state, config, frame, march_eps=march_eps,
        precision=precision, relax_omega=relax_omega, return_resolve=return_resolve,
        cyl_window=cyl_window)


def _march_raygen_cuda(
    params: MLP, cam_to_world: torch.Tensor, pos: torch.Tensor, config: RenderConfig,
    frame: float, march_eps: Optional[float], precision: str, relax_omega: float,
    return_resolve: bool, cyl_window: Optional[int],
):
    global RAYGEN_LAUNCHES
    scene_id, window = kernel_scene(config, cyl_window)
    dev = pos.device
    weights, biases, n_layers, hidden = _kernel_weights(params, config, precision, dev)
    n = pos.shape[0]
    check_tensor("pos", pos, torch.int32, (n,), dev)
    check_tensor("cam_to_world", cam_to_world, torch.float32, (3, 4), dev)
    eps = config.march_eps if march_eps is None else march_eps
    omega = float(relax_omega) if relax_omega and relax_omega > 1.0 else 0.0
    cx, cy, cz = (float(c) for c in config.bound_center)

    t, budget, active, conv, lane_steps = _outputs(n, dev)
    frame_t = sdf.frame_tensor(frame, dev)
    check_tensor("frame", frame_t, torch.float32, (), dev)
    lib = build.load_library()
    err = lib.cnr_march_raygen(
        _device_index(dev), pos.data_ptr(), cam_to_world.data_ptr(),
        config.width, config.height, float(config.focal), cx, cy, cz,
        float(config.bound_radius) * float(config.bound_radius),
        weights.data_ptr(), biases.data_ptr(), n_layers, hidden, config.num_inputs,
        frame_t.data_ptr(), *_grid_args(params), scene_id, window, int(precision == "high"), n,
        config.max_steps,
        float(eps), omega,
        t.data_ptr(), budget.data_ptr(), active.data_ptr(), conv.data_ptr(),
        lane_steps.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, lib, "raygen march kernel")
    RAYGEN_LAUNCHES += 1
    out = march_lib.MarchState(
        t=t, budget=budget, active=active, converged=conv,
        steps=lane_steps.max().to(torch.int32))
    return (out, lane_steps) if return_resolve else out


def march_raygen(
    params: MLP, cam_to_world: torch.Tensor, pos: torch.Tensor, config: RenderConfig,
    frame: float = 0.0, *, march_eps: Optional[float] = None, precision: str = "highest",
    relax_omega: float = 0.0, return_resolve: bool = False,
    cyl_window: Optional[int] = None,
):
    """Cold-start march with the rays built inside the kernel (K5).

    ``pos`` [n] int32 pixel indices (y*W + x) in any order, -1 for a pad
    lane; ``cam_to_world`` [3, 4]. Each ray is built from its index by
    ``raygen_state``'s formula and marched to dry, as ``march_state`` would
    march ``raygen_state``'s rays, with no [n, 3] direction or state
    tensors in device memory. Returns a fresh MarchState (steps from 0),
    and the resolve step per ray with ``return_resolve=True``. The staged
    renderer builds its rays outside the kernel, as the JAX package's does;
    this is for callers that cannot afford those buffers.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    _check_precision(precision)
    if pos.device.type == "cpu":
        return march_raygen_plain(
            params, cam_to_world, pos, config, frame, march_eps=march_eps,
            precision=precision, relax_omega=relax_omega, return_resolve=return_resolve,
            cyl_window=cyl_window)
    if pos.device.type != "cuda":
        raise ValueError(f"march_raygen runs on cpu or cuda tensors, not {pos.device}")
    return _march_raygen_cuda(params, cam_to_world, pos, config, frame, march_eps, precision,
                              relax_omega, return_resolve, cyl_window)


def march(params: MLP, origin: torch.Tensor, dirs: torch.Tensor,
          config: RenderConfig, frame: float = 0.0):
    """March every ray from a cold start. Returns (t [N], hit [N] bool)."""
    state = march_lib.init_state(origin, dirs, config.bound_center, config.bound_radius)
    out = march_state(params, origin, dirs, state, config, frame, coarse=True)
    return out.t, out.converged
