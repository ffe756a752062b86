"""High-level renderer: camera + neural SDF -> image.

The PyTorch counterpart of the JAX package's ``render/renderer.py``, in
full: ``render_staged`` with the default mixed-precision config (the main
path), the dense ``render_image``, ``render_sequence`` (the pipelined
turntable, with warm starts and fused chunks), and the ``Renderer``'s
interactive frames, for every scene of ops/sdf.py.

A staged frame runs, in order:
  1. camera -> rays, in block-major lane order, and the bounding-sphere init;
  2. one run-to-dry march-kernel pass down to ``coarse_eps`` with
     over-relaxation, recording each ray's resolve step;
  3. the refine ladder: a difficulty-keyed entry sort of the near-surface
     set, then rungs that each sort the actives into a prefix bucket and
     march it in the kernel down to ``march_eps``; with ``mid_eps`` a HIGH
     phase (the three-pass chain K2h) first marches the set down to
     ``mid_eps``;
  4. in-place shading of the first refine bucket (autodiff normals), a u32
     pack and a sort that restores image order;
  5. ONE fetch of a small stats vector, which drives the fast-path check,
     the overflow retry, the schedule memo and the rare host-driven
     continuation.
Bucket capacities are static per config, so nothing between 1 and 5 reads
the device from the host: the camera pose, the frame number and every
constant reach the device without a blocking copy (ops/camera.py
``pose_tensor``, ops/sdf.py ``frame_tensor`` and ``device_constant``), so a
frame's work queues behind the frames before it, and k frames can be
captured as one CUDA graph (``render_sequence(chunk=k)``). Configs whose
marches leave the kernel read the host every step (``frame_reads_host``).

PyTorch runs eagerly; the JAX package's jit boundaries become plain
function calls. JAX arrays are immutable and the staged code relies on
that, so this module never writes into a tensor it did not just allocate:
bundle updates (``_pr_merge``) build new tensors.

Which many_cylinder_cut compose each phase uses, as in the JAX package:
the coarse kernel pass ``cyl_window_coarse``, the refine rungs
``cyl_window``, shading normals the windowed dense chain (``shade_fn``),
and every dense march (``render_image``, ``march_precision="full"``, the
continuation) the complete 300-term chain.

``config.use_pallas`` sends every SDF evaluation that takes no gradient
outside the march kernel (the dense marches, the continuation) through the
fused forward kernel (K3). Shading normals take the value-and-gradient
kernel on the card (``shade_fn``) whatever ``use_pallas`` says.

The precision ladder runs as in the JAX package: the coarse kernel pass at
``coarse_precision`` ("high", the default: K2h; "default": FP32), the optional
HIGH phase (``mid_eps``, ``mid_schedule``) and the HIGHEST phase in the
kernel. ``tail_pallas`` sends terminal rungs that would march outside the
kernel to it, and ``relax_newton`` (secant-adaptive relaxation) keeps the
relaxed rungs off the kernel, which has no Newton step. Dense marches run
the FP32 chain at every precision.

Two opt-in phases replace the march's initial state in the mixed
precision, as in the JAX package: the cone-traced low-resolution prepass
(``prepass_factor``, ops/prepass.py; image-order lanes of a cold frame
only, when the factor divides H and W) and the baked-grid walk
(``grid_res``, ops/grid.py; after any init, warm and sharded lanes too).
Both are plain PyTorch loops that read a flag on the host every few steps
(``frame_reads_host``), and their SDF is the coarse phase's dense chain
(K3 under ``use_pallas``).
"""
from __future__ import annotations

import collections
import functools
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels import fused_mlp, megakernel
from ..kernels import scenes as kscenes
from ..models import mlp
from ..models.mlp import MLP
from ..ops import camera as camera_lib
from ..ops import compaction, grid, march, prepass, sdf, shading
from ..ops.camera import Camera
from ..utils import image_io, trace
from ..utils.config import RenderConfig
from . import schedule as schedule_lib


def _require_fp32_matmul() -> None:
    """Every float32 matmul of the march and of the shading must run in
    full FP32 on the card: TF32 keeps ~10 mantissa bits, far coarser than
    the 1e-6 march epsilon. PyTorch's default is TF32 off; refuse to render
    if a caller turned it on."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True; the renderer needs "
            "full-FP32 matmuls (set it to False)")


def neural_sdf_fn(params: MLP, frame, num_inputs: int = 3):
    """Wrap a model as an SdfFn over (..., 3) points: its chain on its
    ``plain_inputs``; num_inputs=4 appends the frame number as a 4th input
    (animation mode)."""

    def fn(p: torch.Tensor) -> torch.Tensor:
        x = params.plain_inputs(sdf.with_frame(p, frame, num_inputs))
        return mlp.apply_scalar(params.chain, x)

    return fn


def scene_fn(params: Optional[MLP], config: RenderConfig, frame, *,
             for_grad: bool = False, surface_local: bool = False):
    """The scene SDF for a config.

    With ``config.use_pallas`` the neural field evaluates through the fused
    forward kernel (K3, ``fused_mlp.neural_sdf_fn_kernel``; its plain
    version on the CPU). The kernel has no gradient: gradient consumers
    (autodiff normals) pass ``for_grad=True`` for the plain, differentiable
    chain, which gives the same values. Its gradient at a ReLU tie is
    JAX's 1/2 (``mlp.apply``).

    The chain is FP32 whatever the phase's precision: the three-pass chain
    (K2h) runs only inside the march kernel. The JAX package's dense chain
    is FP32 at every precision on the CPU too, so the parity tests compare
    like with like.

    ``surface_local=True`` declares that every evaluation point sits on
    (or within the window band of) the surface, as shading normals do:
    many_cylinder_cut then composes through ``config.cyl_window``'s grid
    window (exact there) instead of the 300-term chain."""
    if params is not None:
        params.check_render(config)
    if params is None:
        neural = None
    elif config.use_pallas and not for_grad:
        neural = fused_mlp.neural_sdf_fn_kernel(params, frame, config.num_inputs)
    else:
        neural = neural_sdf_fn(params, frame, config.num_inputs)
    return sdf.make_scene(
        config.scene, neural, frame,
        cyl_window=(config.cyl_window if surface_local else None))


def shade_fn(params: Optional[MLP], config: RenderConfig, frame):
    """Scene SDF for a render's shading normals, with surface-local
    composes. Its neural field is ``fused_mlp.neural_sdf_fn_grad_kernel``:
    on the card, for the nets it serves, one kernel gives each point's value
    and gradient, and autograd takes the neural part's gradient from it (the
    CSG composes keep autograd over their own ops); elsewhere the plain
    chain under autograd, ``scene_fn(for_grad=True)``'s. Every precision runs
    in FP32 here, so config.shade_precision selects nothing. A
    pre-activation of exactly 0 gets JAX's gradient 1/2 on both paths
    (``mlp.relu_tie``). The neural field is the model's ``shade_sdf_fn``
    (a ``HashGridSDF``'s: the encoding kernel's features and input
    gradient, its MLP's plain chain under autograd). Training never shades
    through here: it differentiates the normals themselves (``scene_fn(for_grad=True)``,
    ``shading.shade(differentiable=True)``)."""
    if params is None:
        neural = None
    else:
        params.check_render(config)
        neural = params.shade_sdf_fn(config, frame)
    return sdf.make_scene(config.scene, neural, frame, cyl_window=config.cyl_window)


def _device_of(params: Optional[MLP], device=None) -> torch.device:
    """Where a render runs: ``device`` when given, else the model's device,
    else the card (a model-free scene never falls back to the CPU)."""
    if device is not None:
        return mlp.resolve_device(device)
    return params.device if params is not None else mlp.resolve_device("cuda")


def render_image(
    params: Optional[MLP], camera: Camera, config: RenderConfig,
    matcap: Optional[torch.Tensor] = None, frame: float = 0.0, *, device=None,
) -> torch.Tensor:
    """Dense render of one frame. Returns [H, W, 4] float32 rgba in [0,1],
    row 0 = image bottom (flip at save via image_io.to_uint8_image)."""
    _require_fp32_matmul()
    dev = _device_of(params, device)
    cam_to_world, world_to_cam = camera_lib.view_matrices(camera, dev)
    origin, dirs = camera_lib.generate_rays(
        cam_to_world, config.height, config.width, config.focal)
    f = scene_fn(params, config, frame)
    if config.march_impl == "fori":
        result = march.sphere_trace_unrolled(
            f, origin, dirs, num_steps=config.max_steps, march_eps=config.march_eps,
            bound_center=config.bound_center, bound_radius=config.bound_radius)
    else:
        result = march.sphere_trace(
            f, origin, dirs, max_steps=config.max_steps, march_eps=config.march_eps,
            bound_center=config.bound_center, bound_radius=config.bound_radius)
    points = origin + dirs * result.t[:, None]
    colors = shading.shade(
        shade_fn(params, config, frame), points, dirs,
        mode=config.shading, normal_mode=config.normal_mode,
        normal_eps=config.normal_eps, world_to_cam=world_to_cam, matcap=matcap,
    )
    rgba = torch.where(result.hit[:, None], colors, 0.0)
    return rgba.reshape(config.height, config.width, 4)


def render_image_kernel(params: MLP, camera: Camera, config: RenderConfig,
                        matcap: Optional[torch.Tensor] = None,
                        frame: float = 0.0) -> torch.Tensor:
    """Full render with the kernel march and plain dense shading
    (march_impl="megakernel"), the counterpart of ``render_image_pallas``:
    the march composes with ``config.cyl_window``, the shading normals
    differentiate the dense scene through the plain chain. Returns
    [H, W, 4] float rgba, row 0 = bottom."""
    if not kscenes.kernel_supported(config.scene):
        raise ValueError(
            f"the march kernel does not support scene {config.scene!r}; use render_image")
    dev = params.device
    cam_to_world, world_to_cam = camera_lib.view_matrices(camera, dev)
    origin, dirs = camera_lib.generate_rays(
        cam_to_world, config.height, config.width, config.focal)
    t, hit = megakernel.march(params, origin, dirs, config, frame)
    points = origin + dirs * t[:, None]
    colors = shading.shade(
        scene_fn(params, config, frame, for_grad=True), points, dirs,
        mode=config.shading, normal_mode=config.normal_mode,
        normal_eps=config.normal_eps, world_to_cam=world_to_cam, matcap=matcap,
    )
    rgba = torch.where(hit[:, None], colors, torch.zeros_like(colors))
    return rgba.reshape(config.height, config.width, 4)


def _tail_kernel_fn(params, config: RenderConfig, frame):
    """The march kernel for terminal rungs that would march outside it
    (``tail_pallas``), or None. Kernel scenes only; in "full" precision
    only the pure neural scenes, whose kernel compose is the dense one
    (the windowed many_cylinder_cut is a mixed-path approximation)."""
    if not config.tail_pallas or not kscenes.kernel_supported(config.scene):
        return None
    if config.march_precision != "mixed" and config.scene not in ("neural_raw", "neural_tanh"):
        return None

    def run(sub: march.MarchState, sub_dirs, origin, eps, precision):
        return megakernel.march_state(params, origin, sub_dirs, sub, config, frame,
                                      march_eps=eps, precision=precision)

    return run


def _coarse_on_kernel(config: RenderConfig) -> bool:
    """Whether the coarse phase runs as one kernel pass (else densely, with
    ``march.march_stage``, and the coarse schedule's rungs)."""
    return (config.march_precision == "mixed" and config.coarse_pallas
            and kscenes.kernel_supported(config.scene))


def _rungs_on_kernel(config: RenderConfig) -> bool:
    """Whether the refine ladder's rungs run on the kernel: not when the
    refine kernel is turned off, on a scene the kernel does not compose,
    or for relaxed rungs under ``relax_newton``, which the kernel does not
    implement."""
    relax = config.relax_omega if config.march_precision == "mixed" else 0.0
    return (config.refine_pallas and kscenes.kernel_supported(config.scene)
            and not (relax and config.relax_newton))


def _dense_rung(cap: int, n: int, rung_steps: int, entry: bool) -> bool:
    """Whether a rung marches densely over the whole bundle (off the
    kernel, with ``march.march_stage``): its bucket spans the bundle and it
    is a ladder phase's entry rung or a terminal rung (``rung_steps`` 0),
    which must run to completion. Any other rung whose bucket spans the
    bundle is skipped."""
    return cap >= n and (entry or rung_steps == 0)


def _ladder(config: RenderConfig) -> list:
    """The mixed march's precision ladder as (precision, eps, schedule,
    caps): the near-surface set re-marches at each finer precision down to
    the epsilon that precision's SDF error allows. Tuned caps belong to the
    HIGHEST phase; the HIGH phase keeps its divisor schedule."""
    ladder = []
    if config.mid_eps > config.march_eps:
        ladder.append(("high", config.mid_eps,
                       config.mid_schedule or config.refine_schedule, None))
    ladder.append(("highest", config.march_eps, config.refine_schedule, config.refine_caps))
    return ladder


def _rung_kernel_fn(params, config: RenderConfig, frame):
    """The march kernel for the refine ladder's rungs, or None
    (``_rungs_on_kernel``)."""
    if not _rungs_on_kernel(config):
        return None

    def run(sub: march.MarchState, sub_dirs, origin, eps, precision, num_steps,
            relax_omega=0.0):
        return megakernel.march_state(
            params, origin, sub_dirs, sub, config, frame, march_eps=eps,
            num_steps=num_steps, precision=precision, relax_omega=relax_omega)

    return run


class PackedRays(NamedTuple):
    """Whole-image per-ray state in *packed lane order*: one reorderable
    bundle whose buckets are prefix slices. ``pos`` carries each lane's
    original ray index, so one final sort restores image order.

    The march budget is not carried: for every ray that can still march,
    budget == tfar(pos) - (t - tnear(pos)); buckets recompute it from
    (pos, t) like the ray directions (``_pr_bucket``)."""

    pos: torch.Tensor        # [N] int32 original ray index of this lane
    t: torch.Tensor          # [N] distance along the ray
    active: torch.Tensor     # [N] bool still marching
    converged: torch.Tensor  # [N] bool hit surface


def _pack_init(state: march.MarchState, dirs, pos=None) -> PackedRays:
    """The bundle of a march state whose lanes hold the pixel indices
    ``pos`` (default: lane i is pixel i)."""
    if pos is None:
        pos = torch.arange(dirs.shape[0], dtype=torch.int32, device=dirs.device)
    return PackedRays(pos=pos, t=state.t, active=state.active, converged=state.converged)


def _pr_sort(pr: PackedRays, mask, within=None, order=None) -> PackedRays:
    return PackedRays(*compaction.sort_pack_leaves(mask, tuple(pr), within=within, order=order))


def _pr_bucket(pr: PackedRays, cap: int, steps, cam_to_world, origin,
               config: RenderConfig):
    """Prefix bucket as (MarchState, dirs [cap,3]); directions and the
    budget are recomputed from the carried ray indices."""
    dirs = camera_lib.ray_dirs_from_index(
        cam_to_world, pr.pos[:cap], config.height, config.width, config.focal)
    tnear, tfar, bhit = march.intersect_sphere(
        origin, dirs, config.bound_center, config.bound_radius)
    t = pr.t[:cap]
    budget = torch.where(bhit, tfar - (t - torch.clamp(tnear, min=0.0)), 0.0)
    state = march.MarchState(
        t=t, budget=budget, active=pr.active[:cap],
        converged=pr.converged[:cap], steps=steps,
    )
    return state, dirs


def _pr_merge(pr: PackedRays, sub: march.MarchState) -> PackedRays:
    """A new bundle with a marched prefix bucket written over its head."""
    cap = sub.t.shape[0]

    def put(full, part):
        return torch.cat([part, full[cap:]])

    return pr._replace(
        t=put(pr.t, sub.t), active=put(pr.active, sub.active),
        converged=put(pr.converged, sub.converged),
    )


def _zero_i32(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _run_schedule(
    f, origin, cam_to_world, pr: PackedRays, steps, schedule,
    config: RenderConfig, eps, *, precision=None, tail_kernel=None,
    relax: float = 0.0, within=None, rung_kernel=None, caps=None,
    stats_collect=None, count_stranding=False, rung0: int = 0,
):
    """Sort -> march-prefix compaction rungs over the packed bundle.

    Each (div, steps) rung sorts the actives into a dense prefix and
    marches the first cap lanes ``steps`` more (0 = until the bucket runs
    dry). Actives beyond the bucket stay active for the caller's
    continuation. ``within`` bounds where actives can live; ``caps`` are
    tuned per-rung caps; ``stats_collect`` receives each rung's entry-active
    count; ``count_stranding`` folds actives stranded beyond a rung's cap
    into the returned overflow. ``rung_kernel`` marches the rungs at
    ``precision`` unless that is "default"; otherwise ``tail_kernel``
    takes terminal rungs of at most ``config.tail_pallas_max`` lanes.
    Each rung is the span ``rung<rung0 + i>`` (``utils/trace.py``).
    Returns (pr, steps, within, overflow).
    """
    n = pr.pos.shape[0]
    stranded = _zero_i32(pr.t.device)
    for rung_i, (div, rung_steps) in enumerate(schedule):
        with trace.span(f"rung{rung0 + rung_i}"):
            cap = schedule_lib.cap_for(n, div, caps[rung_i] if caps else 0, config)
            entry_active = None
            if stats_collect is not None or count_stranding:
                entry_active = pr.active.sum(dtype=torch.int32)
            if stats_collect is not None:
                stats_collect.append(entry_active)
            if count_stranding and cap < n:
                stranded = torch.maximum(stranded, entry_active - cap)
            if cap >= n:
                if _dense_rung(cap, n, rung_steps, entry=False):
                    state, dirs_b = _pr_bucket(pr, n, steps, cam_to_world, origin, config)
                    state = march.march_stage(
                        f, origin, dirs_b, state, num_steps=config.max_steps,
                        max_steps=config.max_steps, march_eps=eps, relax_omega=relax,
                        newton=config.relax_newton, omega_max=config.relax_omega_max)
                    pr, steps = _pr_merge(pr, state), state.steps
                continue
            pr = _pr_sort(pr, pr.active, within=within)
            sub, dirs_b = _pr_bucket(pr, cap, steps, cam_to_world, origin, config)
            use_tail = (tail_kernel is not None and rung_steps == 0
                        and cap <= config.tail_pallas_max)
            if rung_kernel is not None and precision != "default":
                sub = rung_kernel(sub, dirs_b, origin, eps, precision,
                                  None if rung_steps == 0 else rung_steps, relax_omega=relax)
            elif use_tail:
                sub = tail_kernel(sub, dirs_b, origin, eps, precision)
            else:
                sub = march.march_stage(
                    f, origin, dirs_b, sub,
                    num_steps=(config.max_steps if rung_steps == 0 else rung_steps),
                    max_steps=config.max_steps, march_eps=eps, relax_omega=relax,
                    newton=config.relax_newton, omega_max=config.relax_omega_max)
            pr, steps = _pr_merge(pr, sub), sub.steps
            within = cap
    return pr, steps, within, stranded


@functools.lru_cache(maxsize=8)
def _block_order(h: int, w: int, bh: int, bw: int, device: torch.device) -> torch.Tensor:
    """Pixel-index permutation grouping lanes into bh x bw image blocks
    (block-major, row-major inside a block). Per-ray results do not depend
    on lane order; the order keeps neighbouring pixels in neighbouring
    lanes, so a warp's rays tend to need similar step counts."""
    ys, xs = np.mgrid[0:h, 0:w]
    key = (ys // bh) * ((w + bw - 1) // bw) + (xs // bw)
    order = np.argsort(key.ravel(), kind="stable").astype(np.int32)
    return torch.as_tensor(order, device=device)


def _prepass_on(config: RenderConfig) -> bool:
    """Whether a cold image-order frame of ``config`` starts from the
    cone-traced prepass: the mixed march, ``prepass_factor > 1`` dividing
    both H and W (the JAX package skips it silently otherwise)."""
    f = config.prepass_factor
    return (config.march_precision == "mixed" and f > 1
            and config.height % f == 0 and config.width % f == 0)


def _grid_on(config: RenderConfig) -> bool:
    """Whether every frame of ``config`` walks the baked grid after its
    init: the mixed march with ``grid_res`` set."""
    return config.march_precision == "mixed" and bool(config.grid_res)


def _warm_block_order(config: RenderConfig) -> bool:
    """True when the coarse kernel pass runs in block-major lane order: the
    order warm-start state is produced in and consumed from (the predicate
    of ``_scheduled_march``'s ``coarse_block`` branch)."""
    return _coarse_on_kernel(config) and bool(config.coarse_block) and not config.grid_res


def _warm_guard(coarse, origin, dirs, state: march.MarchState,
                config: RenderConfig) -> march.MarchState:
    """Warm-start inside-surface guard (``RenderConfig.warm_margin``): one
    probe of the coarse SDF at the warm points; lanes that landed inside the
    surface (a closer surface swung in front of the pixel since the last
    frame) restart cold from the bounding sphere."""
    cold = march.init_state(origin, dirs, config.bound_center, config.bound_radius)
    d0 = coarse(origin + dirs * state.t[:, None])
    bad = state.active & (d0 < 0.0)
    return state._replace(t=torch.where(bad, cold.t, state.t),
                          budget=torch.where(bad, cold.budget, state.budget))


def _march_init(fine, origin, dirs, config: RenderConfig, t_init=None,
                use_prepass: bool = False) -> march.MarchState:
    """The state the coarse phase starts from: the cone-traced prepass
    (``use_prepass``: image-order lanes of a cold frame), else the
    bounding-sphere init, warm-started from ``t_init`` and guarded; then,
    with ``_grid_on(config)``, the baked-grid walk. ``fine`` is the coarse
    phase's SDF: the dense chain, FP32 at every precision here, the fused
    forward kernel under ``use_pallas``."""
    if use_prepass:
        # The cone-traced prepass (ops/prepass.py) reads the lanes as an
        # H x W image: sky neighbourhoods die, the rest start margin-close.
        state = prepass.prepass_init(
            fine, origin, dirs, config.height, config.width, config.prepass_factor,
            margin=config.coarse_eps, bound_center=config.bound_center,
            bound_radius=config.bound_radius)
    else:
        # t_init arrives in this lane order (_render_scheduled's
        # return_state sorts it so: no gather), its margins applied by the
        # producer.
        state = march.init_state(origin, dirs, config.bound_center, config.bound_radius,
                                 t_init=t_init, warm_margin=0.0)
        if t_init is not None:
            state = _warm_guard(fine, origin, dirs, state, config)
    if _grid_on(config):
        # The baked-grid walk (ops/grid.py) after any init, warm and
        # sharded lanes included; its steps count against max_steps.
        gbound = config.bound_radius * 1.05
        baked = grid.bake(fine, config.grid_res, gbound, device=dirs.device)
        state = grid.grid_march(baked, origin, dirs, state, bound=gbound,
                                max_steps=config.max_steps)
    return state


def _scheduled_march(params, cam_to_world, origin, dirs, config: RenderConfig,
                     frame, t_init=None, pos=None):
    """The staged march: the coarse phase, then the precision ladder.

    ``t_init`` [N] warm-starts the march (``render_sequence(warm_start=True)``):
    each lane's suggested start depth, margins already applied, in the lane
    order of ``_render_scheduled(return_state=True)``'s output (block-major
    when ``_warm_block_order(config)``, else image order); non-finite or
    non-positive lanes start cold, and ``_warm_guard`` resets lanes that
    start inside the surface.

    ``pos`` [n] int32 (optional): the global pixel index of each lane, for
    a caller that marches a subset of the image (a shard or a band of
    parallel/), in the caller's lane order; ``dirs`` (and ``t_init``) must
    already correspond to it. The image-order phases (the prepass, the
    block reorder and with it the warm block hand-off) are skipped; every
    later stage reads the carried index.

    A cold image-order frame with ``_prepass_on(config)`` starts from the
    prepass in image order (no block reorder); with ``grid_res`` every
    frame walks the baked grid after its init.

    Returns (pr, steps, refine_overflow, rung_actives)."""
    fine = scene_fn(params, config, frame)
    mixed = config.march_precision == "mixed"
    tail_kernel = _tail_kernel_fn(params, config, frame)
    if mixed:
        prec_a = config.coarse_precision  # "default" or "high"
        eps_a, schedule_a = config.coarse_eps, config.coarse_schedule
    else:
        prec_a = "highest"
        eps_a, schedule_a = config.march_eps, config.fine_schedule
    relax = config.relax_omega if mixed else 0.0
    with trace.span("coarse"):
        use_prepass = t_init is None and pos is None and _prepass_on(config)
        pos0 = pos
        if pos is None and not use_prepass and _warm_block_order(config):
            # Block-major lane order (_block_order) for the coarse kernel pass.
            bh, bw = config.coarse_block
            pos0 = _block_order(config.height, config.width, bh, bw, dirs.device)
            dirs = camera_lib.ray_dirs_from_index(
                cam_to_world, pos0, config.height, config.width, config.focal)
        state = _march_init(fine, origin, dirs, config, t_init, use_prepass)

        if _coarse_on_kernel(config):
            # The whole coarse phase as ONE run-to-dry kernel pass over the image.
            state, resolve = megakernel.march_state(
                params, origin, dirs, state, config, frame, march_eps=eps_a,
                precision=prec_a, relax_omega=(0.0 if config.relax_newton else relax),
                return_resolve=True, cyl_window=config.cyl_window_coarse, coarse=True)
            # The coarse resolve step is the refine phase's difficulty key;
            # valid while pr stays in the coarse lane order.
            pr = _pack_init(state, dirs, pos0)
            difficulty = resolve if config.ordered_packing else None
            steps = state.steps
        else:
            state = march.march_stage(
                fine, origin, dirs, state, num_steps=config.stage_steps,
                max_steps=config.max_steps, march_eps=eps_a, relax_omega=relax,
                newton=config.relax_newton, omega_max=config.relax_omega_max)
            pr, steps = _pack_init(state, dirs, pos0), state.steps
            difficulty = None
            pr, steps, _, _ = _run_schedule(
                fine, origin, cam_to_world, pr, steps, schedule_a, config, eps_a,
                precision=prec_a, tail_kernel=tail_kernel, relax=relax, within=None)

    dev = dirs.device
    refine_overflow = _zero_i32(dev)
    rung_actives = torch.zeros((len(config.refine_schedule),), dtype=torch.int32, device=dev)
    with trace.span("refine"):
        if mixed:
            rung_kernel = _rung_kernel_fn(params, config, frame)
            for prec, eps, schedule, caps in _ladder(config):
                # Per-rung stats belong to the HIGHEST phase.
                collect = [] if prec == "highest" else None
                pr, steps, _, ovf = _refine_phase(
                    fine, origin, cam_to_world, pr, steps, config, eps,
                    precision=prec, tail_kernel=tail_kernel, relax=config.relax_omega_refine,
                    rung_kernel=rung_kernel, schedule=schedule, order=difficulty, caps=caps,
                    stats_collect=collect,
                )
                if collect is not None:
                    rung_actives = torch.stack(collect)
                refine_overflow = torch.maximum(refine_overflow, ovf)
                # later phases see a re-sorted bundle: the image-order key is stale
                difficulty = None
    return pr, steps, refine_overflow, rung_actives


def _refine_phase(
    f, origin, cam_to_world, pr: PackedRays, steps, config: RenderConfig,
    eps, *, precision, tail_kernel=None, relax: float = 0.0, rung_kernel=None,
    schedule=None, order=None, caps=None, stats_collect=None,
):
    """One ladder phase: re-mark the near-surface set (converged or active)
    active, sort it into the first rung's bucket, march, then drain the
    straggler tail through the remaining rungs. Near rays beyond the first
    bucket (or stranded past a later rung's cap) are reported as overflow
    so the caller retries with wider buckets. The phase is the span
    ``<precision>``, its entry rung ``rung0`` (``utils/trace.py``)."""
    with trace.span(precision):
        n = pr.pos.shape[0]
        if schedule is None:
            schedule = config.refine_schedule
        near = pr.converged | pr.active
        refine_count = near.sum(dtype=torch.int32)
        if stats_collect is not None:
            stats_collect.append(refine_count)
        overflow = _zero_i32(near.device)
        div0, steps0 = schedule[0]
        cap = schedule_lib.cap_for(n, div0, caps[0] if caps else 0, config)
        with trace.span("rung0"):
            if not _dense_rung(cap, n, steps0, entry=True):
                # Slim entry sort: only (pos, t) ride it; the packed active prefix
                # is a lane comparison and converged is cleared phase-wide.
                pos, t = compaction.sort_pack_leaves(near, (pr.pos, pr.t), order=order)
                lane = torch.arange(n, dtype=torch.int32, device=near.device)
                pr = PackedRays(pos=pos, t=t, active=lane < refine_count,
                                converged=torch.zeros_like(near))
                sub, dirs_b = _pr_bucket(pr, cap, steps, cam_to_world, origin, config)
                # Constant over-relaxation is off in the phase's first rung: its
                # bulk sits within ~coarse_eps of the surface head-on (3e-3 by
                # default), where a fixed omega > 1 overshoots and backtracks every
                # other step. On the H100 at every coarse_eps from 0.05 to 1e-4 the
                # 1080p rung leaves more lanes active, in more time, relaxed at 1.6
                # than plain (benchmarks/precision_ladder.py). The secant-adaptive
                # one steps plainly there, so it stays on.
                if rung_kernel is not None and precision != "default":
                    sub = rung_kernel(sub, dirs_b, origin, eps, precision,
                                      None if steps0 == 0 else steps0)
                else:
                    sub = march.march_stage(
                        f, origin, dirs_b, sub,
                        num_steps=(config.max_steps if steps0 == 0 else steps0),
                        max_steps=config.max_steps, march_eps=eps,
                        relax_omega=(relax if config.relax_newton else 0.0),
                        newton=config.relax_newton, omega_max=config.relax_omega_max)
                pr, steps = _pr_merge(pr, sub), sub.steps
                within = cap
                overflow = torch.clamp(refine_count - cap, min=0)
            else:
                state, dirs_b = _pr_bucket(
                    pr._replace(active=near, converged=torch.zeros_like(near)), n, steps,
                    cam_to_world, origin, config)
                state = march.march_stage(
                    f, origin, dirs_b, state, num_steps=config.max_steps,
                    max_steps=config.max_steps, march_eps=eps, relax_omega=relax,
                    newton=config.relax_newton, omega_max=config.relax_omega_max)
                pr, steps = _pr_merge(pr, state), state.steps
                within = n
        pr, steps, within, stranded = _run_schedule(
            f, origin, cam_to_world, pr, steps, schedule[1:], config, eps,
            precision=precision, tail_kernel=tail_kernel, relax=relax, within=within,
            rung_kernel=rung_kernel, caps=(caps[1:] if caps else None),
            stats_collect=stats_collect, count_stranding=True, rung0=1,
        )
        return pr, steps, within, torch.maximum(overflow, stranded)


def _stage_step(params, origin, dirs, state, config: RenderConfig, frame, num_steps):
    """One continuation stage: march up to num_steps dense steps."""
    f = scene_fn(params, config, frame)
    return march.march_stage(
        f, origin, dirs, state, num_steps=num_steps,
        max_steps=config.max_steps, march_eps=config.march_eps)


def _shade_final(params, origin, dirs, t, hit, world_to_cam, config: RenderConfig,
                 matcap, frame):
    """Dense shading of image-order (t, hit) — the slow path's last step."""
    points = origin + dirs * t[:, None]
    colors = shading.shade(
        shade_fn(params, config, frame), points, dirs,
        mode=config.shading, normal_mode=config.normal_mode,
        normal_eps=config.normal_eps, world_to_cam=world_to_cam, matcap=matcap,
    )
    rgba = torch.where(hit[:, None], colors, 0.0)
    if config.rgba_packed:
        # Same u8 quantization as the fast path's packed restore.
        rgba = shading.unpack_rgba_u32(shading.pack_rgba_u32(rgba))
    return rgba.reshape(config.height, config.width, 4)


def _u32_words(packed: torch.Tensor) -> torch.Tensor:
    """``shading.pack_rgba_u32``'s words (held in int64) as int32 of the same
    32 bits: a quarter of the float32 frame's bytes to fetch, read on the
    host as uint32 (``image_io.packed_u32_to_uint8_image``)."""
    return torch.where(packed >= 2 ** 31, packed - 2 ** 32, packed).to(torch.int32)


def _shade_packed(params, origin, cam_to_world, pr: PackedRays, world_to_cam,
                  config: RenderConfig, matcap, frame, within=None,
                  packed_out: bool = False, flat: bool = False):
    """Shade hit pixels in packed lane order, then restore image order.

      * ``within`` bound (mixed march): shade that prefix in place, masked
        by the converged flags — no hit-pack sort;
      * no bound, bucket smaller than the image (full-precision march):
        hits sort into an N/shade_div bucket (the caller re-shades densely
        if hit_count exceeds it);
      * bucket >= image: shade densely.

    ``packed_out=True`` returns the u32 [H, W] display image (``_u32_words``)
    in place of float rgba. ``flat=True`` returns the colours as [n, 4]
    (or [n] words) in pos-ascending lane order, with no image reshape: a
    bundle over a subset of the image (parallel/) colours its own pixels.

    Returns (rgba [H,W,4], pr unchanged, hit_count)."""
    region, pos_sh, region_colors, hit_count = _shade_hits(
        params, origin, cam_to_world, pr, world_to_cam, config, matcap, frame, within)
    rgba = _restore_image(region_colors, region, pos_sh, config, packed_out, flat)
    return rgba, pr, hit_count


def _shade_hits(params, origin, cam_to_world, pr: PackedRays, world_to_cam,
                config: RenderConfig, matcap, frame, within):
    """``_shade_packed``'s shading: (region, pos_sh, colours of the region's
    lanes, hit_count), the lanes' pixel indices ``pos_sh``."""
    n = pr.pos.shape[0]
    cap = schedule_lib.shade_capacity(config, n, within)
    hit_count = pr.converged.sum(dtype=torch.int32)
    f = shade_fn(params, config, frame)

    def shade_region(pos, t, conv):
        sub_dirs = camera_lib.ray_dirs_from_index(
            cam_to_world, pos, config.height, config.width, config.focal)
        points = origin + sub_dirs * t[:, None]
        colors = shading.shade(
            f, points, sub_dirs, mode=config.shading,
            normal_mode=config.normal_mode, normal_eps=config.normal_eps,
            world_to_cam=world_to_cam, matcap=matcap)
        return torch.where(conv[:, None], colors, 0.0)

    if within is not None and within < n:
        region, pos_sh = within, pr.pos
        region_colors = shade_region(pr.pos[:region], pr.t[:region], pr.converged[:region])
    elif cap >= n:
        region, pos_sh = n, pr.pos
        region_colors = shade_region(pr.pos, pr.t, pr.converged)
    else:
        # Slim hit-pack: only (pos, t, conv) ride the sort; the caller
        # keeps the unsorted bundle for the slow-path restore.
        region = cap
        pos_sh, t_sh, conv_sh = compaction.sort_pack_leaves(
            pr.converged, (pr.pos, pr.t, pr.converged), within=within)
        region_colors = shade_region(pos_sh[:cap], t_sh[:cap], conv_sh[:cap])
    return region, pos_sh, region_colors, hit_count


def _restore_image(region_colors, region: int, pos_sh, config: RenderConfig,
                   packed_out: bool, flat: bool):
    """``_shade_packed``'s restore: the region's colours padded to every lane
    and sorted back to pixel order by ``pos_sh``."""
    n = pos_sh.shape[0]
    if config.rgba_packed:
        packed = shading.pack_rgba_u32(region_colors)
        if region < n:
            packed = torch.cat([packed, packed.new_zeros(n - region)])
        (restored,) = compaction.sort_restore_leaves(pos_sh, (packed,))
        rgba = _u32_words(restored) if packed_out else shading.unpack_rgba_u32(restored)
    else:
        colors = region_colors
        if region < n:
            colors = torch.cat([colors, colors.new_zeros((n - region, 4))])
        (rgba,) = compaction.sort_restore_leaves(pos_sh, (colors,))
        if packed_out:
            rgba = _u32_words(shading.pack_rgba_u32(rgba))
    if flat:
        return rgba
    if packed_out:
        return rgba.reshape(config.height, config.width)
    return rgba.reshape(config.height, config.width, 4)


def _restore_state(pr: PackedRays, steps, origin, dirs,
                   config: RenderConfig) -> march.MarchState:
    """Restore a packed bundle's march state to image order (slow path);
    the budget is rebuilt from budget == tfar - (t - tnear)."""
    t, active, converged = compaction.sort_restore_leaves(
        pr.pos, (pr.t, pr.active, pr.converged))
    tnear, tfar, bhit = march.intersect_sphere(
        origin, dirs, config.bound_center, config.bound_radius)
    budget = torch.where(bhit, tfar - (t - torch.clamp(tnear, min=0.0)), 0.0)
    return march.MarchState(
        t=t, budget=budget, active=active, converged=converged,
        steps=torch.tensor(int(steps), dtype=torch.int32, device=dirs.device),
    )


def _render_scheduled(params, camera, config: RenderConfig, matcap, frame,
                      t_init=None, return_state: bool = False, packed_out: bool = False):
    """March + compacted shading of one frame, with no host sync.

    ``camera`` is a Camera or its pose tensor on the device, and ``frame`` a
    float or a [] float32 tensor on the device (a CUDA graph's static
    inputs: ``_ChunkGraph``). ``t_init`` warm-starts the march
    (``_scheduled_march``); ``return_state=True`` appends the next frame's
    warm init (t, hit), restored by one sort into the order the next frame
    consumes with no gather: keyed on (block id, pixel index) when
    ``_warm_block_order(config)``, else on the pixel index.
    ``packed_out=True`` returns the u32 [H, W] image (``_shade_packed``).

    Returns (rgba, packed pr, stats[, (t, hit)]) with stats the frame's
    vector (``schedule_lib.encode``), so the caller fetches once."""
    dev = _device_of(params)
    with trace.span("frame", dev):
        frame = sdf.frame_tensor(frame, dev)
        cam_to_world, world_to_cam = camera_lib.view_matrices(camera, dev)
        origin, dirs = camera_lib.generate_rays(
            cam_to_world, config.height, config.width, config.focal)
        pr, steps, refine_overflow, rung_actives = _scheduled_march(
            params, cam_to_world, origin, dirs, config, frame, t_init)
        with trace.span("shade"):
            region, pos_sh, colors, hit_count = _shade_hits(
                params, origin, cam_to_world, pr, world_to_cam, config, matcap, frame,
                schedule_lib.conv_within(config))
        with trace.span("restore"):
            rgba = _restore_image(colors, region, pos_sh, config, packed_out, flat=False)
            stats = schedule_lib.encode(pr.active.sum(dtype=torch.int32), steps, hit_count,
                                    refine_overflow, rung_actives)
            if not return_state:
                return rgba, pr, stats
            if _warm_block_order(config):
                # (block id, pixel index) as one int64 key: _block_order's order.
                bh, bw = config.coarse_block
                pos = pr.pos.to(torch.int64)
                block = ((pos // (config.width * bh)) * (-(-config.width // bw))
                         + (pos % config.width) // bw)
                perm = torch.sort(block * config.num_rays + pos).indices
                state = (pr.t[perm], pr.converged[perm])
            else:
                state = compaction.sort_restore_leaves(pr.pos, (pr.t, pr.converged))
            return rgba, pr, stats, tuple(state)


def _dense_fallback(params, camera, config, matcap, frame, stats_out):
    rgba = render_image(params, camera, config, matcap, frame)
    if config.rgba_packed:
        rgba = shading.unpack_rgba_u32(shading.pack_rgba_u32(rgba))
    if stats_out is not None:
        stats_out.update(fast_path=False, dense_fallback=True)
    return rgba


def render_staged(
    params: MLP, camera: Camera, config: RenderConfig,
    matcap: Optional[torch.Tensor] = None, frame: float = 0.0, *,
    stats_out: Optional[dict] = None,
) -> torch.Tensor:
    """Staged-compaction render — the main path. Returns [H, W, 4] float
    rgba on the parameters' device.

    The whole frame is dispatched without a host sync; one fetch of the
    stats vector then decides whether the frame is final. Leftovers
    (bucket overflow, rays needing more than the schedule gave) are handled
    by an overflow retry with wider buckets or a host-driven continuation.
    Spans (``utils/trace.py``): ``sequence/enqueue`` (the frame's
    dispatch), ``sequence/fetch`` (the stats fetch) and ``sequence/finish``
    (the checks, retries and tuning).
    """
    _require_fp32_matmul()
    frame = float(frame)
    orig_config = config
    config = schedule_lib.memo_lookup(params, config)

    with trace.span("sequence/enqueue"):
        rgba, pr, stats = _render_scheduled(params, camera, config, matcap, frame)
    with trace.span("sequence/fetch"):
        stats = stats.cpu().numpy()  # the one host fetch of the fast path
    with trace.span("sequence/finish"):
        return _staged_finish(params, camera, config, orig_config, matcap, frame, rgba, pr,
                              stats, stats_out)


def _staged_finish(params, camera, config: RenderConfig, orig_config: RenderConfig, matcap,
                   frame: float, rgba, pr: PackedRays, stats, stats_out):
    """render_staged after the fetch: the fast-path check, the overflow
    retry, the slow path's continuation and adaptive tuning."""
    st = schedule_lib.decode(stats, config)
    fast = schedule_lib.check_fast(st, config)
    if stats_out is not None:
        stats_out.update(st.record(config, fast))
    if fast:
        schedule_lib.maybe_tune(params, orig_config, config, st)
        return rgba

    if st.refine_overflow > 0:
        # Refinement bucket under-provisioned: retry with buckets resized
        # from this frame's own stats (or doubled). A bucket spanning the
        # image cannot overflow, so this terminates.
        widened = schedule_lib.widen_or_retune(config, st)
        if widened == config:
            return _dense_fallback(params, camera, config, matcap, frame, stats_out)
        result = render_staged(params, camera, widened, matcap, frame, stats_out=stats_out)
        schedule_lib.memo_teach(params, orig_config, widened)
        if stats_out is not None:
            stats_out.update(fast_path=False)
        return result

    if config.march_precision != "mixed" and st.active > 0 and st.steps >= config.max_steps:
        # Step-starved truncation in "full" mode: re-render densely for
        # exact truncation semantics.
        return _dense_fallback(params, camera, config, matcap, frame, stats_out)

    n_rays = config.num_rays
    # Slow path (rare): restore the packed state to image order and
    # continue with host-driven stages + dense shading.
    dev = _device_of(params)
    cam_to_world, world_to_cam = camera_lib.view_matrices(camera, dev)
    origin, dirs = camera_lib.generate_rays(
        cam_to_world, config.height, config.width, config.focal)
    full = _restore_state(pr, st.steps, origin, dirs, config)

    while True:
        active_count = int(full.active.sum())
        steps_done = int(full.steps)
        if active_count == 0 or steps_done >= config.max_steps:
            break
        stage_len = config.max_steps - steps_done
        cap = compaction.capacity_bucket_of(active_count, n_rays, minimum=config.compact_min)
        if cap >= n_rays:
            full = _stage_step(params, origin, dirs, full, config, frame, stage_len)
            continue
        idx, valid = compaction.compact_indices(full.active, cap)
        sub = march.MarchState(
            t=full.t[idx], budget=full.budget[idx],
            active=full.active[idx] & valid, converged=full.converged[idx] & valid,
            steps=full.steps,
        )
        sub = _stage_step(params, origin, dirs[idx], sub, config, frame, stage_len)
        t, budget, active, converged = compaction.scatter_state(
            (full.t, full.budget, full.active, full.converged),
            (sub.t, sub.budget, sub.active, sub.converged), idx, valid)
        full = march.MarchState(t, budget, active, converged, steps=sub.steps)

    if config.march_precision != "mixed" and int(full.active.sum()) > 0:
        return _dense_fallback(params, camera, config, matcap, frame, stats_out)

    if stats_out is not None:
        stats_out.update(
            fast_path=False, steps=int(full.steps),
            hits=int(full.converged.sum()), unresolved=int(full.active.sum()),
        )
    return _shade_final(params, origin, dirs, full.t, full.converged, world_to_cam,
                        config, matcap, frame)


def frame_reads_host(config: RenderConfig) -> bool:
    """Whether a staged frame of ``config`` reads the device from the host
    between its ray build and its stats, so that it cannot be captured in a
    CUDA graph: wherever a march runs outside the kernel,
    ``march.march_stage`` reads the step counter and the active count every
    step. That is the coarse phase off the kernel (``coarse_pallas=False``,
    ``march_precision="full"``, a scene the kernel does not compose), a
    refine rung off it (``refine_pallas=False``; ``relax_newton``'s relaxed
    rungs, which the kernel has no Newton step for), and a bucket that spans
    the image (``compact_min`` at or above the image's rays: small images),
    which marches densely. It asks the helpers that route the staged march
    (``_coarse_on_kernel``, ``_rungs_on_kernel``, ``_ladder``,
    ``_dense_rung``). The prepass and the grid walk read their loop flag
    every few steps too (``_prepass_on``, ``_grid_on``)."""
    if not (_coarse_on_kernel(config) and _rungs_on_kernel(config)):
        return True
    if _prepass_on(config) or _grid_on(config):
        return True
    n = config.num_rays
    return any(_dense_rung(schedule_lib.cap_for(n, div, caps[i] if caps else 0, config), n,
                           rung_steps, entry=(i == 0))
               for _, _, schedule, caps in _ladder(config)
               for i, (div, rung_steps) in enumerate(schedule))


#: CUDA graphs captured by ``render_sequence(chunk=k)`` in this process,
#: and their replays (each replay renders k frames; a graph's kernel nodes
#: were counted once, by each wrapper's launch count, at capture).
GRAPH_CAPTURES = 0
GRAPH_REPLAYS = 0

# Captured chunk graphs by (config, k, device, tracing on), most recently used last.
_GRAPHS: "collections.OrderedDict" = collections.OrderedDict()
_MAX_GRAPHS = 4


class _ChunkGraph:
    """k staged frames (``_render_scheduled`` each) captured as one CUDA
    graph: the counterpart of the JAX package's ``lax.scan`` chunk
    (``_render_scheduled_chunk``). Its inputs are static buffers on the
    device, poses [k, 5] (``camera.pose_tensor``) and frame numbers [k],
    written before each replay; the march kernel reads the frame from
    device memory, so one capture serves any cameras and frames. Each
    replay overwrites its outputs (rgba and stats per frame), so ``replay``
    clones them out. The graph holds pointers to the parameters, their
    packed stacks and the matcap: ``matches`` says whether it may serve a
    call."""

    def __init__(self, params, config: RenderConfig, matcap, poses, frames):
        global GRAPH_CAPTURES
        self.params, self.matcap = params, matcap
        self.stack = _graph_reads(params)
        self.poses, self.frames = poses.clone(), frames.clone()
        k = frames.shape[0]
        dev = frames.device
        # Warm up on the capture stream first: the library, the lazily made
        # constants and block order, the kernels' shared-memory attributes,
        # cuBLAS's workspace and the autograd normals all exist before
        # capture begins.
        stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            _render_scheduled(params, self.poses[0], config, matcap, self.frames[0])
        torch.cuda.current_stream(dev).wait_stream(stream)
        t0 = time.perf_counter()
        launches = megakernel.KERNEL_LAUNCHES
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            outs = [_render_scheduled(params, self.poses[j], config, matcap, self.frames[j])
                    for j in range(k)]
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.march_nodes = megakernel.KERNEL_LAUNCHES - launches
        self.rgba = [o[0] for o in outs]
        self.stats = [o[2] for o in outs]
        GRAPH_CAPTURES += 1

    def matches(self, params, matcap) -> bool:
        reads = _graph_reads(params)
        return (self.params is params and len(self.stack) == len(reads)
                and all(a is b for a, b in zip(self.stack, reads)) and self.matcap is matcap)

    def replay(self, poses, frames):
        """Render k frames at ``poses`` [k, 5] and ``frames`` [k] (device
        tensors): ([rgba], [stats]), each a fresh tensor."""
        global GRAPH_REPLAYS
        self.poses.copy_(poses)
        self.frames.copy_(frames)
        self.graph.replay()
        GRAPH_REPLAYS += 1
        return [r.clone() for r in self.rgba], [st.clone() for st in self.stats]


def _graph_reads(params) -> tuple:
    """The parameters' tensors a captured graph reads by pointer: the
    chain's packed stack and the encoding's table and level words."""
    if params is None:
        return ()
    return (fused_mlp.packed_params(params.chain)[0],) + tuple(params.grid() or ())


def reset_graphs() -> None:
    """Drop every captured chunk graph and the device memory it holds."""
    _GRAPHS.clear()


def graph_stats() -> dict:
    """Captures and replays in this process, and each cached graph's k,
    march-kernel nodes and capture time."""
    return dict(captures=GRAPH_CAPTURES, replays=GRAPH_REPLAYS, graphs=[
        dict(k=key[1], width=key[0].width, height=key[0].height, scene=key[0].scene,
             march_nodes=g.march_nodes, capture_ms=g.capture_ms)
        for key, g in _GRAPHS.items()])


def _chunk_graph(params, config: RenderConfig, matcap, poses, frames) -> _ChunkGraph:
    """The graph of (config, k, device, tracing on) that ``matches`` these
    parameters and matcap, else a new capture at these inputs: a graph
    captured with the trace's marks and counters never serves an untraced
    call, nor the reverse."""
    key = (config, frames.shape[0], str(frames.device), trace.enabled())
    g = _GRAPHS.get(key)
    if g is None or not g.matches(params, matcap):
        _GRAPHS.pop(key, None)
        g = _ChunkGraph(params, config, matcap, poses, frames)
        _GRAPHS[key] = g
        while len(_GRAPHS) > _MAX_GRAPHS:
            _GRAPHS.popitem(last=False)
    _GRAPHS.move_to_end(key)
    return g


def _render_chunks(params, cameras, frames, config: RenderConfig, matcap,
                   k: int, dev) -> list:
    """Every frame through k-frame CUDA graphs: (rgba, stats) per frame. The
    tail chunk is padded with the last camera and frame, and the pads
    dropped. All poses and frames reach the device in one copy that does
    not block; each replay's inputs are copies on the device."""
    n = len(cameras)
    slots = -(-n // k) * k
    idx = [min(j, n - 1) for j in range(slots)]
    host = torch.stack([camera_lib.pose_tensor(cameras[j]) for j in idx])
    poses = host.pin_memory().to(dev, non_blocking=True)
    fr = torch.tensor([frames[j] for j in idx], dtype=torch.float32)
    fr = fr.pin_memory().to(dev, non_blocking=True)
    graph = _chunk_graph(params, config, matcap, poses[:k], fr[:k])
    queued = []
    for c in range(0, slots, k):
        rgbas, stats = graph.replay(poses[c:c + k], fr[c:c + k])
        queued.extend(list(zip(rgbas, stats))[:max(0, min(k, n - c))])
    return queued


def render_sequence(
    params: MLP, cameras, config: RenderConfig,
    matcap: Optional[torch.Tensor] = None, frames=None, *,
    stats_out: Optional[list] = None, warm_start: bool = False,
    chunk: Optional[int] = None,
) -> list:
    """Pipelined multi-frame rendering with one host sync for the batch.

    Every frame is dispatched without a host sync (the card queues the
    frames' work back to back), the per-frame stats vectors are stacked on
    the device, and one fetch drains them. Frames whose stats flag a slow
    path (bucket overflow, leftover budget) are re-rendered individually
    through ``render_staged``. This is the turntable mode: the reference's
    doABarrelRoll (src/main.cpp:470-478) renders 360 such frames back to
    back.

    ``warm_start=True`` chains each frame's surface into the next frame's
    march init (``RenderConfig.warm_margin``): the second frame starts its
    hits ``warm_margin`` short of the first's surface, and from the third
    on, where both earlier frames hit, at the linear extrapolation
    ``2 t_N - t_{N-1} - warm_margin / 4``. The chain stays on the device
    and adds no host sync. Meant for smooth camera paths (the turntable);
    an approximation near silhouettes, so benchmarks render cold.

    ``chunk=k > 1`` renders k frames at a time as one CUDA graph
    (``_ChunkGraph``: captured once per config, k, parameters and matcap,
    then replayed), the counterpart of the JAX package's fused ``lax.scan``
    chunk; images and stats are those of ``chunk=1``. It runs frame by frame
    where there is nothing to capture: on the CPU, and for configs whose
    frames read the host (``frame_reads_host``). ``warm_start=True``
    ignores ``chunk``, as the JAX package does. On the card a capture or
    replay that fails raises.

    ``stats_out`` receives one dict per frame. Returns a list of [H, W, 4]
    rgba tensors on the parameters' device. Spans (``utils/trace.py``):
    ``sequence/enqueue`` (up to the stats fetch: the graph replays or the
    frames' dispatch), ``sequence/fetch`` and ``sequence/finish``
    (``_sequence_finish``).
    """
    _require_fp32_matmul()
    if frames is None:
        frames = [0.0] * len(cameras)
    frames = [float(f) for f in frames]
    if not cameras:
        return []
    orig_config = config
    with trace.span("sequence/enqueue"):
        config = schedule_lib.memo_lookup(params, config)
        dev = _device_of(params)
        if (chunk is not None and chunk > 1 and not warm_start and dev.type == "cuda"
                and not frame_reads_host(config)):
            queued = _render_chunks(params, cameras, frames, config, matcap, int(chunk), dev)
        else:
            queued = []
            prev = prev2 = None
            for cam, fr in zip(cameras, frames):
                if not warm_start:
                    rgba, _, stats = _render_scheduled(params, cam, config, matcap, fr)
                    queued.append((rgba, stats))
                    continue
                t_init = None
                if prev is not None:
                    t_prev, hit_prev = prev
                    t_init = torch.where(hit_prev, t_prev - config.warm_margin, float("-inf"))
                    if prev2 is not None:
                        t_pp, hit_pp = prev2
                        pred = 2.0 * t_prev - t_pp - 0.25 * config.warm_margin
                        t_init = torch.where(hit_prev & hit_pp, pred, t_init)
                rgba, _, stats, state = _render_scheduled(params, cam, config, matcap, fr, t_init,
                                                          return_state=True)
                prev2, prev = prev, state
                queued.append((rgba, stats))
        stacked = torch.stack([st for _, st in queued])
    with trace.span("sequence/fetch"):
        all_stats = stacked.cpu().numpy()  # the one sync
    with trace.span("sequence/finish"):
        return _sequence_finish(params, cameras, frames, queued, all_stats, config,
                                orig_config, matcap, stats_out)


def _sequence_finish(params, cameras, frames, queued, all_stats,
                     config: RenderConfig, orig_config: RenderConfig,
                     matcap, stats_out) -> list:
    """render_sequence after the drain: per-frame fast-path checks,
    slow-path re-renders, stats_out, and batch-max adaptive tuning."""
    batch = [schedule_lib.decode(v, config) for v in all_stats]
    fast = [schedule_lib.check_fast(st, config) for st in batch]
    if stats_out is not None:
        stats_out.extend(st.record(config, f) for st, f in zip(batch, fast))
    out = [_finish_queued(params, cam, config, orig_config, matcap, fr, rgba, st, f)
           for (rgba, _), st, f, cam, fr in zip(queued, batch, fast, cameras, frames)]
    if all(fast):
        schedule_lib.maybe_tune_batch(params, orig_config, config, batch)
    return out


def _finish_queued(params, camera, config: RenderConfig, orig_config: RenderConfig, matcap,
                   frame, rgba, st: schedule_lib.FrameStats, fast: bool):
    """A pipelined frame's image after the drain: ``rgba`` when final, else
    the frame again through ``render_staged``; an overflowed frame goes
    straight to ``widen_or_retune``'s schedule, taught to the memo so the
    next frames dispatch it directly."""
    if fast:
        return rgba
    if st.refine_overflow > 0:
        widened = schedule_lib.widen_or_retune(config, st)
        out = render_staged(params, camera, widened, matcap, frame)
        schedule_lib.memo_teach(params, orig_config, widened)
        return out
    return render_staged(params, camera, config, matcap, frame)


class _HostCopy:
    """A small tensor's copy to the host, started without waiting for it: on
    the card into pinned memory behind an event, so ``result`` waits for
    the work queued before the copy and not for work queued after it."""

    def __init__(self, x: torch.Tensor):
        self.event = None
        if x.device.type != "cuda":
            self.host = x
            return
        self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        self.host.copy_(x, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(x.device))

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class Renderer:
    """Stateful convenience wrapper (config + assets on the model's device)."""

    def __init__(self, params: Optional[MLP], config: RenderConfig,
                 matcap: Optional[np.ndarray] = None, *, device=None):
        config.validate()
        _require_fp32_matmul()
        self.params = params
        self.config = config
        self.device = _device_of(params, device)
        self.matcap = (
            torch.as_tensor(np.asarray(matcap), dtype=torch.float32, device=self.device)
            if matcap is not None else None
        )
        if config.shading == "matcap" and self.matcap is None:
            raise ValueError("matcap shading requires a matcap texture")
        #: per-frame render statistics of the most recent staged ``render``
        #: (of the frame before the latest, after ``render_interactive``).
        self.last_stats: dict = {}
        #: the deferred fast-path check of the last interactive frame:
        #: (its stats on their way to the host, its config).
        self._pending_check = None

    def render(self, camera: Camera, frame: float = 0.0) -> torch.Tensor:
        """Render to [H, W, 4] float rgba (a tensor on the model's device)."""
        if self.config.march_impl == "megakernel":
            return render_image_kernel(
                self.params, camera, self.config, self.matcap, frame)
        if self.config.march_impl == "staged":
            self.last_stats = {}
            return render_staged(
                self.params, camera, self.config, self.matcap, frame,
                stats_out=self.last_stats)
        return render_image(self.params, camera, self.config, self.matcap, frame,
                            device=self.device)

    def render_interactive(self, camera: Camera, frame: float = 0.0) -> torch.Tensor:
        """Optimistic staged frame for live viewing: the fast-path check of
        its stats is deferred to the next call, so a frame costs one host
        sync (its pixels) instead of two, and the check's small fetch
        overlaps the next frame's device work. A rare overflow frame may
        show silhouette gaps for one displayed frame; the check then
        teaches the widened schedule and later frames dispatch it. Saved
        output keeps the synchronous check (``render``). Non-staged configs
        render through ``render``."""
        if self.config.march_impl != "staged":
            return self.render(camera, frame)
        return self._interactive(camera, frame, packed=False)

    def render_interactive_packed(self, camera: Camera, frame: float = 0.0) -> torch.Tensor:
        """``render_interactive`` as the u32-packed [H, W] image, the
        reference's display format (rgbaFloatToInt's PBO layout,
        volumeRender_kernel.cu:266-274), a quarter of the float32 frame's
        bytes to fetch: an int32 tensor holding the u32 words
        (``image_io.packed_u32_to_uint8_image`` unpacks it to the bytes
        ``to_uint8_image`` gives the float frame)."""
        if self.config.march_impl != "staged":
            return _u32_words(shading.pack_rgba_u32(self.render(camera, frame)))
        return self._interactive(camera, frame, packed=True)

    def _interactive(self, camera: Camera, frame: float, packed: bool):
        config = schedule_lib.memo_lookup(self.params, self.config)
        rgba, _, stats = _render_scheduled(self.params, camera, config, self.matcap,
                                           float(frame), packed_out=packed)
        fetch = _HostCopy(stats)
        if self._pending_check is not None:
            prev, prev_cfg = self._pending_check
            st = schedule_lib.decode(prev.result(), prev_cfg)  # this frame keeps running
            fast = schedule_lib.check_fast(st, prev_cfg)
            self.last_stats = st.record(prev_cfg, fast)
            if st.refine_overflow > 0:
                schedule_lib.memo_teach(self.params, self.config, schedule_lib.widen(prev_cfg))
            elif fast:
                schedule_lib.maybe_tune(self.params, self.config, prev_cfg, st)
        self._pending_check = (fetch, config)
        return rgba

    def render_frame(self, camera: Camera, frame: float = 0.0, *,
                     parity_flip: bool = False) -> np.ndarray:
        """Render to a host uint8 [H, W, 4] image (top-down rows)."""
        rgba = self.render(camera, frame)
        return image_io.to_uint8_image(rgba.detach().cpu().numpy(), parity_flip=parity_flip)

    def render_frame_interactive(self, camera: Camera, frame: float = 0.0, *,
                                 parity_flip: bool = False) -> np.ndarray:
        """Host uint8 frame through the optimistic interactive path: the
        u32 frame is fetched and unpacked on the host, the bytes of
        ``render_frame`` at a quarter of the transfer."""
        packed = self.render_interactive_packed(camera, frame)
        return image_io.packed_u32_to_uint8_image(packed.cpu().numpy(), parity_flip=parity_flip)

    def save_frame(self, path: str, camera: Camera, frame: float = 0.0) -> None:
        img = self.render_frame(camera, frame)
        if path.lower().endswith(".ppm"):
            image_io.save_ppm(path, img)
        else:
            image_io.save_png(path, img)
