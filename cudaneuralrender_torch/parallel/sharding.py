"""Sharded rendering and training: rays split over the ``data`` mesh axis.

The counterpart of the JAX package's ``parallel/sharding.py``. Rays are
independent, so each shard marches its own rays with no communication
until the frame's one small stats reduction; the sequence-parallel analogue
(rays are the sequence, shards the context, no halo exchange).

JAX runs a body on every device of the mesh with ``shard_map``; here a body
is a loop over the shards, each on its mesh device in the default stream
(parallel/mesh.py), and ``psum`` / ``pmax`` / ``all_gather`` become sums,
maxima and concatenations over the shards' tensors. Across processes
(parallel/multihost.py) a process runs the shards it owns, and the stats,
the schedule memo and the gradients cross processes through
``torch.distributed``.

The staged path (``render_image_sharded_staged``, ``solve_surface_sharded``)
runs the whole staged pipeline on every shard (``staged_subset``: the coarse
kernel pass, the refine ladder in the kernel, compacted shading) over
row-interleaved lane subsets with global pixel indices, and reads the host
once a frame. The dense path (``render_image_sharded``) and the training
step (``pixel_train_step_sharded``) split the rays into contiguous chunks,
as JAX's ``P("data")`` splits them.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..diff import train as train_lib
from ..diff.implicit import _solve_t_dense, implicit_surface_t
from ..models.mlp import MLP, DenseParams
from ..ops import camera as camera_lib
from ..ops import compaction, march, sdf, shading
from ..ops.camera import Camera
from ..render import renderer as renderer_lib
from ..render import schedule
from ..render.renderer import scene_fn, shade_fn
from ..utils import memo as memo_store
from ..utils.config import RenderConfig
from . import multihost
from .mesh import Mesh


class GlobalImage(NamedTuple):
    """An image rendered across processes, as this rank holds it: the whole
    image's ``shape`` (H, W, 4) and this rank's rows, ``tiles`` =
    ((row_start, [rows, W, 4] tensor), ...) sorted by row."""

    shape: tuple
    tiles: tuple


def _check_divisible(config: RenderConfig, n_shards: int) -> None:
    if config.num_rays % n_shards:
        raise ValueError(f"rays ({config.num_rays}) not divisible by data axis ({n_shards})")
    if multihost.distributed() and config.height % n_shards:
        raise ValueError(f"height ({config.height}) not divisible by data axis ({n_shards}): "
                         "across processes every shard holds whole rows")


def _shards(mesh: Mesh, data_axis: str):
    """(shard index, device) of every shard along ``data_axis`` this process
    runs."""
    rank = multihost.process_index()
    return [(s, dev) for s, (dev, pid) in enumerate(mesh.axis_entries(data_axis))
            if pid == rank]


def _replica(params: Optional[MLP], dev: torch.device):
    """``params`` on ``dev``: themselves when they are there, else their
    layers moved with ``.to``. Layers that carry a gradient stay
    ``DenseParams``, which autograd follows back to ``params`` (an ``MLP``
    would make them new leaves) and the plain chain takes; others form an
    ``MLP``, whose packed stack the kernels read."""
    if params is None or params.device == dev:
        return params
    layers = [DenseParams(l.w.to(dev), l.b.to(dev)) for l in params]
    return tuple(layers) if layers[0].w.requires_grad else MLP(layers)


def _merge_rows(pieces) -> tuple:
    """(row_start, [rows, W, ...]) pieces sorted, each run of contiguous
    ones joined into one tile."""
    runs = []  # [start, stop, bands]
    for start, band in sorted(pieces, key=lambda p: p[0]):
        if runs and runs[-1][1] == start:
            runs[-1][1] += band.shape[0]
            runs[-1][2].append(band)
        else:
            runs.append([start, start + band.shape[0], [band]])
    return tuple((start, torch.cat([b.to(bands[0].device) for b in bands]))
                 for start, _, bands in runs)


def _reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every rank, on ``x``'s device."""
    y = x.to(multihost.comm_device())
    dist.all_reduce(y)
    return y.to(x.device)


# ---------------------------------------------------------------------------
# The dense march, sharded
# ---------------------------------------------------------------------------

def _chunk_rays(cam_to_world, config: RenderConfig, s: int, n_local: int):
    """Origin and directions of shard ``s``'s contiguous chunk of rays."""
    idx = torch.arange(s * n_local, (s + 1) * n_local, dtype=torch.int32,
                       device=cam_to_world.device)
    return cam_to_world[:, 3].contiguous(), camera_lib.ray_dirs_from_index(
        cam_to_world, idx, config.height, config.width, config.focal)


def render_image_sharded(
    params: Optional[MLP],
    camera: Camera,
    config: RenderConfig,
    mesh: Mesh,
    matcap: Optional[torch.Tensor] = None,
    frame=0.0,
    data_axis: str = "data",
):
    """The dense render (``renderer.render_image``) with the rays split into
    contiguous chunks over ``mesh``'s data axis. Requires
    ``config.num_rays`` divisible by the axis's size. Returns the [H, W, 4]
    image, or across processes this rank's rows (``GlobalImage``)."""
    renderer_lib._require_fp32_matmul()
    n_shards = mesh.shape[data_axis]
    _check_divisible(config, n_shards)
    n_local = config.num_rays // n_shards
    pieces = []
    for s, dev in _shards(mesh, data_axis):
        p = _replica(params, dev)
        cam_to_world, world_to_cam = camera_lib.view_matrices(camera, dev)
        origin, dirs = _chunk_rays(cam_to_world, config, s, n_local)
        result = march.sphere_trace(
            scene_fn(p, config, frame), origin, dirs, max_steps=config.max_steps,
            march_eps=config.march_eps, bound_center=config.bound_center,
            bound_radius=config.bound_radius)
        points = origin + dirs * result.t[:, None]
        colors = shading.shade(
            shade_fn(p, config, frame), points, dirs, mode=config.shading,
            normal_mode=config.normal_mode, normal_eps=config.normal_eps,
            world_to_cam=world_to_cam, matcap=None if matcap is None else matcap.to(dev))
        pieces.append((s, torch.where(result.hit[:, None], colors, 0.0)))
    return _chunks_image(pieces, config, n_shards)


def _chunks_image(pieces, config: RenderConfig, n_shards: int):
    """Shards' contiguous chunks [n_local, 4] as the image: [H, W, 4] on the
    first shard's device, or this rank's rows across processes."""
    h, w = config.height, config.width
    if multihost.distributed():
        rows = h // n_shards
        return GlobalImage((h, w, 4), _merge_rows(
            (s * rows, x.reshape(rows, w, 4)) for s, x in pieces))
    dev0 = pieces[0][1].device
    return torch.cat([x.to(dev0) for _, x in pieces]).reshape(h, w, 4)


def _whole_solve(pieces, n_shards: int):
    """Shards' (t [n_local], hit [n_local]) as (t [N], hit [N]) in shard
    order, on the first shard's device. Across processes every rank gets
    the whole: zeros but its own shards', summed over the ranks."""
    dev0 = pieces[0][1][0].device
    if not multihost.distributed():
        return (torch.cat([t.to(dev0) for _, (t, _) in pieces]),
                torch.cat([hit.to(dev0) for _, (_, hit) in pieces]))
    n_local = pieces[0][1][0].shape[0]
    t = torch.zeros((n_shards, n_local), dtype=torch.float32, device=dev0)
    hit = torch.zeros((n_shards, n_local), dtype=torch.int32, device=dev0)
    for s, (ts, hs) in pieces:
        t[s], hit[s] = ts.to(dev0), hs.to(dev0, torch.int32)
    return _reduce_sum(t).reshape(-1), _reduce_sum(hit).reshape(-1).bool()


def _map_image(img, fn):
    """``fn`` applied to a whole image or to each tile of a ``GlobalImage``."""
    if isinstance(img, GlobalImage):
        return img._replace(tiles=tuple((start, fn(x)) for start, x in img.tiles))
    return fn(img)


def _u32_round_trip(rgba: torch.Tensor) -> torch.Tensor:
    return shading.unpack_rgba_u32(shading.pack_rgba_u32(rgba))


# ---------------------------------------------------------------------------
# The sharded training step
# ---------------------------------------------------------------------------

def pixel_train_step_sharded(
    state,
    camera: Camera,
    target,
    config: RenderConfig,
    mesh: Mesh,
    lr: float = 1e-3,
    data_axis: str = "data",
    t_star: Optional[torch.Tensor] = None,
    hit: Optional[torch.Tensor] = None,
):
    """One inverse-rendering step with the rays split over the data axis.

    Each shard solves its chunk's surface (the dense march, gradient
    severed), reattaches gradients through the implicit surface
    (diff/implicit.py), shades differentiably and sums its squared pixel
    error. In one process the shards' sums are added and differentiated
    once; across processes each rank differentiates its own shards' share
    of the loss and the gradients are summed over the ranks
    (``all_reduce``) before the Adam update, so every rank takes the same
    step. The loss is the mean over the whole image, as
    ``diff.pixel_train_step``'s.

    ``t_star`` / ``hit`` (both or neither, [H*W] in image order): a
    precomputed severed solve (``solve_surface_sharded`` or
    ``diff.solve_surface``); the march then leaves the step.

    Returns (new TrainState, loss).
    """
    if (t_star is None) != (hit is None):
        raise ValueError("pass both t_star and hit, or neither")
    renderer_lib._require_fp32_matmul()
    n_shards = mesh.shape[data_axis]
    _check_divisible(config, n_shards)
    n_local = config.num_rays // n_shards
    params = state.params
    tgt = torch.as_tensor(target, dtype=torch.float32, device=params.device).reshape(-1, 4)
    frame = 0.0
    sse = []
    for s, dev in _shards(mesh, data_axis):
        lanes = slice(s * n_local, (s + 1) * n_local)
        p = _replica(params, dev)
        cam_to_world, world_to_cam = camera_lib.view_matrices(camera, dev)
        origin, dirs = _chunk_rays(cam_to_world, config, s, n_local)
        if t_star is None:
            with torch.no_grad():  # an MLP replica: the solve may read the kernels
                t0, hit0 = _solve_t_dense(_replica(params, dev), config, frame, origin, dirs)
        else:
            t0, hit0 = t_star[lanes].to(dev), hit[lanes].to(dev)
        # f is evaluated only at the surface (the implicit step, the normals),
        # so the surface-local composes apply.
        f = scene_fn(p, config, frame, for_grad=True, surface_local=True)
        t = implicit_surface_t(f, origin, dirs, t0)
        colors = shading.shade(
            f, origin + dirs * t[:, None], dirs, mode=config.shading,
            normal_mode=config.normal_mode, normal_eps=config.normal_eps,
            world_to_cam=world_to_cam, differentiable=True)
        rgba = torch.where(hit0.detach()[:, None], colors, 0.0)
        sse.append(torch.sum((rgba - tgt[lanes].to(dev)) ** 2).to(params.device))
    loss = torch.stack(sse).sum() / tgt.numel()
    grads = train_lib._grads(loss, params)
    loss = loss.detach()
    if multihost.distributed():
        summed = _reduce_sum(torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)]))
        sizes = [g.numel() for g in grads]
        grads = [x.reshape(g.shape) for x, g in zip(summed[:-1].split(sizes), grads)]
        loss = summed[-1]
    return train_lib._update(state, grads, lr), loss


# ---------------------------------------------------------------------------
# The staged fast path, sharded
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _shard_pos(h: int, w: int, n_shards: int, block) -> np.ndarray:
    """[n_shards, n_local] int32: each shard's global pixel indices.

    Shard s owns image rows s, s+S, s+2S, ... (row-interleaved, S =
    n_shards): contiguous bands would put the object into one or two
    shards, whose near-surface sets outgrow their refine buckets while the
    others idle; interleaved rows give every shard a like slice of the
    scene, so its buckets fit when the whole frame's do, and the work is
    balanced (a sharded frame ends with its slowest shard). Reassembly is a
    regular transpose (``_assemble``).

    Within a shard the indices run block-major (``block`` =
    config.coarse_block, keyed on global image coordinates), so the coarse
    kernel pass's warps cover compact image regions: the single-device
    block order (renderer ``_block_order``) on the shard's rows.

    Contiguous flat-index bands when h % n_shards != 0.
    """
    n = h * w
    if n % n_shards:
        raise ValueError(f"rays ({n}) not divisible by {n_shards} shards")
    n_local = n // n_shards
    if h % n_shards == 0:
        rows = np.arange(h, dtype=np.int32).reshape(-1, n_shards).T  # [S, h/S]
        pos = (rows[:, :, None] * w + np.arange(w, dtype=np.int32)).reshape(n_shards, n_local)
    else:
        pos = np.arange(n, dtype=np.int32).reshape(n_shards, n_local)
    if block:
        bh, bw = block
        ys, xs = np.divmod(pos, w)
        key = (ys // bh) * ((w + bw - 1) // bw) + (xs // bw)
        pos = np.take_along_axis(pos, np.argsort(key, axis=1, kind="stable"), axis=1)
    pos.flags.writeable = False
    return pos


@functools.lru_cache(maxsize=16)
def _shard_pos_on(h: int, w: int, n_shards: int, block, device: torch.device) -> torch.Tensor:
    """``_shard_pos`` on ``device``, made once: a frame copies nothing from
    the host."""
    return torch.as_tensor(np.array(_shard_pos(h, w, n_shards, block)), device=device)


def _assemble(flat: torch.Tensor, h: int, w: int, n_shards: int) -> torch.Tensor:
    """Undo ``_shard_pos``'s layout: [N, ...] as the concatenation of the
    shards' pos-ascending outputs -> [N, ...] in image (raster) order. Shard
    s's local row j is image row j*S + s, so [S, h/S, w] transposed to
    [h/S, S, w] is raster order; contiguous bands already are."""
    if h % n_shards:
        return flat
    tail = tuple(flat.shape[1:])
    x = flat.reshape((n_shards, h // n_shards, w) + tail)
    return x.transpose(0, 1).reshape((h * w,) + tail)


def staged_subset(params, pos, cam_to_world, world_to_cam, config: RenderConfig,
                  matcap, frame, solve_only: bool = False):
    """The whole staged pipeline on a subset of the image's pixels: the one
    body of the sharded program (``_staged_sharded_program``) and of the
    per-band path (``fault._render_band_staged``).

    ``pos`` [n_local] int32: each lane's global pixel index, in the
    caller's lane order (block-major, for the coarse pass's locality); every
    stage rebuilds directions and budgets from it. Returns (out, stats5,
    rung_actives): ``out`` the rgba [n_local, 4] in pos-ascending order (or
    (t, hit) with ``solve_only``); ``stats5`` = (active, steps, hits,
    refine_overflow, shade_excess) int32 scalars of this subset; and
    ``rung_actives`` the HIGHEST ladder's per-rung entry-active counts
    [len(refine_schedule)]: this subset's share of the near-set work, the
    per-shard load observable.
    """
    n_local = pos.shape[0]
    origin = cam_to_world[:, 3].contiguous()
    dirs = camera_lib.ray_dirs_from_index(
        cam_to_world, pos, config.height, config.width, config.focal)
    pr, steps, ovf, rungs = renderer_lib._scheduled_march(
        params, cam_to_world, origin, dirs, config, frame, pos=pos)
    conv_within = schedule.conv_within(config, n_local)
    zero = torch.zeros((), dtype=torch.int32, device=pos.device)
    if solve_only:
        out = tuple(compaction.sort_restore_leaves(pr.pos, (pr.t, pr.converged)))
        hit_count = pr.converged.sum(dtype=torch.int32)
        shade_excess = zero
    else:
        out, pr, hit_count = renderer_lib._shade_packed(
            params, origin, cam_to_world, pr, world_to_cam, config, matcap, frame,
            within=conv_within, flat=True)
        shade_cap = schedule.shade_capacity(config, n_local, conv_within)
        shade_excess = zero if shade_cap >= n_local else torch.clamp(
            hit_count - shade_cap, min=0)
    stats5 = (pr.active.sum(dtype=torch.int32), steps.to(torch.int32),
              hit_count.to(torch.int32), ovf.to(torch.int32), shade_excess.to(torch.int32))
    return out, stats5, rungs


def _staged_sharded_program(
    params,
    camera: Camera,
    config: RenderConfig,
    mesh: Mesh,
    matcap,
    frame,
    data_axis: str = "data",
    solve_only: bool = False,
):
    """The whole staged render (or t* solve) over the shards of ``mesh``'s
    data axis, with no host read.

    Each shard runs the complete fast path (``staged_subset``) on its
    n/S lanes with its own static buckets. Returns (out, stats):

    * ``out``: the rgba [H, W, 4] on the first shard's device, or across
      processes this rank's rows (``GlobalImage``); with ``solve_only``,
      (t [N], hit [N]) in image order, on every rank.
    * ``stats``: ONE int64 vector for one host fetch, of the shard layout
      (``schedule.encode``): the health counts (active and hits summed over
      the shards; steps, overflow and shade excess their maxima), then the
      per-shard matrix [n_shards, 4 + n_rungs] flattened: each shard's
      (active, hits, shade_excess, steps, rung_entry_actives...), the load
      picture the sums hide (``shard_load_stats``).
    """
    n_shards = mesh.shape[data_axis]
    _check_divisible(config, n_shards)
    h, w = config.height, config.width
    block = tuple(config.coarse_block) if config.coarse_block else None
    outs, rows = [], []
    for s, dev in _shards(mesh, data_axis):
        cam_to_world, world_to_cam = camera_lib.view_matrices(camera, dev)
        pos = _shard_pos_on(h, w, n_shards, block, dev)[s]
        out, stats5, rungs = staged_subset(
            _replica(params, dev), pos, cam_to_world, world_to_cam, config,
            None if matcap is None else matcap.to(dev), sdf.frame_tensor(frame, dev),
            solve_only=solve_only)
        active, steps, hits, ovf, shade_excess = stats5
        outs.append((s, out))
        rows.append(torch.cat([torch.stack([active, hits, shade_excess, steps, ovf]),
                               rungs.to(torch.int32)]).to(torch.int64))
    dev0 = rows[0].device
    local = torch.stack([r.to(dev0) for r in rows])
    if multihost.distributed():
        mat = torch.zeros((n_shards, local.shape[1]), dtype=torch.int64,
                          device=multihost.comm_device())
        mat[[s for s, _ in outs]] = local.to(mat.device)
        dist.all_reduce(mat)
    else:
        mat = local
    stats = schedule.encode(mat[:, 0].sum(), mat[:, 3].max(), mat[:, 1].sum(), mat[:, 4].max(),
                            torch.cat([mat[:, :4], mat[:, 5:]], dim=1).reshape(-1),
                            shade_excess=mat[:, 2].max())

    if solve_only:
        t, hit = _whole_solve(outs, n_shards)
        return (_assemble(t, h, w, n_shards), _assemble(hit, h, w, n_shards)), stats
    if multihost.distributed():
        # Shard s's local row j is image row j*S + s.
        return GlobalImage((h, w, 4), _merge_rows(
            (j * n_shards + s, x.reshape(h // n_shards, w, 4)[j:j + 1])
            for s, x in outs for j in range(h // n_shards))), stats
    flat = torch.cat([x.to(dev0) for _, x in outs])
    return _assemble(flat, h, w, n_shards).reshape(h, w, 4), stats


_ENC_MAX = 16  # the most rungs a ladder may have for the memo broadcast


def _encode_sched(cfg: RenderConfig) -> np.ndarray:
    """Fixed-size int64 encoding of the memo-learned schedule fields
    (refine_schedule, mid_schedule, refine_caps) for the cross-process
    broadcast. A field longer than ``_ENC_MAX`` raises ValueError: it
    would not fit, and a truncated schedule would be another schedule."""
    r, m, c = cfg.refine_schedule, cfg.mid_schedule, cfg.refine_caps
    if max(len(r), len(m), len(c)) > _ENC_MAX:
        raise ValueError(f"a schedule of more than {_ENC_MAX} rungs cannot be broadcast "
                         f"({len(r)}, {len(m)}, {len(c)})")
    v = np.zeros(3 + _ENC_MAX * 5, np.int64)
    v[0], v[1], v[2] = len(r), len(m), len(c)
    for i, (d, s) in enumerate(r):
        v[3 + 2 * i], v[4 + 2 * i] = d, s
    off = 3 + 2 * _ENC_MAX
    for i, (d, s) in enumerate(m):
        v[off + 2 * i], v[off + 1 + 2 * i] = d, s
    off = 3 + 4 * _ENC_MAX
    for i, cap in enumerate(c):
        v[off + i] = cap
    return v


def _decode_sched(cfg: RenderConfig, v: np.ndarray) -> RenderConfig:
    """``cfg`` with the schedule fields of an ``_encode_sched`` vector;
    raises ValueError for lengths outside [0, _ENC_MAX] (the "no entry"
    vector ``_memo_lookup_synced`` sends for an overlong schedule)."""
    nr, nm, nc = int(v[0]), int(v[1]), int(v[2])
    if not all(0 <= k <= _ENC_MAX for k in (nr, nm, nc)):
        raise ValueError(f"schedule lengths {(nr, nm, nc)} outside [0, {_ENC_MAX}]")
    r = tuple((int(v[3 + 2 * i]), int(v[4 + 2 * i])) for i in range(nr))
    off = 3 + 2 * _ENC_MAX
    m = tuple((int(v[off + 2 * i]), int(v[off + 1 + 2 * i])) for i in range(nm))
    off = 3 + 4 * _ENC_MAX
    c = tuple(int(v[off + i]) for i in range(nc))
    return cfg.replace(refine_schedule=r, mid_schedule=m, refine_caps=c)


def _memo_lookup_synced(params, config: RenderConfig) -> RenderConfig:
    """The schedule memo's lookup, the same on every rank.

    One process: ``schedule.memo_lookup``. Across processes, rank 0's entry
    (its persistent store included) is broadcast, so every rank dispatches
    the same schedule; the result goes into each rank's in-process memo,
    and the broadcast runs once per (geometry, config) per process. Later
    teaching stays in step, because every rank reads the same reduced stats.
    """
    if not multihost.distributed():
        return schedule.memo_lookup(params, config)
    key = (memo_store.geom_tag(params), config)
    if key in memo_store.BROADCAST_DONE:
        # Keyed on the broadcast marker, never on a memo hit: an entry only
        # rank 0 holds (its store, an earlier run) would return early on
        # rank 0 alone and leave the others waiting in the collective.
        return schedule._SCHEDULE_MEMO.get(key, config)
    vec = np.zeros(3 + _ENC_MAX * 5, np.int64)
    if multihost.process_index() == 0:
        try:
            vec = _encode_sched(schedule.memo_lookup(params, config))
        except ValueError:
            vec[0] = -1  # no entry the others can decode: all keep the config
    t = torch.as_tensor(vec, device=multihost.comm_device())
    dist.broadcast(t, src=0)
    try:
        looked = _decode_sched(config, t.cpu().numpy())
        looked.validate()
    except ValueError:
        looked = config  # every rank decoded the same vector: all fall back
    if looked != config:
        schedule._SCHEDULE_MEMO[key] = looked
    memo_store.BROADCAST_DONE.add(key)
    return looked


def shard_load_stats(stats, config: RenderConfig) -> dict:
    """Load-balance metrics from the per-shard block of
    ``_staged_sharded_program``'s stats.

    A sharded frame ends when its slowest shard does, so its scaling
    efficiency is bounded by mean/max of the shards' work. The work proxy
    is scheduled refine lane-steps: each shard's HIGHEST-ladder rung
    occupancy times the rung's step bound, and its terminal-rung entries
    times its residual step count. Returns ``shard_active``, ``shard_hits``,
    ``shard_steps``, ``shard_near`` (per shard), ``shard_work``,
    ``shard_imbalance`` (max/mean - 1 of the work) and
    ``predicted_scaling_efficiency`` (mean/max of the work).
    """
    st = np.asarray(stats)
    k = len(config.refine_schedule)
    per = st[schedule.SHARD_HEAD:].reshape(-1, 4 + k).astype(np.float64)
    n_shards = per.shape[0]
    n_local = config.num_rays // n_shards
    active, hits, steps_done = per[:, 0], per[:, 1], per[:, 3]
    rungs = per[:, 4:]
    bounded_total = 0
    work = np.zeros(n_shards)
    for i, (div, steps_i) in enumerate(config.refine_schedule):
        cap = schedule.cap_for(
            n_local, div, config.refine_caps[i] if config.refine_caps else 0, config)
        occ = np.minimum(rungs[:, i], cap)
        if steps_i:
            work += occ * steps_i
            bounded_total += steps_i
        else:
            work += occ * np.maximum(steps_done - bounded_total, 0.0)
    mx, mean = float(work.max()), float(work.mean())
    return dict(
        shard_active=active.astype(int).tolist(),
        shard_hits=hits.astype(int).tolist(),
        shard_steps=steps_done.astype(int).tolist(),
        shard_near=rungs[:, 0].astype(int).tolist(),
        shard_work=work.tolist(),
        shard_imbalance=(mx / mean - 1.0) if mean else 0.0,
        predicted_scaling_efficiency=(mean / mx) if mx else 1.0,
    )


def render_image_sharded_staged(
    params: Optional[MLP],
    camera: Camera,
    config: RenderConfig,
    mesh: Mesh,
    matcap: Optional[torch.Tensor] = None,
    frame=0.0,
    data_axis: str = "data",
    *,
    stats_out: Optional[dict] = None,
):
    """A render through the staged fast path with the rays split over the
    data axis.

    Like ``render_staged``: one stats fetch a frame; a refine-bucket
    overflow on any shard renders the frame again with the widened
    schedule (and teaches the schedule memo); the remaining slow corners
    (step starvation, a shade bucket outgrown) fall back to the exact
    dense sharded march, with the staged path's u32 quantization.

    Returns the [H, W, 4] image, or across processes this rank's rows
    (``GlobalImage``).
    """
    renderer_lib._require_fp32_matmul()
    orig_config = config
    config = _memo_lookup_synced(params, config)
    rgba, stats = _staged_sharded_program(params, camera, config, mesh, matcap, frame,
                                          data_axis)
    vec = stats.cpu().numpy()  # the one host fetch
    st = schedule.decode(vec, config, shard=True)
    fast = schedule.check_fast(st, config)
    if stats_out is not None:
        stats_out.update(st.record(config, fast), shade_excess=st.shade_excess,
                         **shard_load_stats(vec, config))
    if fast:
        return rgba

    if st.refine_overflow > 0:
        widened = schedule.widen(config)
        if widened != config:
            out = render_image_sharded_staged(params, camera, widened, mesh, matcap, frame,
                                              data_axis, stats_out=stats_out)
            schedule.memo_teach(params, orig_config, widened)
            if stats_out is not None:
                stats_out.update(fast_path=False)
            return out

    rgba = render_image_sharded(params, camera, config, mesh, matcap, frame, data_axis)
    if config.rgba_packed:
        rgba = _map_image(rgba, _u32_round_trip)
    if stats_out is not None:
        stats_out.update(fast_path=False, dense_fallback=True)
    return rgba


def solve_surface_sharded(
    params,
    camera: Camera,
    config: RenderConfig,
    mesh: Mesh,
    frame=0.0,
    data_axis: str = "data",
    *,
    stats_out: Optional[dict] = None,
):
    """The staged t* solve over the shards: (t_star [N], hit [N]) in image
    order, whole on every rank, for ``pixel_train_step_sharded(...,
    t_star=t, hit=hit)`` (``diff.solve_surface`` on a mesh). A refine
    overflow widens and retries; other slow corners solve densely."""
    renderer_lib._require_fp32_matmul()
    orig_config = config
    config = _memo_lookup_synced(params, config)
    with torch.no_grad():
        (t, hit), stats = _staged_sharded_program(params, camera, config, mesh, None, frame,
                                                  data_axis, solve_only=True)
    vec = stats.cpu().numpy()  # the one host fetch
    st = schedule.decode(vec, config, shard=True)
    fast = schedule.schedule_ok(st, config)
    if stats_out is not None:
        stats_out.update(st.record(config, fast), **shard_load_stats(vec, config))
    if fast:
        return t, hit

    if st.refine_overflow > 0:
        widened = schedule.widen(config)
        if widened != config:
            out = solve_surface_sharded(params, camera, widened, mesh, frame, data_axis,
                                        stats_out=stats_out)
            schedule.memo_teach(params, orig_config, widened)
            if stats_out is not None:
                stats_out.update(fast_path=False)
            return out

    # The dense exact solve on every shard's contiguous chunk (rare).
    n_shards = mesh.shape[data_axis]
    n_local = config.num_rays // n_shards
    pieces = []
    for s, dev in _shards(mesh, data_axis):
        cam_to_world, _ = camera_lib.view_matrices(camera, dev)
        origin, dirs = _chunk_rays(cam_to_world, config, s, n_local)
        pieces.append((s, _solve_t_dense(_replica(params, dev), config, frame, origin, dirs)))
    t, hit = _whole_solve(pieces, n_shards)
    if stats_out is not None:
        stats_out.update(fast_path=False, dense_fallback=True)
    return t, hit
