"""Batched multi-geometry rendering.

The PyTorch counterpart of the JAX package's ``render/multigeom.py``. The
reference renders one geometry per process; here same-architecture SDF
networks stack along a leading geometry axis (``stack_params``), the dense
renders run over that axis (``render_batch``, ``render_batch_cameras``: a
loop of ``render_image``, where the JAX package vmaps it), and
``render_batch_staged`` dispatches one staged frame per geometry back to
back and drains every stats vector in one fetch. Each geometry's staged
frame launches the march kernel as any frame does: the kernel has no
geometry axis.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models import mlp
from ..models.mlp import MLP
from ..ops.camera import Camera
from ..utils import memo as _memo_store
from ..utils.config import RenderConfig
from .renderer import render_image


def stack_params(params_list: Sequence[MLP]) -> MLP:
    """Stack same-architecture MLPs along a new leading axis: layer i's
    ``w`` [G, in, out] and ``b`` [G, out]."""
    sizes = {mlp.layer_sizes(p) for p in params_list}
    if len(sizes) != 1:
        raise ValueError(f"geometries have mismatched architectures: {sizes}")
    stacked = [(torch.stack([p[i].w.detach() for p in params_list]),
                torch.stack([p[i].b.detach() for p in params_list]))
               for i in range(len(params_list[0]))]
    return _StackedMLP(stacked)


class _StackedMLP(MLP):
    """An MLP whose layers carry a leading geometry axis (``stack_params``):
    a container for ``unstack_params`` and the batch renders, not a network
    to evaluate."""

    def __init__(self, layers):
        torch.nn.Module.__init__(self)  # MLP's chain check reads unstacked shapes
        self.weights = torch.nn.ParameterList(
            [torch.nn.Parameter(w, requires_grad=False) for w, _ in layers])
        self.biases = torch.nn.ParameterList(
            [torch.nn.Parameter(b, requires_grad=False) for _, b in layers])


def _count(stacked: MLP) -> int:
    """The geometries of a ``stack_params`` result."""
    return int(stacked[0].w.shape[0])


def unstack_params(stacked: MLP, index: int) -> MLP:
    """Geometry ``index`` of a ``stack_params`` result, as an MLP."""
    return MLP([(layer.w[index], layer.b[index]) for layer in stacked])


def render_batch(
    stacked_params: MLP, camera: Camera, config: RenderConfig,
    matcap: Optional[torch.Tensor] = None, frame: float = 0.0,
) -> torch.Tensor:
    """Render every stacked geometry from one camera: [G, H, W, 4]."""
    return torch.stack([
        render_image(unstack_params(stacked_params, g), camera, config, matcap, frame)
        for g in range(_count(stacked_params))])


def _unstack_cameras(cameras, count: int) -> List[Camera]:
    """Cameras as a list: a sequence of Camera, or one Camera whose fields
    carry a leading geometry axis (the JAX package's stacked pytree)."""
    if isinstance(cameras, Camera):
        rx = np.broadcast_to(np.asarray(cameras.rotation_x, np.float64), (count,))
        ry = np.broadcast_to(np.asarray(cameras.rotation_y, np.float64), (count,))
        tr = np.broadcast_to(np.asarray(cameras.translation, np.float64), (count, 3))
        return [Camera(rotation_x=float(rx[g]), rotation_y=float(ry[g]),
                       translation=tuple(float(v) for v in tr[g])) for g in range(count)]
    cameras = list(cameras)
    if len(cameras) != count:
        raise ValueError(f"{len(cameras)} cameras for {count} geometries")
    return cameras


def render_batch_cameras(
    stacked_params: MLP, cameras, config: RenderConfig,
    matcap: Optional[torch.Tensor] = None, frame: float = 0.0,
) -> torch.Tensor:
    """Render geometry i from camera i: [G, H, W, 4]. ``cameras`` is a
    sequence of Camera, or a Camera whose fields have a leading geometry
    axis."""
    count = _count(stacked_params)
    return torch.stack([
        render_image(unstack_params(stacked_params, g), cam, config, matcap, frame)
        for g, cam in enumerate(_unstack_cameras(cameras, count))])


def _place(params: MLP, device) -> MLP:
    """``params`` on ``device``, carrying its geometry tag (the schedule memo
    is keyed on it)."""
    device = torch.device(device)
    if params.device == device:
        return params
    placed = MLP([(layer.w.detach().to(device), layer.b.detach().to(device))
                  for layer in params])
    tag = _memo_store.geom_tag(params)
    if tag is not None:
        _memo_store.tag_geometry(placed, tag)
    return placed


def render_batch_staged(
    params_list: Sequence[MLP], camera: Camera, config: RenderConfig,
    matcap: Optional[torch.Tensor] = None, frame: float = 0.0,
    devices: Optional[Sequence] = None, *, stats_out: Optional[list] = None,
) -> List[torch.Tensor]:
    """Render every geometry through the staged path, pipelined: one staged
    frame per geometry dispatched back to back (each launches the march
    kernel as a single frame does), then one fetch of every stats vector,
    the same discipline as ``render_sequence``. Each geometry keeps its own
    schedule memo entry and tuning (the memo is keyed on geometry identity).

    ``devices``: geometry i renders on ``devices[i % len(devices)]`` (its
    parameters and the matcap copied there), so geometries on different
    cards run concurrently; omit it to render on the parameters' devices.
    ``stats_out`` receives one dict per geometry.

    Returns a list of [H, W, 4] rgba tensors, each on its geometry's device.
    """
    from .renderer import (
        _maybe_tune, _render_scheduled, _widen_or_retune, check_fast,
        memo_lookup, memo_teach, render_staged,
    )

    params_list = list(params_list)
    matcaps = [matcap] * len(params_list)
    if devices:
        params_list = [_place(p, devices[i % len(devices)]) for i, p in enumerate(params_list)]
        if matcap is not None:
            matcaps = [matcap.to(p.device) for p in params_list]
    frame = float(frame)
    orig_config = config
    cfgs = [memo_lookup(p, config) for p in params_list]
    queued = [_render_scheduled(p, camera, cfg, mc, frame)
              for p, cfg, mc in zip(params_list, cfgs, matcaps)]
    if not queued:
        return []
    home = queued[0][2].device
    stats = torch.stack([s.to(home) for _, _, s in queued]).cpu().numpy()  # the one sync

    out = []
    for (rgba, _, _), st, p, cfg, mc in zip(queued, stats, params_list, cfgs, matcaps):
        ovf = int(st[3])
        fast = check_fast(st, cfg)
        if stats_out is not None:
            stats_out.append(dict(
                rays=cfg.num_rays, steps=int(st[1]), hits=int(st[2]),
                unresolved=int(st[0]), refine_overflow=ovf, fast_path=fast,
                rung_actives=[int(v) for v in st[4:]],
                refine_caps=list(cfg.refine_caps),
            ))
        if fast:
            out.append(rgba)
            _maybe_tune(p, orig_config, cfg, st[4:], margin=1.35)
        elif ovf > 0:
            # The pipelined attempt already showed this geometry's near set
            # outgrows the first refine bucket: go straight to the widened
            # schedule and teach its memo entry.
            widened = _widen_or_retune(cfg, st)
            out.append(render_staged(p, camera, widened, mc, frame))
            memo_teach(p, orig_config, widened)
        else:
            out.append(render_staged(p, camera, cfg, mc, frame))
    return out


def contact_sheet(images: torch.Tensor, cols: int = 0) -> torch.Tensor:
    """Tile [G, H, W, C] renders into one [rows*H, cols*W, C] image."""
    g, h, w, c = images.shape
    cols = cols or int(math.ceil(math.sqrt(g)))
    rows = -(-g // cols)
    padded = images.new_zeros((rows * cols, h, w, c))
    padded[:g] = images
    return padded.reshape(rows, cols, h, w, c).permute(0, 2, 1, 3, 4).reshape(
        rows * h, cols * w, c)
