"""Failure recovery: band-retry rendering and fault injection.

The counterpart of the JAX package's ``parallel/fault.py``. The reference
has no failure handling (every CUDA error aborts the process); here rays
are stateless, so recovery is recomputation. The image renders in
independent horizontal bands; a band whose execution fails (a lost device,
a transient runtime error, an injected fault) is rendered again, with no
checkpoint and no coordination, and a lost band never touches its
neighbours, because sphere tracing couples no two rays. A retry runs the
same code, the march kernel on the card: nothing swaps in another march.

``FaultInjector`` drives the retry path deterministically in tests and
drills; the CLI's ``--fault-inject N`` plumbs into it. Across hosts,
parallel/multihost.py's ``render_bands`` applies the same design: a failed
host's bands are adopted by the survivors.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..models.mlp import MLP
from ..ops import camera as camera_lib
from ..ops import march, sdf, shading
from ..ops.camera import Camera
from ..render import renderer as renderer_lib
from ..render import schedule
from ..render.renderer import scene_fn, shade_fn
from ..utils.config import RenderConfig

log = logging.getLogger("cudaneuralrender_torch.fault")


class FaultInjector:
    """Fail the first ``fail_times`` band executions, deterministically.

    The fault is raised after the band's device work has run, as a loss in
    the middle of a render would be, so what is exercised is that a retry
    carries no partial state over."""

    def __init__(self, fail_times: int = 0):
        self.fail_times = int(fail_times)
        self.injected = 0

    def maybe_fail(self, band: int) -> None:
        if self.injected < self.fail_times:
            self.injected += 1
            raise RuntimeError(f"injected fault on band {band} (#{self.injected})")


def _band_rows(config: RenderConfig, n_bands: int) -> int:
    if config.height % n_bands:
        raise ValueError(f"height {config.height} not divisible by {n_bands} bands")
    return config.height // n_bands


def _render_band(params, camera: Camera, config: RenderConfig, matcap, frame, band: int,
                 n_bands: int, device=None) -> torch.Tensor:
    """One horizontal band of rows through the dense march: [H/n_bands, W, 4]."""
    rows = _band_rows(config, n_bands)
    dev = renderer_lib._device_of(params, device)
    cam_to_world, world_to_cam = camera_lib.view_matrices(camera, dev)
    n_local = rows * config.width
    idx = torch.arange(band * n_local, (band + 1) * n_local, dtype=torch.int32, device=dev)
    origin = cam_to_world[:, 3].contiguous()
    dirs = camera_lib.ray_dirs_from_index(cam_to_world, idx, config.height, config.width,
                                          config.focal)
    result = march.sphere_trace(
        scene_fn(params, config, frame), origin, dirs, max_steps=config.max_steps,
        march_eps=config.march_eps, bound_center=config.bound_center,
        bound_radius=config.bound_radius)
    colors = shading.shade(
        shade_fn(params, config, frame), origin + dirs * result.t[:, None], dirs,
        mode=config.shading, normal_mode=config.normal_mode, normal_eps=config.normal_eps,
        world_to_cam=world_to_cam, matcap=matcap)
    return torch.where(result.hit[:, None], colors, 0.0).reshape(rows, config.width, 4)


def _render_band_staged(params, camera: Camera, config: RenderConfig, matcap, frame,
                        band: int, n_bands: int, device=None):
    """One band through the staged fast path: the shared subset body
    (``sharding.staged_subset``) on the band's global pixel indices in
    band-local block-major order. Returns ([rows, W, 4], stats): stats of
    the shard layout (``schedule.encode``), ``staged_subset``'s counts then
    the refine rungs' entry-active counts."""
    from .sharding import staged_subset

    rows = _band_rows(config, n_bands)
    dev = renderer_lib._device_of(params, device)
    cam_to_world, world_to_cam = camera_lib.view_matrices(camera, dev)
    bh, bw = config.coarse_block or (rows, config.width)
    perm = renderer_lib._block_order(rows, config.width, bh, bw, dev)
    pos = band * rows * config.width + perm
    rgba, (active, steps, hits, ovf, excess), rungs = staged_subset(
        params, pos, cam_to_world, world_to_cam, config, matcap, sdf.frame_tensor(frame, dev))
    return rgba.reshape(rows, config.width, 4), schedule.encode(
        active, steps, hits, ovf, rungs, shade_excess=excess)


def render_band_auto(params, camera: Camera, config: RenderConfig, matcap, frame,
                     band: int, n_bands: int, device=None) -> np.ndarray:
    """One band as a host array: the staged fast path when the config asks
    for it, its stats read once a pass; the dense march otherwise.

    A staged band whose refine bucket overflows is rendered again with its
    buckets resized from its own rung counts, or doubled
    (``schedule.widen_or_retune``, as ``render_staged`` retries a frame).
    Contiguous bands hold uneven shares of the object: at 1080p with the
    default schedule the middle bands' near-surface sets outgrow their
    buckets (70% of a band against 41% of the frame), and finishing each
    such band densely (the JAX package's band path) took over a second a
    band on an H100 (PERF.md, §6). The remaining slow corners, and a
    retry that no longer changes the buckets, finish the band exactly,
    densely (with the staged path's u32 quantization). ``device`` is
    ``renderer.render_image``'s: where a render without a model runs."""
    renderer_lib._require_fp32_matmul()
    staged = config.march_impl == "staged"
    band_config = config
    # Rung counts in the frame's lanes, the unit of refine_caps.
    scale = config.num_rays / (_band_rows(config, n_bands) * config.width)
    while staged:
        rgba, stats = _render_band_staged(params, camera, band_config, matcap, frame, band,
                                          n_bands, device)
        st = schedule.decode(stats.cpu().numpy(), band_config, shard=True)
        if schedule.check_fast(st, band_config):
            return rgba.cpu().numpy()
        if st.refine_overflow == 0:
            break
        retry = schedule.widen_or_retune(
            band_config, st._replace(rung_actives=tuple(a * scale for a in st.rung_actives)))
        if retry == band_config:
            break
        band_config = retry
    rgba = _render_band(params, camera, config, matcap, frame, band, n_bands, device)
    if staged and config.rgba_packed:
        rgba = shading.unpack_rgba_u32(shading.pack_rgba_u32(rgba))
    return rgba.cpu().numpy()


def render_tiled(
    params: Optional[MLP],
    camera: Camera,
    config: RenderConfig,
    matcap: Optional[torch.Tensor] = None,
    frame=0.0,
    *,
    n_bands: int = 4,
    max_retries: int = 2,
    injector: Optional[FaultInjector] = None,
    device=None,
) -> np.ndarray:
    """A render band by band, each band retried when it fails
    (``render_band_auto``).

    Returns the [H, W, 4] float32 image on the host: a band is fetched when
    it completes, so a failure surfaces at its own band."""
    rows = _band_rows(config, n_bands)
    out = np.zeros((config.height, config.width, 4), np.float32)
    for band in range(n_bands):
        attempt = 0
        while True:
            try:
                band_img = render_band_auto(params, camera, config, matcap, frame, band,
                                            n_bands, device)
                if injector is not None:
                    injector.maybe_fail(band)
                out[band * rows:(band + 1) * rows] = band_img
                break
            except Exception as e:  # noqa: BLE001 -- any band failure is retried
                attempt += 1
                if attempt > max_retries:
                    raise RuntimeError(f"band {band} failed {attempt} times; giving up") from e
                log.warning("band %d failed (%s); retry %d/%d", band, e, attempt, max_retries)
    return out
