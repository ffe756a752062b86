"""Multi-process execution: the process group, the global mesh, per-host
tile I/O.

The counterpart of the JAX package's ``parallel/multihost.py``, with
``torch.distributed`` in place of ``jax.distributed``: gloo on the CPU,
NCCL with one process per card. Two modes, as in JAX:

* **Global** (``render_global``, the sharded train step): one mesh over
  every process's devices (``global_mesh``). Each process runs the shards it
  owns; the frame's stats vector, the schedule memo and the training
  gradients cross processes as small ``all_reduce`` / ``broadcast``
  collectives. A render returns a ``sharding.GlobalImage``: this rank's
  rows and their row offsets. ``write_local_tiles`` writes them with no
  gather; ``gather_image`` gathers the whole image on every rank.

* **Independent bands** (``render_bands``): no communication at all. Each
  host renders the row bands it owns (``band % n_hosts == host``) and writes
  its own tiles. Rays are stateless, so a failed host's bands are adopted by
  the survivors (``failed_hosts``) and rendered again from the same camera:
  parallel/fault.py's design across hosts.

Once a process group exists (``initialize``, or the caller's own
``torch.distributed.init_process_group``), the parallel/ functions take the
collective path, even in a world of one process.
"""
from __future__ import annotations

import glob
import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models import mlp
from ..models.mlp import MLP
from ..ops.camera import Camera
from ..utils.config import RenderConfig
from . import mesh as mesh_lib


def distributed() -> bool:
    """Whether a process group exists (the collective path)."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if distributed() else 1


def comm_device() -> torch.device:
    """Where a collective's tensors live: the card for NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group (idempotent).

    ``coordinator_address`` is ``host:port`` (a TCP rendezvous) or any
    ``init_method`` URL (``file://...``, ``tcp://...``); None reads the
    ``env://`` variables. ``backend`` defaults to NCCL when the process has
    a card, else gloo. A world of one process (``num_processes=1``) skips
    initialization, so single-process paths stay untouched."""
    if distributed() or num_processes == 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)


def global_mesh(axis_names: Sequence[str] = ("data",), devices=None) -> mesh_lib.Mesh:
    """A mesh over every process's devices: each rank's ``devices`` (default
    its current card), ranks in order, so the ``data`` axis is contiguous per
    process. Every rank must pass as many devices."""
    devices = [mlp.resolve_device("cuda")] if devices is None else list(devices)
    world = process_count()
    shape = (world * len(devices),) + (1,) * (len(axis_names) - 1)
    return mesh_lib.make_mesh(shape, axis_names, devices * world,
                              np.repeat(np.arange(world), len(devices)))


def render_global(
    params: Optional[MLP],
    camera: Camera,
    config: RenderConfig,
    mesh: Optional[mesh_lib.Mesh] = None,
    matcap=None,
    frame=0.0,
):
    """One render over the global mesh: the whole image as a tensor in a
    single process, a ``GlobalImage`` of this rank's rows across processes
    (``local_tiles``, ``write_local_tiles``, ``gather_image``). Staged
    configs run the staged path on every shard; every rank reads the same
    reduced stats, so the overflow retries stay in step."""
    from . import sharding

    if mesh is None:
        mesh = global_mesh()
    if config.march_impl == "staged":
        return sharding.render_image_sharded_staged(params, camera, config, mesh, matcap, frame)
    return sharding.render_image_sharded(params, camera, config, mesh, matcap, frame)


def local_tiles(rgba) -> List[Tuple[int, np.ndarray]]:
    """This rank's rows of a rendered image as (row_start, [rows, W, 4] host
    array), sorted: a ``GlobalImage``'s tiles (contiguous rows already
    merged when it was built), or one tile of a whole image (a tensor or
    array)."""
    from .sharding import GlobalImage

    if not isinstance(rgba, GlobalImage):
        return [(0, _host(rgba))]
    return [(start, _host(band)) for start, band in rgba.tiles]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def tile_path(out_dir: str, stem: str, row_start: int, row_stop: int) -> str:
    return os.path.join(out_dir, f"{stem}.rows{row_start:05d}-{row_stop:05d}.npy")


def write_local_tiles(rgba, out_dir: str, stem: str) -> List[str]:
    """Write this rank's rows as .npy tiles (no gather). Returns the paths."""
    return write_band_tiles(local_tiles(rgba), out_dir, stem)


_TILE_RE = re.compile(r"\.rows(\d+)-(\d+)\.npy$")


def assemble_tiles(out_dir: str, stem: str) -> np.ndarray:
    """Assemble every host's tiles of ``stem`` into one [H, W, 4] image.
    Raises if rows are missing or overlap (a host died without recovery)."""
    tiles = []
    for p in sorted(glob.glob(os.path.join(out_dir, f"{stem}.rows*.npy"))):
        m = _TILE_RE.search(p)
        if not m:
            continue
        tiles.append((int(m.group(1)), int(m.group(2)), np.load(p)))
    if not tiles:
        raise FileNotFoundError(f"no tiles for {stem!r} in {out_dir}")
    tiles.sort(key=lambda t: t[:2])
    rows = 0
    for start, stop, _ in tiles:
        if start != rows:
            raise ValueError(f"tile gap/overlap at row {rows}: next tile starts {start}")
        rows = stop
    return np.concatenate([band for _, _, band in tiles], axis=0)


def gather_image(rgba) -> np.ndarray:
    """The whole [H, W, 4] image on every rank (a check or a display; the
    production path writes per-host tiles instead): a ``GlobalImage``'s
    tiles gathered from every rank, or a whole image as it is."""
    from .sharding import GlobalImage

    if not isinstance(rgba, GlobalImage):
        return _host(rgba)
    gathered = [None] * process_count()
    dist.all_gather_object(gathered, local_tiles(rgba))
    out = np.zeros(rgba.shape, np.float32)
    for tiles in gathered:
        for start, band in tiles:
            out[start:start + band.shape[0]] = band
    return out


def band_owners(
    n_bands: int, n_hosts: int, failed_hosts: Sequence[int] = ()
) -> List[int]:
    """Band -> host: round-robin striping, with failed hosts' bands adopted
    round-robin by the survivors (rays are stateless, so recovery is
    recomputation)."""
    failed = set(failed_hosts)
    survivors = [h for h in range(n_hosts) if h not in failed]
    if not survivors:
        raise ValueError("all hosts failed")
    owners = []
    takeover = 0
    for band in range(n_bands):
        h = band % n_hosts
        if h in failed:
            h = survivors[takeover % len(survivors)]
            takeover += 1
        owners.append(h)
    return owners


def render_bands(
    params: Optional[MLP],
    camera: Camera,
    config: RenderConfig,
    matcap=None,
    frame=0.0,
    *,
    n_bands: Optional[int] = None,
    failed_hosts: Sequence[int] = (),
    host_id: Optional[int] = None,
    n_hosts: Optional[int] = None,
) -> List[Tuple[int, np.ndarray]]:
    """Render only the row bands this host owns, with no communication
    (each band is a render of a row slice, ``fault.render_band_auto``: the
    staged path with its dense fallback for staged configs). Returns
    [(row_start, [rows, W, 4]), ...] host arrays for ``write_band_tiles``."""
    from .fault import render_band_auto

    if host_id is None:
        host_id = process_index()
    if n_hosts is None:
        n_hosts = process_count()
    if n_bands is None:
        n_bands = n_hosts
    if config.height % n_bands:
        raise ValueError(f"height {config.height} not divisible by {n_bands} bands")
    rows = config.height // n_bands
    out = []
    for band, owner in enumerate(band_owners(n_bands, n_hosts, failed_hosts)):
        if owner == host_id:
            out.append((band * rows, render_band_auto(params, camera, config, matcap, frame,
                                                      band, n_bands)))
    return out


def write_band_tiles(
    bands: List[Tuple[int, np.ndarray]], out_dir: str, stem: str
) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for start, band in bands:
        p = tile_path(out_dir, stem, start, start + band.shape[0])
        np.save(p, band)
        paths.append(p)
    return paths
