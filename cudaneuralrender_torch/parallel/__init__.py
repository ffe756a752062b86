"""Sharded and multi-process rendering and training, and band retry.

The counterpart of the JAX package's ``parallel/``: device meshes of
logical shards (``mesh``), the dense and staged renders, the staged solve
and the training step with the rays split over a mesh's ``data`` axis
(``sharding``), multi-process worlds over ``torch.distributed`` with
per-host tile I/O (``multihost``), band-retry rendering with fault
injection (``fault``), and a dry run of every parallel path (``dryrun``).
"""

from . import fault, mesh, multihost, sharding
from .fault import FaultInjector, render_tiled
from .mesh import data_sharding, make_mesh, replicated, tp_mlp_shardings
from .multihost import global_mesh, render_global
from .sharding import (
    pixel_train_step_sharded,
    render_image_sharded,
    render_image_sharded_staged,
    shard_load_stats,
    solve_surface_sharded,
)

__all__ = [
    "FaultInjector",
    "data_sharding",
    "fault",
    "global_mesh",
    "make_mesh",
    "mesh",
    "multihost",
    "render_global",
    "render_image_sharded",
    "render_image_sharded_staged",
    "shard_load_stats",
    "render_tiled",
    "replicated",
    "sharding",
    "solve_surface_sharded",
    "tp_mlp_shardings",
]
