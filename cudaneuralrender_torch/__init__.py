"""cudaneuralrender_torch — the PyTorch/CUDA port of cudaneuralrender_tpu.

A neural-SDF sphere-trace renderer for NVIDIA Hopper: load Keras-HDF5 SDF
networks (3 or 4 inputs, hidden layers up to 1024 wide) or a multiresolution
hash-grid SDF (``models.hash_grid``, Instant NGP's), march them with a
hand-written CUDA kernel (csrc/march.cuh), and shade with facing-ratio or
matcap. ``diff`` trains the network through the renderer (implicit-surface
pixel gradients, the surface solve on the march kernel, Adam steps);
``render.viewer`` serves interactive frames to a browser and
``render.multigeom`` renders batches of geometries; ``trace`` times the
staged frame's phases and counts its march calls' lanes (off by default).
Models load onto the card unless the CPU is asked for. The JAX package beside it is the
reference this package is tested against; this package never imports JAX.

Quick start::

    import cudaneuralrender_torch as cnr

    params = cnr.load("examples/assets/csg_demo.h5", device="cuda")
    cfg = cnr.RenderConfig(width=512, height=512, march_impl="staged")
    img = cnr.Renderer(params, cfg).render_frame(cnr.Camera.from_cli(ry=45.0))
"""

__version__ = "0.1.0"

from .models import hash_grid, mlp
from .models.checkpoint import load, load_keras_h5, load_pytree, save_pytree
from .models.hash_grid import HashGridSDF, from_numpy_hash_grid
from .models.mlp import MLP, DenseParams, from_numpy_params, init_mlp
from .ops import bounds, camera, compaction, march, sdf, shading
from .ops.bounds import fit_bound_sphere
from .ops.camera import Camera
from .render.renderer import (
    Renderer,
    neural_sdf_fn,
    render_image,
    render_sequence,
    render_staged,
    scene_fn,
)
from .render.schedule import reset_schedule_memo, tune_caps
from .utils import image_io, trace
from .utils.config import RenderConfig
from . import diff

__all__ = [
    "Camera",
    "DenseParams",
    "HashGridSDF",
    "MLP",
    "RenderConfig",
    "Renderer",
    "bounds",
    "camera",
    "compaction",
    "diff",
    "fit_bound_sphere",
    "from_numpy_hash_grid",
    "from_numpy_params",
    "hash_grid",
    "image_io",
    "init_mlp",
    "load",
    "load_keras_h5",
    "load_pytree",
    "march",
    "mlp",
    "neural_sdf_fn",
    "render_image",
    "render_sequence",
    "render_staged",
    "reset_schedule_memo",
    "save_pytree",
    "scene_fn",
    "sdf",
    "shading",
    "trace",
    "tune_caps",
]
