"""Differentiable rendering and training on the card.

The PyTorch counterpart of the JAX package's ``diff/``: implicit-function
pixel gradients (``implicit``), losses (``losses``), the surface solve on
the staged scheduler and the march kernel (``solve``), and the Adam
training steps and loops (``train``).
"""
from .implicit import implicit_surface_t, render_depth_diff, render_image_diff
from .losses import (
    eikonal_loss,
    pixel_loss,
    pixel_loss_packed,
    sdf_distillation_loss,
    silhouette_loss,
)
from .solve import solve_surface, solve_surface_async, solve_surface_packed_async
from .train import (
    TrainState,
    fit_sdf,
    init_train_state,
    load_train_state,
    pixel_train_step,
    pixel_train_step_fast,
    save_train_state,
    sdf_train_step,
    train_loop_fast,
)

__all__ = [
    "TrainState",
    "eikonal_loss",
    "fit_sdf",
    "implicit_surface_t",
    "init_train_state",
    "load_train_state",
    "save_train_state",
    "pixel_loss",
    "pixel_loss_packed",
    "pixel_train_step",
    "pixel_train_step_fast",
    "render_depth_diff",
    "render_image_diff",
    "sdf_distillation_loss",
    "sdf_train_step",
    "silhouette_loss",
    "solve_surface",
    "solve_surface_async",
    "solve_surface_packed_async",
    "train_loop_fast",
]
