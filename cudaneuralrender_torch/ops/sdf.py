"""Scene composition around the neural SDF.

The PyTorch counterpart of the JAX package's ``ops/sdf.py`` registry
(``make_scene``), for the scenes this package has ported: the raw neural
field, its tanh, and the analytic test sphere. An ``SdfFn`` maps points
(..., 3) to distances (...,).

The CSG demo scenes (many_sphere, many_sphere_cut, many_cylinder_cut,
displacement) are ROADMAP queue 1 item 4 and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

# SdfFn: points (..., 3) -> distances (...,)
SdfFn = Callable[[torch.Tensor], torch.Tensor]

CSG_SCENES = frozenset(
    {"many_sphere", "many_sphere_cut", "many_cylinder_cut", "displacement"})


def sphere(p: torch.Tensor, radius: float) -> torch.Tensor:
    """Signed distance to a sphere at the origin (reference :67-71)."""
    return torch.linalg.vector_norm(p, dim=-1) - radius


def make_scene(name: str, neural_fn: Optional[SdfFn] = None) -> SdfFn:
    """Compose a scene SDF from the raw neural field:
      * "neural_raw"  — the raw pre-tanh logit (reference checked-in behaviour)
      * "neural_tanh" — tanh of the logit
      * "sphere"      — analytic sphere of radius 0.9, for tests
    """
    if name in CSG_SCENES:
        raise NotImplementedError(
            f"scene {name!r} is not ported yet (ROADMAP queue 1 item 4: CSG scenes)")
    if name == "sphere":
        return lambda p: sphere(p, 0.9)
    if neural_fn is None:
        raise ValueError(f"scene {name!r} requires a neural SDF function")
    if name == "neural_raw":
        return neural_fn
    if name == "neural_tanh":
        return lambda p: torch.tanh(neural_fn(p))
    raise ValueError(f"unknown scene {name!r}")
