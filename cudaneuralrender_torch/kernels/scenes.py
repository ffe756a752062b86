"""Scene composition inside the march kernel.

The counterpart of the JAX package's ``pallas/scenes.py``. This package's
march kernel composes the ``neural_raw`` scene only (the distance is the
raw logit, so the compose is the identity); ``neural_tanh`` and the CSG
scenes are ROADMAP queue 1 item 4 (K4 in full) and march through the plain
path.

``compose_fn`` gives the compose for the kernel's plain version, in its
layout: compose(pts [T, 3], d [T], frame) -> [T].
"""
from __future__ import annotations

KERNEL_SCENES = frozenset({"neural_raw"})


def kernel_supported(scene: str) -> bool:
    """Scenes the march kernel can march."""
    return scene in KERNEL_SCENES


def compose_fn(scene: str):
    """Kernel-layout scene composition, or None for unsupported scenes."""
    if scene == "neural_raw":
        return lambda pts, d, frame: d
    return None
