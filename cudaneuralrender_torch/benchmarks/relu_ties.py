"""The price of JAX's gradient at ReLU ties, on a frame and a training step.

The JAX package's MLP takes ``jnp.maximum(h, 0.0)``, whose gradient at a
pre-activation of exactly 0 is 1/2; ``torch.relu``'s is 0. The port's
differentiated chain takes ``models.mlp.relu_tie`` (JAX's gradient, a
backward of two kernels to relu's one), except a render's shading normals
(``render.renderer.shade_fn``), which keep ``torch.relu``. This measures
both choices where they apply, on csg_demo at 1080p in the default staged
config at chip_smoke.py's camera:

  * a frame (``Renderer.render``) with the shading normals on
    ``torch.relu`` (the tree) and on ``relu_tie``;
  * a training step (``diff.train.pixel_train_step_fast``, the packed fast
    path, from csg_demo with seeded noise toward the frame) on ``relu_tie``
    (the tree) and on ``torch.relu``.

Each pair runs in the order A, B, B, A, five synchronised wall-clock runs a
turn after a warm-up, and prints the medians, the pixels where the two
images differ (a pre-activation of exactly 0 at a surface point) or the two
losses, and the card's name and power limit. Run on the card from the
repository root::

    python -m cudaneuralrender_torch.benchmarks.relu_ties
"""
from __future__ import annotations

import contextlib
import os
import statistics
import time

import torch

from ..models import mlp
from ..render import renderer as renderer_lib
from ..utils.timing import card_line
from . import ASSET, TIMED_RUNS, require_cuda

SIDE = (1920, 1080)
CAMERA = dict(rotation_y=30.0, rotation_x=-20.0)
NOISE, SEED = 0.01, 7


@contextlib.contextmanager
def _render_normals_with_ties():
    """Shading normals on ``relu_tie`` inside the block."""
    real = renderer_lib.shade_fn

    def shade_fn(params, config, frame):
        return renderer_lib.scene_fn(params, config, frame, for_grad=True, surface_local=True)

    renderer_lib.shade_fn = shade_fn
    try:
        yield
    finally:
        renderer_lib.shade_fn = real


@contextlib.contextmanager
def _training_on_relu():
    """The differentiated chain on ``torch.relu`` inside the block."""
    real = mlp.relu_tie
    mlp.relu_tie = torch.relu
    try:
        yield
    finally:
        mlp.relu_tie = real


def _wall_ms(run) -> list:
    out = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _pair(name_a, ctx_a, name_b, ctx_b, run) -> dict:
    """Medians of ``run`` under ``ctx_a`` and ``ctx_b`` (A, B, B, A), with
    each side's last output."""
    ms, last = {name_a: [], name_b: []}, {}
    for name, ctx in ((name_a, ctx_a), (name_b, ctx_b), (name_b, ctx_b), (name_a, ctx_a)):
        with ctx():
            last[name] = run()
            ms[name] += _wall_ms(run)
    return {name: (statistics.median(v), last[name]) for name, v in ms.items()}


def main() -> None:
    dev = require_cuda()
    os.environ.setdefault("CNR_SCHEDULE_MEMO", "")
    import cudaneuralrender_torch as cnr
    from ..diff import train

    card = card_line()
    params = cnr.load(ASSET, device=dev)
    cfg = cnr.RenderConfig(width=SIDE[0], height=SIDE[1], march_impl="staged")
    cam = cnr.Camera(**CAMERA)
    renderer = cnr.Renderer(params, cfg)
    frames = _pair("torch.relu (tree)", contextlib.nullcontext, "relu_tie",
                   _render_normals_with_ties, lambda: renderer.render(cam))
    (a_ms, a_img), (b_ms, b_img) = frames.values()
    print(f"relu_ties frame {SIDE[0]}x{SIDE[1]}, shading normals: torch.relu (tree) "
          f"{a_ms:.3f} ms, relu_tie {b_ms:.3f} ms (median of {2 * TIMED_RUNS}); the images "
          f"differ at {int((a_img != b_img).any(dim=-1).sum())} pixels [{card}]", flush=True)

    target = renderer.render(cnr.Camera(rotation_y=CAMERA["rotation_y"] - 6.0,
                                        rotation_x=CAMERA["rotation_x"]))
    gen = torch.Generator().manual_seed(SEED)
    start = cnr.MLP([(l.w + NOISE * torch.randn(l.w.shape, generator=gen).to(dev),
                      l.b + NOISE * torch.randn(l.b.shape, generator=gen).to(dev))
                     for l in params])
    s0 = train.init_train_state(start)

    def step():
        return train.pixel_train_step_fast(s0, cam, target, cfg)[1]

    steps = _pair("relu_tie (tree)", contextlib.nullcontext, "torch.relu", _training_on_relu,
                  step)
    (a_ms, a_loss), (b_ms, b_loss) = steps.values()
    print(f"relu_ties training step {SIDE[0]}x{SIDE[1]} (pixel_train_step_fast): relu_tie (tree) "
          f"{a_ms:.3f} ms, torch.relu {b_ms:.3f} ms (median of {2 * TIMED_RUNS}); losses "
          f"{float(a_loss):.8g} / {float(b_loss):.8g} [{card}]", flush=True)


if __name__ == "__main__":
    main()
