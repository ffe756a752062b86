"""The price of JAX's gradient at ReLU ties, on a frame and a training step.

The JAX package's MLP takes ``jnp.maximum(h, 0.0)``, whose gradient at a
pre-activation of exactly 0 is 1/2; ``torch.relu``'s is 0. The port's
chain takes ``models.mlp.relu_tie`` everywhere it is differentiated under
autograd (``diff/``, and a render's shading normals where the
value-and-gradient kernel does not serve the net), its backward one kernel
on the card (``kernels.elementwise.relu_tie_backward``,
``csrc/elementwise.cu``); the value-and-gradient kernel keeps the same
factor in its masks. This measures it on csg_demo at 1080p in the default
staged config at chip_smoke.py's camera:

  * a frame (``Renderer.render``) with the tree's shading normals (the
    value-and-gradient kernel, ``kernels.fused_mlp.mlp_value_grad``), and
    with the normals on the autograd chain (``on_autograd``) on the tree's
    ``relu_tie``, on ``torch.relu``, and on ``relu_tie`` with the kernel's
    plain version as its backward (``g * torch.heaviside(h, 1/2)``, two
    kernels: the backward before the fused kernel);
  * a training step (``diff.train.pixel_train_step_fast``, the packed fast
    path, from csg_demo with seeded noise toward the frame) on ``relu_tie``
    (the tree) and on ``torch.relu``.

The variants run in the order A, B, C, C, B, A (the step: A, B, B, A), five
synchronised wall-clock runs a turn after a warm-up, and it prints the
medians, the pixels where an image differs from the tree's (a
pre-activation of exactly 0 at a surface point) or the two losses, and the
card's name and power limit. Run on the card from the repository root::

    python -m cudaneuralrender_torch.benchmarks.relu_ties
"""
from __future__ import annotations

import contextlib
import os
import statistics
import time

import torch

from ..kernels import elementwise, fused_mlp
from ..models import mlp
from ..utils.timing import card_line
from . import ASSET, TIMED_RUNS, require_cuda

SIDE = (1920, 1080)
CAMERA = dict(rotation_y=30.0, rotation_x=-20.0)
NOISE, SEED = 0.01, 7


@contextlib.contextmanager
def _patched(module, name, value):
    """``module.name`` set to ``value`` inside the block."""
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


def on_relu():
    """The differentiated chain on ``torch.relu`` inside the block."""
    return _patched(mlp, "relu_tie", torch.relu)


def on_plain_backward():
    """``relu_tie``'s backward on its plain version (two kernels) inside
    the block."""
    return _patched(elementwise, "relu_tie_backward", elementwise.relu_tie_backward_plain)


@contextlib.contextmanager
def on_autograd(inner=contextlib.nullcontext):
    """A render's shading normals on the autograd chain (the
    value-and-gradient kernel serving no width) inside the block, and
    ``inner()`` with it."""
    with _patched(fused_mlp, "VALUE_GRAD_WIDTHS", ()), inner():
        yield


def _wall_ms(run) -> list:
    out = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def compare(variants, run) -> dict:
    """Medians of ``run`` under each (name, context) of ``variants``, in
    the order given and then reversed, with each variant's last output."""
    ms, last = {name: [] for name, _ in variants}, {}
    for name, ctx in list(variants) + list(variants)[::-1]:
        with ctx():
            last[name] = run()
            ms[name] += _wall_ms(run)
    return {name: (statistics.median(v), last[name]) for name, v in ms.items()}


#: The tree's frame variant: the normals on the value-and-gradient kernel.
TREE = "value-and-gradient kernel (tree)"


def frame_variants(renderer, cam) -> dict:
    """The four frame variants: name -> (median ms, image)."""
    return compare(((TREE, contextlib.nullcontext),
                    ("autograd, relu_tie", on_autograd),
                    ("autograd, torch.relu", lambda: on_autograd(on_relu)),
                    ("autograd, relu_tie, plain backward", lambda: on_autograd(on_plain_backward))),
                   lambda: renderer.render(cam))


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
    frames = frame_variants(renderer, cam)
    tree_ms, tree_img = frames[TREE]
    for name, (ms, img) in frames.items():
        print(f"relu_ties frame {SIDE[0]}x{SIDE[1]}, shading normals on {name}: {ms:.3f} ms "
              f"(median of {2 * TIMED_RUNS}, {ms - tree_ms:+.3f} against the tree); differs "
              f"from the tree's image at {int((img != tree_img).any(dim=-1).sum())} pixels "
              f"[{card}]", flush=True)

    target = renderer.render(cnr.Camera(rotation_y=CAMERA["rotation_y"] - 6.0,
                                        rotation_x=CAMERA["rotation_x"]))
    gen = torch.Generator().manual_seed(SEED)
    start = cnr.MLP([(l.w + NOISE * torch.randn(l.w.shape, generator=gen).to(dev),
                      l.b + NOISE * torch.randn(l.b.shape, generator=gen).to(dev))
                     for l in params])
    s0 = train.init_train_state(start)

    def step():
        return train.pixel_train_step_fast(s0, cam, target, cfg)[1]

    steps = compare((("relu_tie (tree)", contextlib.nullcontext), ("torch.relu", on_relu)), step)
    (a_ms, a_loss), (b_ms, b_loss) = steps.values()
    print(f"relu_ties training step {SIDE[0]}x{SIDE[1]} (pixel_train_step_fast): relu_tie (tree) "
          f"{a_ms:.3f} ms, torch.relu {b_ms:.3f} ms (median of {2 * TIMED_RUNS}); losses "
          f"{float(a_loss):.8g} / {float(b_loss):.8g} [{card}]", flush=True)


if __name__ == "__main__":
    main()
