"""Train a neural SDF from scratch and render it.

Fits the shipped architecture (9 dense layers, 3->32x8->1, ReLU hidden) to
an analytic CSG target by SDF distillation (``diff.fit_sdf``), saves the
weights as an .npz checkpoint (the format both packages load) and renders
one frame through the staged renderer.

Usage: python -m cudaneuralrender_torch.examples.train_sdf [--steps 2000]
       [--out DIR/csg_demo] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

import cudaneuralrender_torch as cnr
from cudaneuralrender_torch.diff import train
from cudaneuralrender_torch.ops import sdf
from cudaneuralrender_torch.utils import image_io


def target_sdf(p: torch.Tensor) -> torch.Tensor:
    """Rounded box with a sphere bite: union, subtract and round."""
    body = sdf.box(p, (0.5, 0.3, 0.4), round_radius=0.1)
    bite = sdf.sphere(p, 0.35, center=(0.4, 0.3, 0.3))
    return sdf.subtract(body, bite)


def sample(generator: torch.Generator, n: int):
    pts = torch.rand((n, 3), generator=generator, device=generator.device) * 2.2 - 1.1
    return pts, target_sdf(pts)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "csg_demo"))
    ap.add_argument("--render", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    params = cnr.init_mlp(torch.Generator().manual_seed(0), device=args.device)
    params, hist = train.fit_sdf(params, sample, steps=args.steps, batch=args.batch,
                                 lr=args.lr)
    print(f"trained {args.steps} steps: loss {hist[0]:.4f} -> {hist[-1]:.6f}")
    params.requires_grad_(False)  # rendering differentiates points only

    ckpt = f"{args.out}.npz"
    cnr.save_pytree(ckpt, params)
    print(f"saved checkpoint: {ckpt}")

    cfg = cnr.RenderConfig(width=args.render, height=args.render, scene="neural_raw",
                           max_steps=500)
    with torch.no_grad():
        img = cnr.render_staged(params, cnr.Camera(rotation_y=30.0, rotation_x=-20.0), cfg)
    png = f"{args.out}.png"
    image_io.save_png(png, image_io.to_uint8_image(img.cpu().numpy()))
    print(f"rendered: {png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
