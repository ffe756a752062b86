"""Train a 4-input (x, y, z, frame) animated neural SDF: the model family
behind the reference's ``--animation`` mode.

Fits a 4-input MLP to a time-morphing analytic scene (a sphere orbiting a
rounded box, frame in [0, 360) like the turntable counter), saves the
.npz checkpoint and renders a few animation frames with num_inputs=4.

Usage: python -m cudaneuralrender_torch.examples.train_animated
       [--steps 3000] [--out DIR/anim_demo] [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile

import torch

import cudaneuralrender_torch as cnr
from cudaneuralrender_torch.diff import train
from cudaneuralrender_torch.ops import sdf
from cudaneuralrender_torch.utils import image_io


def target_sdf(p: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
    """A small sphere orbits a rounded box, smoothly unioned (frames count
    0..359 like the reference's)."""
    ang = frame * (2.0 * math.pi / 360.0)
    center = 0.6 * torch.stack([torch.cos(ang), torch.zeros_like(ang), torch.sin(ang)], -1)
    body = sdf.box(p, (0.35, 0.25, 0.35), round_radius=0.05)
    orb = sdf.sphere(p - center, 0.18)
    return sdf.smooth_union(body, orb, 0.08)


def sample(generator: torch.Generator, n: int):
    dev = generator.device
    pts = torch.rand((n, 3), generator=generator, device=dev) * 2.2 - 1.1
    frames = torch.rand((n,), generator=generator, device=dev) * 360.0
    x = torch.cat([pts, frames[:, None] / 360.0 * 2.0 - 1.0], dim=-1)
    return x, target_sdf(pts, frames)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "anim_demo"))
    ap.add_argument("--render", type=int, default=192)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    params = cnr.init_mlp(torch.Generator().manual_seed(0),
                          sizes=(4, 32, 32, 32, 32, 32, 32, 32, 32, 1), device=args.device)
    params, hist = train.fit_sdf(params, sample, steps=args.steps, batch=args.batch,
                                 lr=args.lr)
    print(f"trained {args.steps} steps: loss {hist[0]:.4f} -> {hist[-1]:.6f}")
    params.requires_grad_(False)  # rendering differentiates points only
    ckpt = f"{args.out}.npz"
    cnr.save_pytree(ckpt, params)
    print(f"saved checkpoint: {ckpt}")

    # The renderer feeds the raw frame number; this model was trained on
    # frame/180 - 1, so the frames are scaled before rendering.
    cfg = cnr.RenderConfig(width=args.render, height=args.render, scene="neural_raw",
                           num_inputs=4, max_steps=400)
    cam = cnr.Camera(rotation_y=20.0, rotation_x=-25.0)
    for i in range(args.frames):
        frame = i * (360.0 / args.frames)
        with torch.no_grad():
            img = cnr.render_staged(params, cam, cfg, frame=frame / 180.0 - 1.0)
        png = f"{args.out}_{i:03d}.png"
        image_io.save_png(png, image_io.to_uint8_image(img.cpu().numpy()))
        print(f"rendered frame {frame:.0f}: {png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
