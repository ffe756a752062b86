"""How ``correct`` is decided: the served frames against the plain reference.

The frames a run keeps (a seeded sample of the window's frames and its
deepest one) are rendered again by the plain reference at the same poses,
at the full frame, and compared byte for byte. Each reading is pooled over
the compared frames (their mean):

  * ``fine_mismatch_pct``: pixels whose hit flag differs, or that both
    sides hit and whose colour bytes lie exactly one level apart in the
    worst of r, g, b, as a share of the frame's pixels: the finest
    disagreements, rounding in the surface at the silhouettes and in the
    normals. A control one precision below the configuration's moves a
    share of the shading by one level all over the surface and shifts the
    silhouettes, while the program's own departures from the plain march
    lie in a few pixels;
  * ``shade_gap_pct``: pixels both sides hit whose colour bytes lie two or
    more levels apart, as a share of those pixels: rays that land on another
    facet of the surface, or a normal or a shading that is wrong;
  * ``mask_mismatch_pct``: pixels whose hit flag (alpha) differs, as a
    share of the frame's pixels: the march (rays that hit, rays that miss).

A cell's workload file gives the limit of each number it compares; the
cells compare the first two. ``STAND_INS`` are what ``calibrate`` serves in
the program's place to set those limits: the control and planted faults.
"""
from __future__ import annotations

import torch

from .reference import render as ref

#: The normal fault's push (``reference.render.facing_bytes``): about 3 degrees.
TILT = 0.05


def frame_readings(served: torch.Tensor, grey: torch.Tensor, alpha: torch.Tensor) -> dict:
    """Readings of one frame: served bytes [H, W, 4] (row 0 = bottom)
    against the reference's grey and alpha bytes (flat, same order)."""
    served = served.reshape(-1, 4).to(torch.int16).cpu()
    grey, alpha = grey.to(torch.int16).cpu(), alpha.to(torch.int16).cpu()
    hit_s, hit_r = served[:, 3] > 0, alpha > 0
    both = hit_s & hit_r
    gap = (served[:, :3] - grey[:, None]).abs().amax(dim=1)
    flip = hit_s != hit_r
    n = served.shape[0]
    return dict(
        fine_mismatch_pct=100.0 * float((flip | (both & (gap == 1))).sum()) / n,
        shade_gap_pct=100.0 * float((both & (gap >= 2)).sum()) / max(int(both.sum()), 1),
        mask_mismatch_pct=100.0 * float(flip.sum()) / n,
        hit_pct=100.0 * float(hit_r.sum()) / n,
    )


def render_fields(cfg: dict, tr: dict) -> dict:
    """The configuration's render settings under the traffic's overrides."""
    return {**cfg["render"], **tr.get("render", {})}


def reference_frame(net, pose: dict, cfg: dict, tr: dict, device, precision="float32",
                    tilt: float = 0.0):
    """The plain reference's frame of the model kind's ``reference_net``."""
    r = render_fields(cfg, tr)
    return ref.render(net, pose, scene=tr["scene"], width=int(tr["width"]),
                      height=int(tr["height"]), device=device, max_steps=r["max_steps"],
                      march_eps=r["march_eps"], bound_radius=r["bound_radius"],
                      focal=r["focal"], precision=precision, tilt=tilt)


def as_served(out: dict, levels: int = 0) -> torch.Tensor:
    """A reference frame as served bytes [N, 4], its grey moved by ``levels``."""
    grey = torch.clamp(out["grey"].to(torch.int16) + levels, 0, 255).to(torch.uint8)
    return torch.stack([grey] * 3 + [out["alpha"]], dim=-1)


#: Stand-ins for the program: ``f(net, pose, cfg, tr, device, out)`` gives
#: served bytes, ``net`` being the reference net and ``out`` its own frame.
STAND_INS = {
    # The reference at the precision below the configuration's (TF32 matmuls).
    "control": lambda net, pose, cfg, tr, dev, out: as_served(
        reference_frame(net, pose, cfg, tr, dev, precision="tf32")),
    # Every shade altered where it is produced, by 2 and by 16 levels.
    "plus2": lambda net, pose, cfg, tr, dev, out: as_served(out, 2),
    "plus16": lambda net, pose, cfg, tr, dev, out: as_served(out, 16),
    # Every normal tilted by about 3 degrees.
    "normal_tilt": lambda net, pose, cfg, tr, dev, out: as_served(
        reference_frame(net, pose, cfg, tr, dev, tilt=TILT)),
}


def pooled(per_frame: list, poses: list) -> dict:
    keys = per_frame[0].keys() if per_frame else ()
    out = {k: sum(f[k] for f in per_frame) / len(per_frame) for k in keys}
    out["frames"] = [dict(pose=p, **f) for p, f in zip(poses, per_frame)]
    return out


def compare(net, kept, cfg: dict, tr: dict, device, stand_ins=()) -> dict:
    """The readings pooled over ``kept`` [(index, served bytes, pose)] under
    ``program`` against the frames of the reference net ``net``, and those
    of each named stand-in under its name."""
    got = {k: [] for k in ("program", *stand_ins)}
    for _, served, pose in kept:
        out = reference_frame(net, pose.as_dict(), cfg, tr, device)
        got["program"].append(frame_readings(served, out["grey"], out["alpha"]))
        for name in stand_ins:
            low = STAND_INS[name](net, pose.as_dict(), cfg, tr, device, out)
            got[name].append(frame_readings(low, out["grey"], out["alpha"]))
    poses = [pose.as_dict() for _, _, pose in kept]
    return {k: pooled(v, poses) for k, v in got.items()}
