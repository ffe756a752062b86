"""A seeded bundle of 128-wide march calls on a 1080p pose, a ray per
thread: the outputs the card's kernels give, kept as a fixture
(``tests/fixtures/w128_bundle.npz``) that ``test_torch_cuda.py`` holds later
kernels to bit for bit.

The net is csg_demo widened to 3 -> 128 x 8 -> 1 (``chip_smoke.wide_params``,
k = 4). The rays: BUNDLE_RAYS pixels of the 1920x1080 frame from
``chip_smoke.CAMERA``, drawn with BUNDLE_SEED; the first half in drawn
order, the second sorted by whether the bounding sphere takes the ray, so
that whole blocks and groups of lanes start inactive beside others that
march; the count is not a multiple of a block. The calls, each a ray per
thread (``_ray_lanes=1``):

  * ``coarse``: the default coarse call (three-pass chain at the config's
    coarse_eps, over-relaxed, run to dry) from the bounding-sphere init;
  * ``coarse_fp32``: the FP32 chain's coarse call (``chip_smoke.COARSE_FP32``);
  * ``rung0``: the first refine rung (FP32, eps 1e-6, 16 steps) from the
    refine entry of ``coarse``'s recorded outputs;
  * ``rung1``: 24 more steps from ``rung0``'s recorded outputs;
  * ``raygen_high`` / ``raygen_default``: the cold start (K5) on the same
    pixels and 3 pad lanes, at the coarse calls' precisions.

Write the fixture on the card from the root of the checkout whose kernels
it records:

    python3 tests/w128_bundle.py tests/fixtures/w128_bundle.npz

(from another checkout's root, give this file's path: the package and
``chip_smoke`` are imported from the working directory).
"""
import os
import sys

import numpy as np
import torch

BUNDLE_SEED = 25
BUNDLE_RAYS = 2085
WIDTH, HEIGHT = 1920, 1080
PAD_LANES = 3
OUTPUTS = ("t", "budget", "active", "converged", "lane_steps")
CALLS = ("coarse", "coarse_fp32", "rung0", "rung1", "raygen_high", "raygen_default")


def fingerprint(params) -> float:
    """The float64 sum of every weight and bias of the net, to tell that a
    fixture was recorded with the same weights."""
    return float(sum(p.double().sum().item() for layer in params.chain for p in layer))


def bundle_rays(cnr, dev):
    """(config, c2w, origin, dirs [n, 3], pos [n] int32) of the bundle."""
    import chip_smoke
    from cudaneuralrender_torch.ops import camera as camera_lib
    from cudaneuralrender_torch.ops import march

    cfg = cnr.RenderConfig(width=WIDTH, height=HEIGHT, march_impl="staged")
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**chip_smoke.CAMERA), dev)
    origin, dirs = camera_lib.generate_rays(c2w, WIDTH, HEIGHT, cfg.focal)
    rng = np.random.default_rng(BUNDLE_SEED)
    pix = torch.as_tensor(rng.choice(WIDTH * HEIGHT, BUNDLE_RAYS, replace=False), device=dev)
    half = BUNDLE_RAYS // 2
    hit = march.init_state(origin, dirs[pix], cfg.bound_center, cfg.bound_radius).active
    tail = half + torch.argsort(hit[half:].to(torch.int8), stable=True)
    pix = torch.cat([pix[:half], pix[tail]])
    return cfg, c2w, origin, dirs[pix].contiguous(), pix.to(torch.int32)


def run_calls(cnr, params, cfg, c2w, origin, dirs, pos, recorded=None) -> dict:
    """Each call of the bundle through the kernel: name -> (t, budget,
    active, converged, lane_steps). ``recorded`` (a loaded fixture) gives
    the outputs the later calls start from; else this run's own."""
    import chip_smoke
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import march

    dev = dirs.device
    out = {}

    def state_of(name):
        if recorded is None:
            return out[name]
        t, budget, active, conv, steps = (torch.as_tensor(recorded[f"{name}.{k}"], device=dev)
                                          for k in OUTPUTS)
        return t, budget, active, conv, steps

    def call(name, state, **kw):
        s, lane_steps = megakernel.march_state(params, origin, dirs, state, cfg, 0.0,
                                               return_resolve=True, _ray_lanes=1, **kw)
        out[name] = (s.t, s.budget, s.active, s.converged, lane_steps)
        return s

    cold = march.init_state(origin, dirs, cfg.bound_center, cfg.bound_radius)
    coarse_kw = dict(relax_omega=cfg.relax_omega, cyl_window=cfg.cyl_window_coarse, coarse=True)
    call("coarse", cold, march_eps=cfg.coarse_eps, precision=cfg.coarse_precision, **coarse_kw)
    call("coarse_fp32", cold, march_eps=chip_smoke.COARSE_FP32["coarse_eps"],
         precision=chip_smoke.COARSE_FP32["coarse_precision"], **coarse_kw)
    steps0 = cold.steps

    def entry(name, steps):
        t, budget, active, conv, _ = state_of(name)
        return march.MarchState(t=t, budget=budget, active=active, converged=conv, steps=steps)

    first = chip_smoke.refine_entry(entry("coarse", steps0), origin, dirs, cfg)
    rung = dict(march_eps=1e-6, precision="highest")
    call("rung0", first, num_steps=16, **rung)
    # rung 1 continues from rung 0's outputs, its step counter 16 on
    call("rung1", entry("rung0", steps0 + 16), num_steps=24, **rung)
    padded = torch.cat([pos, torch.full((PAD_LANES,), -1, dtype=torch.int32, device=dev)])
    for precision, eps in (("high", cfg.coarse_eps),
                           ("default", chip_smoke.COARSE_FP32["coarse_eps"])):
        s, lane_steps = megakernel.march_raygen(
            params, c2w, padded, cfg, march_eps=eps, precision=precision,
            relax_omega=cfg.relax_omega, return_resolve=True, cyl_window=cfg.cyl_window_coarse)
        out[f"raygen_{precision}"] = (s.t, s.budget, s.active, s.converged, lane_steps)
    return out


def main(path: str) -> int:
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    import cudaneuralrender_torch as cnr

    dev = torch.device("cuda", 0)
    params = chip_smoke.wide_params(cnr, 4, dev)
    cfg, c2w, origin, dirs, pos = bundle_rays(cnr, dev)
    out = run_calls(cnr, params, cfg, c2w, origin, dirs, pos)
    arrays = {f"{name}.{k}": v.cpu().numpy() for name, vals in out.items()
              for k, v in zip(OUTPUTS, vals)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, dirs=dirs.cpu().numpy(), origin=origin.cpu().numpy(),
                        pos=pos.cpu().numpy(), c2w=c2w.cpu().numpy(),
                        fingerprint=np.float64(fingerprint(params)), **arrays)
    steps = {name: int(vals[4].max()) for name, vals in out.items()}
    print(f"w128 bundle: {BUNDLE_RAYS} rays, deepest lane steps {steps}, written to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
