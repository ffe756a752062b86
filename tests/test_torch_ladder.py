"""The port's own precision ladder: its default coarse phase against the JAX
package on the CPU, and the one turntable lane that runs to ``max_steps``.

The port sets ``coarse_precision`` / ``coarse_eps`` from the H100's chain
errors (utils/config.py; benchmarks/precision_ladder.py measured them), so
its defaults are not the JAX package's. Weights: examples/assets csg_demo
(3->32x8->1) and anim_demo (4 inputs), Camera(rotation_y=30,
rotation_x=-20). Bars:
  * the port at its defaults against the JAX package at
    ``march_precision="full"`` (HIGHEST throughout) at 64x64 and 128x128:
    the mixed bar of tests/test_render.py:85-101 (hits agree on >= 99%,
    >= 97% of common hits within 1e-3);
  * the port at its defaults against the JAX package given the port's
    ladder fields, on anim_demo (csg_demo's cases are the staged tests of
    test_torch_render.py and test_torch_precision.py, which pass the same
    fields): that bar, the same fast-path verdict, hits within 1% and the
    same unresolved count (test_torch_precision.py's option cases);
  * the default ``coarse_eps`` at least ERR_FACTOR times the max |SDF -
    float64| of the chain the coarse call runs
    (``fused_mlp.mlp_chain_3pass_plain`` for "high"), on seeded points in
    the bounding sphere;
  * frame 21 of ``chip_smoke``'s many_sphere turntable (1080p,
    Camera(rotation_x=-20, rotation_y=21), frame 21): the one lane that
    reached max_steps (6000) on the H100, pixel (663, 312), marched plainly
    from the bounding sphere by both packages in float32 and float64
    (eps 1e-6): it passes a surface at 1.8e-6 and needs over 10000 steps,
    so it is unresolved at 6000 in every one of them.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import chip_smoke  # noqa: E402
import cudaneuralrender_torch as ct  # noqa: E402
import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch.kernels import fused_mlp as fused_t  # noqa: E402
from cudaneuralrender_torch.ops import camera as camera_t  # noqa: E402
from cudaneuralrender_torch.ops import march as march_t  # noqa: E402
from cudaneuralrender_torch.render import renderer as renderer_t  # noqa: E402
from cudaneuralrender_tpu.ops import camera as camera_j  # noqa: E402
from cudaneuralrender_tpu.ops import march as march_j  # noqa: E402
from cudaneuralrender_tpu.ops import sdf as sdf_j  # noqa: E402
from cudaneuralrender_tpu.render import renderer as renderer_j  # noqa: E402

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples", "assets")
CAM = dict(rotation_y=30.0, rotation_x=-20.0)
LADDER = dict(coarse_precision=ct.RenderConfig.coarse_precision,
              coarse_eps=ct.RenderConfig.coarse_eps)
ERR_FACTOR = 10.0
# (asset, scene, frame) of the nets with a surface in the bounding sphere:
# anim_demo at frame 0 (at 37 its SDF is 13 or more there)
NETS = {"csg_demo": ("csg_demo", "neural_raw", 0.0),
        "anim_demo": ("anim_demo", "neural_raw", 0.0)}
SCENES = {"csg_demo": ("csg_demo", "neural_raw", 0.0),
          "anim_demo_many_sphere_f37": ("anim_demo", "many_sphere", 37.0),
          "anim_demo_f0": ("anim_demo", "neural_raw", 0.0)}
# The turntable lane: chip_smoke.drive_turntable's frame DEEP_FRAME, and the
# pixel whose lane the card left active at max_steps (chip_smoke.deep_lanes,
# under both the JAX package's ladder and the port's), with its ray (float32
# origin and direction) as the card built it. Both packages march this ray:
# its crawl's length moves by percents with an ulp of its direction.
DEEP_PIXEL = 599703
DEEP_ORIGIN = (-0.7167358994483948, -0.6386065483093262, 1.7545572519302368)
DEEP_DIR = (0.20698337256908417, 0.13532571494579315, -0.9689400792121887)
DEEP_SIDE = (1920, 1080)


def _params(asset):
    path = os.path.join(ASSETS, f"{asset}.h5")
    return cj.load(path), ct.load(path, device="cpu")


def _mixed_bar(a, b):
    hit_a, hit_b = a[..., 3] > 0, b[..., 3] > 0
    assert (hit_a == hit_b).mean() >= 0.99
    both = hit_a & hit_b
    assert both.sum() > 50
    close = np.all(np.abs(b[both] - a[both]) < 1e-3, axis=-1).mean()
    assert close >= 0.97, close


def _kw(asset, scene, side):
    return dict(width=side, height=side, scene=scene, march_impl="staged", rgba_packed=False,
                num_inputs=4 if asset == "anim_demo" else 3)


@pytest.mark.parametrize("side", [64, 128])
@pytest.mark.parametrize("case", list(SCENES))
def test_default_ladder_meets_mixed_bar_against_jax_full(case, side):
    asset, scene, frame = SCENES[case]
    pj, pt = _params(asset)
    kw = _kw(asset, scene, side)
    cj.reset_schedule_memo()
    ct.reset_schedule_memo()
    want = np.asarray(cj.render_staged(pj, cj.Camera(**CAM),
                                       cj.RenderConfig(march_precision="full", **kw),
                                       frame=frame))
    cfg = ct.RenderConfig(**kw)
    assert (cfg.coarse_precision, cfg.coarse_eps) == tuple(LADDER.values())
    got = ct.render_staged(pt, ct.Camera(**CAM), cfg, frame=frame).numpy()
    assert got.shape == (side, side, 4) and np.isfinite(got).all()
    _mixed_bar(want, got)


@pytest.mark.parametrize("case", ["anim_demo_many_sphere_f37", "anim_demo_f0"])
def test_default_ladder_matches_jax_at_the_same_fields(case):
    asset, scene, frame = SCENES[case]
    pj, pt = _params(asset)
    kw = _kw(asset, scene, 64)
    cj.reset_schedule_memo()
    ct.reset_schedule_memo()
    stats_j, stats_t = {}, {}
    want = np.asarray(cj.render_staged(pj, cj.Camera(**CAM), cj.RenderConfig(**kw, **LADDER),
                                       frame=frame, stats_out=stats_j))
    got = ct.render_staged(pt, ct.Camera(**CAM), ct.RenderConfig(**kw), frame=frame,
                           stats_out=stats_t).numpy()
    _mixed_bar(want, got)
    assert stats_t["fast_path"] == stats_j["fast_path"]
    assert abs(stats_t["hits"] - stats_j["hits"]) <= 0.01 * stats_j["hits"]
    assert stats_t["unresolved"] == stats_j["unresolved"]


@pytest.mark.parametrize("net", list(NETS))
def test_default_coarse_eps_dominates_its_chain_error(net):
    """The plain version of the chain the default coarse call runs, on 2^18
    seeded points in the bounding sphere (``chip_smoke.ball_points``)
    against float64: the default eps is at least ERR_FACTOR times its
    largest error."""
    asset, _, frame = NETS[net]
    _, pt = _params(asset)
    weights, biases, n_in, hidden = fused_t.packed_params(pt)
    pts = chip_smoke.ball_points(32, 1 << 18, torch.device("cpu"))
    x = torch.zeros((pts.shape[0], hidden), dtype=torch.float32)
    x[:, :3] = pts
    if n_in == 4:
        x[:, 3] = frame
    if LADDER["coarse_precision"] == "high":
        w_hi, w_lo = fused_t.packed_hi_lo(pt)
        got = fused_t.mlp_chain_3pass_plain(w_hi, w_lo, biases, x, weights.shape[0])[:, 0]
    else:
        got = fused_t.mlp_chain_plain(weights, biases, x, weights.shape[0])[:, 0]
    want = chip_smoke.sdf_float64(pt, pts, frame)
    assert want.abs().min() < LADDER["coarse_eps"]  # the points reach the surface
    err = (got.double() - want).abs().max().item()
    assert LADDER["coarse_eps"] >= ERR_FACTOR * err, err


def _deep_cfg(pkg):
    return pkg.RenderConfig(width=DEEP_SIDE[0], height=DEEP_SIDE[1], scene="many_sphere")


def _deep_cam(pkg):
    return pkg.Camera(rotation_x=chip_smoke.CAMERA["rotation_x"],
                      rotation_y=float(chip_smoke.DEEP_FRAME))


def _march_torch(dtype, limits):
    """The lane marched plainly from the bounding sphere in ``dtype`` to
    each step count of ``limits`` in turn: [(steps, active, converged, t)],
    and the least distance along the ray over t in [1.6, 1.7]."""
    cfg = _deep_cfg(ct)
    origin, dirs = torch.tensor(DEEP_ORIGIN), torch.tensor([DEEP_DIR])
    _, pt = _params("csg_demo")
    net = ct.MLP([(l.w.to(dtype), l.b.to(dtype)) for l in pt])
    f = renderer_t.scene_fn(net, cfg, float(chip_smoke.DEEP_FRAME))
    o, d = origin.to(dtype), dirs.to(dtype)
    s = march_t.init_state(o, d, cfg.bound_center, cfg.bound_radius)
    out = []
    for n in limits:
        s = march_t.march_stage(f, o, d, s, num_steps=n, max_steps=n, march_eps=cfg.march_eps)
        out.append((int(s.steps), bool(s.active[0]), bool(s.converged[0]), float(s.t[0])))
    ts = torch.linspace(1.6, 1.7, 10001, dtype=dtype)
    return out, f(o + d * ts[:, None]).min().item()


def _march_jax(dtype, limits):
    """``_march_torch`` in the JAX package: its scene on the float32 net
    (its chain sums in float32 at any input dtype), or in float64 its
    compose (``ops.sdf.make_scene``) around the net's layers in float64."""
    cfg = _deep_cfg(cj)
    origin, dirs = np.float32(DEEP_ORIGIN), np.float32([DEEP_DIR])
    pj, _ = _params("csg_demo")
    frame = float(chip_smoke.DEEP_FRAME)
    if dtype == jnp.float64:
        layers = [(jnp.asarray(l.w, dtype), jnp.asarray(l.b, dtype)) for l in pj]

        def neural(p):
            h = p
            for i, (w, b) in enumerate(layers):
                h = h @ w + b
                if i + 1 < len(layers):
                    h = jnp.maximum(h, 0.0)
            return h[..., 0]

        f = sdf_j.make_scene(cfg.scene, neural, frame)
    else:
        f = renderer_j.scene_fn(pj, cfg, frame)
    o, d = jnp.asarray(origin, dtype), jnp.asarray(dirs, dtype)
    s = march_j.init_state(o, d, cfg.bound_center, cfg.bound_radius)
    stage = jax.jit(lambda s, n: march_j.march_stage(f, o, d, s, num_steps=n,
                                                     max_steps=limits[-1],
                                                     march_eps=cfg.march_eps))
    out = []
    for n in limits:
        s = stage(s, n - int(s.steps))
        assert s.t.dtype == dtype
        out.append((int(s.steps), bool(s.active[0]), bool(s.converged[0]), float(s.t[0])))
    ts = jnp.linspace(1.6, 1.7, 10001, dtype=dtype)
    return out, float(f(o + d * ts[:, None]).min())


def test_turntable_frame21_lane_is_the_cards_ray():
    """Each package's camera builds the card's ray for the pixel, to float32
    rounding."""
    c2w, _ = camera_t.view_matrices(_deep_cam(ct))
    cfg = _deep_cfg(ct)
    got_t = camera_t.ray_dirs_from_index(c2w, torch.tensor([DEEP_PIXEL]), cfg.height, cfg.width,
                                         cfg.focal)[0].numpy()
    c2w_j, _ = camera_j.view_matrices(_deep_cam(cj))
    got_j = np.asarray(camera_j.ray_dirs_from_index(c2w_j, jnp.asarray([DEEP_PIXEL]), cfg.height,
                                                    cfg.width, cfg.focal))[0]
    for origin, got in ((c2w[:, 3].numpy(), got_t), (np.asarray(c2w_j[:, 3]), got_j)):
        np.testing.assert_allclose(origin, DEEP_ORIGIN, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, DEEP_DIR, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_turntable_frame21_lane_needs_more_than_max_steps(dtype):
    """Both packages march the card's lane plainly from the bounding sphere:
    it grazes a surface at 1.6e-6 to 1.8e-6 (eps 1e-6) near t = 1.655,
    crawls past it, and converges on the surface behind at t = 1.78694 after
    over 10000 steps: at max_steps (6000) it is unresolved in both packages
    and both precisions, as the card left it (the staged march relaxes its
    terminal rung, which crawls slower still)."""
    max_steps = ct.RenderConfig.max_steps
    limits = (max_steps, 12000)
    got = {"torch": _march_torch(getattr(torch, dtype), limits)}
    with jax.enable_x64(dtype == "float64"):
        got["jax"] = _march_jax(getattr(jnp, dtype), limits)
    for pkg, ((capped, end), grazing) in got.items():
        assert capped[:3] == (max_steps, True, False), (pkg, capped)
        assert capped[3] < 1.66 and 1e-6 < grazing < 2e-6, (pkg, capped, grazing)
        assert 10000 < end[0] < 11000 and end[1:3] == (False, True), (pkg, end)
        assert abs(end[3] - 1.78694) < 1e-4, (pkg, end)
    assert abs(got["torch"][0][1][3] - got["jax"][0][1][3]) <= 1e-5
