"""The cone-traced prepass (``ops/prepass.py``, ``prepass_factor``) of the
PyTorch package against the JAX package's, on the CPU.

Rays at 32x32 from Camera(rotation_y=30, rotation_x=-20), factor 4, on a
sphere of radius 0.7 (margin 0.01) and on csg_demo (margin 0.05, the coarse
epsilon):
  * ``cone_trace`` and ``prepass_init`` against JAX's: t, t_stop and the
    budget within 1e-5, the dead / active masks identical except on lanes a
    float64 replay of the trace shows as undecidable in float32 (some
    low-resolution ray of the lane's 3x3 neighbourhood meets its miss test,
    budget <= 0, within UNDECIDED of the threshold; an arrival test decided
    the other way moves t_stop by less than the step, which approaches 0 at
    the cone's boundary);
  * the start depths are safe: every covered ray's segment from the
    bounding sphere to its start depth stays outside the surface (the SDF
    in float64 at 33 points of it), and the rays gain depth (as
    tests/test_prepass.py:16-31 checks JAX's); a small sphere at 128x128
    loses sky neighbourhoods and no ray that hits (tests/test_prepass.py:
    34-47);
  * the staged frame with ``prepass_factor=4`` (csg_demo, 32x32) meets the
    mixed-path bar (hits agree >= 99%, >= 97% of common hits within 1e-3)
    against JAX's frame with the option and against the port's own frame
    without it; a 30x30 frame skips the prepass silently (equal to the
    frame without the option bit for bit);
  * ``render_sequence(warm_start=True)`` over 3 frames with the option, in
    a real block order (16x16 blocks): frame 0 equal to the cold frame,
    every frame at the mixed bar against JAX's warm sequence; ``chunk=2``
    equal to ``chunk=1``; ``diff.solve_surface`` with the option against
    JAX's (hit masks >= 99%, |dt| <= 1e-4 on >= 99% of common hits); the
    sharded frame (which skips the prepass, as JAX's does) equal to the
    sharded frame without the option bit for bit.
"""
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import cudaneuralrender_torch as ct  # noqa: E402
import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch.ops import camera as camera_t  # noqa: E402
from cudaneuralrender_torch.ops import march as march_t  # noqa: E402
from cudaneuralrender_torch.ops import prepass as prepass_t  # noqa: E402
from cudaneuralrender_torch.ops import sdf as sdf_t  # noqa: E402
from cudaneuralrender_torch.parallel import mesh as mesh_t  # noqa: E402
from cudaneuralrender_torch.parallel import sharding as sharding_t  # noqa: E402
from cudaneuralrender_torch.render import renderer as renderer_t  # noqa: E402
from cudaneuralrender_tpu import diff as diff_j  # noqa: E402
from cudaneuralrender_tpu.ops import camera as camera_j  # noqa: E402
from cudaneuralrender_tpu.ops import prepass as prepass_j  # noqa: E402
from cudaneuralrender_tpu.ops import sdf as sdf_j  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H5 = os.path.join(REPO, "examples", "assets", "csg_demo.h5")
CAM = dict(rotation_y=30.0, rotation_x=-20.0)
SIDE, FACTOR = 32, 4
BOUND = dict(bound_center=(0, 0, 0), bound_radius=1.2)
UNDECIDED = 1e-4
MARGINS = {"sphere": 0.01, "csg_demo": 0.05}
# The mean depth a covered ray gains: JAX's test's 0.05 on the sphere; on
# csg_demo at this camera 0.0495 on the CPU.
GAINS = {"sphere": 0.05, "csg_demo": 0.04}


@pytest.fixture(scope="module")
def params():
    return cj.load(H5), ct.load(H5, device="cpu")


@pytest.fixture(autouse=True)
def _fresh_memo():
    ct.reset_schedule_memo()
    cj.reset_schedule_memo()


def _fields(params, scene):
    """(JAX SDF, port SDF, port float64 SDF) of a scene."""
    pj, pt = params
    if scene == "sphere":
        return (lambda p: sdf_j.sphere(p, 0.7), lambda p: sdf_t.sphere(p, 0.7),
                lambda p: sdf_t.sphere(p, 0.7))
    p64 = ct.from_numpy_params(ct.mlp.to_numpy_params(pt), device="cpu", dtype=torch.float64)
    return cj.neural_sdf_fn(pj, 0.0), ct.neural_sdf_fn(pt, 0.0), ct.neural_sdf_fn(p64, 0.0)


def _rays(side=SIDE, cam=CAM):
    c2w_j, _ = camera_j.view_matrices(cj.Camera(**cam))
    c2w_t, _ = camera_t.view_matrices(ct.Camera(**cam), "cpu")
    return camera_j.generate_rays(c2w_j, side, side, 2.0), camera_t.generate_rays(
        c2w_t, side, side, 2.0)


def _low_res(dirs, side=SIDE, factor=FACTOR):
    return dirs.reshape(side, side, 3)[::factor, ::factor].reshape(-1, 3)


def _spacing(side=SIDE, factor=FACTOR):
    n = side // factor
    return 2.0 * float((1.0 / n) ** 2 + (1.0 / n) ** 2) ** 0.5


def _decision_margins(f64, origin, dirs_l, spacing, margin, max_steps=256):
    """Float64 replay of ``cone_trace``: each low-resolution ray's smallest
    distance from the threshold of a miss test (its budget after a step)."""
    origin, dirs_l = origin.double(), dirs_l.double()
    st = march_t.init_state(origin, dirs_l, **BOUND)
    t, budget, active = st.t, st.budget, st.active
    low = torch.full_like(t, float("inf"))
    for _ in range(max_steps):
        if not active.any():
            break
        step = (f64(origin + dirs_l * t[:, None]) - (spacing * t + margin)) / (1.0 + spacing)
        walk = active & (step > 0.0)
        step = torch.where(walk, step, 0.0)
        budget = budget - step
        low = torch.where(walk, torch.minimum(low, budget.abs()), low)
        miss = walk & (budget <= 0.0)
        t = torch.where(walk & ~miss, t + step, t)
        active = walk & ~miss
    return low


def _undecided(low, side=SIDE, factor=FACTOR):
    """Full-resolution lanes whose 3x3 low-resolution neighbourhood holds a
    ray with an undecidable test."""
    n = side // factor
    near = -F.max_pool2d(-low.reshape(1, 1, n, n), 3, stride=1, padding=1)[0, 0] < UNDECIDED
    return near.repeat_interleave(factor, 0).repeat_interleave(factor, 1).reshape(-1).numpy()


@pytest.mark.parametrize("scene", ["sphere", "csg_demo"])
def test_cone_trace_matches_jax(params, scene):
    fj, ft, f64 = _fields(params, scene)
    (oj, dj), (ot, dt) = _rays()
    margin, spacing = MARGINS[scene], _spacing()
    want = np.asarray(prepass_j.cone_trace(fj, oj, _low_res(dj), spacing, margin=margin, **BOUND))
    got = prepass_t.cone_trace(ft, ot, _low_res(dt), spacing, margin=margin, **BOUND).numpy()
    low = _decision_margins(f64, ot, _low_res(dt), spacing, margin).numpy()
    far_j, far_t = want >= prepass_t._FAR, got >= prepass_t._FAR
    assert np.all((far_j == far_t) | (low < UNDECIDED))
    both = ~far_j & ~far_t
    assert both.sum() > 20
    np.testing.assert_allclose(got[both], want[both], rtol=0, atol=1e-5)


@pytest.mark.parametrize("scene", ["sphere", "csg_demo"])
def test_prepass_init_matches_jax(params, scene):
    fj, ft, f64 = _fields(params, scene)
    (oj, dj), (ot, dt) = _rays()
    margin = MARGINS[scene]
    sj = prepass_j.prepass_init(fj, oj, dj, SIDE, SIDE, FACTOR, margin=margin, **BOUND)
    st = prepass_t.prepass_init(ft, ot, dt, SIDE, SIDE, FACTOR, margin=margin, **BOUND)
    undecided = _undecided(_decision_margins(f64, ot, _low_res(dt), _spacing(), margin))
    act_j, act_t = np.asarray(sj.active), st.active.numpy()
    assert np.all((act_j == act_t) | undecided)
    same = (act_j == act_t) & ~undecided
    assert same.sum() > 500
    np.testing.assert_allclose(st.t.numpy()[same], np.asarray(sj.t)[same], rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.budget.numpy()[same], np.asarray(sj.budget)[same], rtol=0,
                               atol=1e-5)
    assert int(st.steps) == int(sj.steps) == 0
    assert not st.converged.any()


@pytest.mark.parametrize("scene", ["sphere", "csg_demo"])
def test_prepass_start_depths_are_safe(params, scene):
    _, ft, f64 = _fields(params, scene)
    _, (origin, dirs) = _rays()
    st = prepass_t.prepass_init(ft, origin, dirs, SIDE, SIDE, FACTOR, margin=MARGINS[scene],
                                **BOUND)
    base = march_t.init_state(origin, dirs, **BOUND)
    act = st.active
    assert act.sum() > 500
    # The segment from the bounding sphere to the start depth, at 33 points.
    frac = torch.linspace(0.0, 1.0, 33, dtype=torch.float64)
    t0, t1 = base.t[act].double(), st.t[act].double()
    ts = t0[:, None] + (t1 - t0)[:, None] * frac[None, :]
    pts = origin.double() + dirs[act].double()[:, None, :] * ts[..., None]
    assert (f64(pts.reshape(-1, 3)) > 0.0).all()
    gained = (st.t - base.t)[act]
    assert gained.mean() > GAINS[scene] and (gained >= 0).all()
    np.testing.assert_allclose((base.budget - st.budget)[act].numpy(), gained.numpy(),
                               rtol=0, atol=1e-6)


def test_prepass_kills_sky_neighbourhoods():
    f = lambda p: sdf_t.sphere(p, 0.3)  # noqa: E731  a small sphere, much sky
    _, (origin, dirs) = _rays(128, dict(rotation_y=30.0))
    base = march_t.init_state(origin, dirs, **BOUND)
    st = prepass_t.prepass_init(f, origin, dirs, 128, 128, 4, margin=0.01, **BOUND)
    assert int(st.active.sum()) < int(base.active.sum())
    ref = march_t.sphere_trace(f, origin, dirs, max_steps=500, march_eps=1e-6, **BOUND)
    culled = base.active & ~st.active
    assert not (ref.hit & culled).any()


def _mixed_bar(a, b):
    hit_a, hit_b = a[..., 3] > 0, b[..., 3] > 0
    assert (hit_a == hit_b).mean() >= 0.99
    both = hit_a & hit_b
    assert both.sum() > 50
    close = np.all(np.abs(b[both] - a[both]) < 1e-3, axis=-1).mean()
    assert close >= 0.97, close


def _cfg(pkg, **kw):
    return pkg.RenderConfig(**dict(dict(width=SIDE, height=SIDE, march_impl="staged",
                                        rgba_packed=False), **kw))


def test_staged_prepass_matches_jax_and_option_off(params, monkeypatch):
    pj, pt = params
    calls = []
    real = prepass_t.prepass_init
    monkeypatch.setattr(prepass_t, "prepass_init", lambda *a, **k: calls.append(1) or real(*a, **k))
    sj, st = {}, {}
    want = np.asarray(cj.render_staged(pj, cj.Camera(**CAM), _cfg(cj, prepass_factor=FACTOR),
                                       stats_out=sj))
    got = ct.render_staged(pt, ct.Camera(**CAM), _cfg(ct, prepass_factor=FACTOR),
                           stats_out=st).numpy()
    assert calls == [1]
    assert st["fast_path"] and sj["fast_path"]
    _mixed_bar(want, got)
    ct.reset_schedule_memo()
    off = ct.render_staged(pt, ct.Camera(**CAM), _cfg(ct)).numpy()
    _mixed_bar(off, got)
    assert renderer_t.frame_reads_host(_cfg(ct, prepass_factor=FACTOR))


def test_prepass_skipped_when_not_divisible(params, monkeypatch):
    _, pt = params
    calls = []
    real = prepass_t.prepass_init
    monkeypatch.setattr(prepass_t, "prepass_init", lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = dict(width=30, height=30, max_steps=200)
    got = ct.render_staged(pt, ct.Camera(), _cfg(ct, prepass_factor=FACTOR, **kw)).numpy()
    ct.reset_schedule_memo()
    want = ct.render_staged(pt, ct.Camera(), _cfg(ct, **kw)).numpy()
    assert calls == [] and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def _cams(pkg, n):
    return [pkg.Camera(rotation_x=-20.0, rotation_y=30.0 + i) for i in range(n)]


def test_warm_sequence_with_prepass_matches_jax(params):
    pj, pt = params
    kw = dict(prepass_factor=FACTOR, coarse_block=(16, 16), max_steps=300)
    warm = ct.render_sequence(pt, _cams(ct, 3), _cfg(ct, **kw), warm_start=True)
    ct.reset_schedule_memo()
    cold = ct.render_staged(pt, _cams(ct, 1)[0], _cfg(ct, **kw)).numpy()
    np.testing.assert_array_equal(warm[0].numpy(), cold)
    jax_warm = cj.render_sequence(pj, _cams(cj, 3), _cfg(cj, **kw), warm_start=True)
    for a, b in zip(jax_warm, warm):
        _mixed_bar(np.asarray(a), b.numpy())
    ct.reset_schedule_memo()
    chunked = ct.render_sequence(pt, _cams(ct, 3), _cfg(ct, **kw), chunk=2)
    ct.reset_schedule_memo()
    single = ct.render_sequence(pt, _cams(ct, 3), _cfg(ct, **kw))
    for a, b in zip(chunked, single):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_solve_surface_with_prepass_matches_jax(params):
    pj, pt = params
    kw = dict(prepass_factor=FACTOR, max_steps=300)
    tj, hj = diff_j.solve_surface(pj, cj.Camera(**CAM), _cfg(cj, **kw))
    tt, ht = ct.diff.solve_surface(pt, ct.Camera(**CAM), _cfg(ct, **kw))
    hj, ht = np.asarray(hj), ht.numpy()
    assert (hj == ht).mean() >= 0.99
    both = hj & ht
    assert (np.abs(np.asarray(tj)[both] - tt.numpy()[both]) <= 1e-4).mean() >= 0.99


def test_sharded_frame_skips_prepass(params):
    _, pt = params
    kw = dict(max_steps=300, compact_min=64)
    mesh = mesh_t.make_mesh((4,), ("data",), ["cpu"] * 4)
    on = sharding_t.render_image_sharded_staged(pt, ct.Camera(**CAM),
                                                _cfg(ct, prepass_factor=FACTOR, **kw), mesh)
    ct.reset_schedule_memo()
    off = sharding_t.render_image_sharded_staged(pt, ct.Camera(**CAM), _cfg(ct, **kw), mesh)
    np.testing.assert_array_equal(on.numpy(), off.numpy())
