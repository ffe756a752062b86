"""The baked distance grid (``ops/grid.py``, ``grid_res``) of the PyTorch
package against the JAX package's, on the CPU.

A sphere of radius 0.7 and csg_demo, the grid over [-1.26, 1.26]^3 (the
renderer's 1.05 x bound radius), rays at 32x32 from Camera(rotation_y=30,
rotation_x=-20):
  * ``bake`` at 32^3 within 1e-5 of JAX's (the chains sum in their own
    order); ``trilinear`` of one grid at 2000 seeded points within 1e-6 of
    JAX's, and within a cell diagonal of the sphere's field;
  * ``grid_march`` from the bounding-sphere init: ``steps`` equal to JAX's
    exactly (the march carries it on against ``max_steps``), t and the
    budget within 1e-5, the active masks identical; also cut by
    ``grid_steps`` (3) and by ``max_steps`` (2), and from a warm init; every
    ray still active sits outside the surface (the SDF in float64) and the
    rays aimed at it moved (as tests/test_grid.py:49-69 checks JAX's);
  * frames with ``grid_res=32`` (csg_demo, 32x32, the staged config):
    ``render_staged`` at the mixed-path bar (hits agree >= 99%, >= 97% of
    common hits within 1e-3) against JAX's frame with the option and the
    port's frame without it, with JAX's stats; ``render_sequence
    (warm_start=True)`` against JAX's warm sequence at that bar and
    ``chunk=2`` equal to ``chunk=1``; the sharded frame on 4 logical
    shards (``compact_min=64``) equal to ``render_staged`` with the option
    bit for bit, and against JAX's sharded frame at the mixed bar;
    ``diff.solve_surface`` against JAX's (hit masks >= 99%, |dt| <= 1e-4 on
    >= 99% of common hits); a two-geometry ``render_batch_staged`` equal to
    each geometry's ``render_staged`` (with ``prepass_factor=4`` too).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import cudaneuralrender_torch as ct  # noqa: E402
import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch.ops import camera as camera_t  # noqa: E402
from cudaneuralrender_torch.ops import grid as grid_t  # noqa: E402
from cudaneuralrender_torch.ops import march as march_t  # noqa: E402
from cudaneuralrender_torch.ops import sdf as sdf_t  # noqa: E402
from cudaneuralrender_torch.parallel import mesh as mesh_t  # noqa: E402
from cudaneuralrender_torch.parallel import sharding as sharding_t  # noqa: E402
from cudaneuralrender_torch.render import multigeom as multigeom_t  # noqa: E402
from cudaneuralrender_torch.render import renderer as renderer_t  # noqa: E402
from cudaneuralrender_tpu import diff as diff_j  # noqa: E402
from cudaneuralrender_tpu.ops import camera as camera_j  # noqa: E402
from cudaneuralrender_tpu.ops import grid as grid_j  # noqa: E402
from cudaneuralrender_tpu.ops import march as march_j  # noqa: E402
from cudaneuralrender_tpu.ops import sdf as sdf_j  # noqa: E402
from cudaneuralrender_tpu.parallel import mesh as mesh_j  # noqa: E402
from cudaneuralrender_tpu.parallel import sharding as sharding_j  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H5 = os.path.join(REPO, "examples", "assets", "csg_demo.h5")
CAM = dict(rotation_y=30.0, rotation_x=-20.0)
SIDE, RES = 32, 32
GBOUND = 1.2 * 1.05
BOUND = dict(bound_center=(0, 0, 0), bound_radius=1.2)


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


def _rays(cam=CAM):
    c2w_j, _ = camera_j.view_matrices(cj.Camera(**cam))
    c2w_t, _ = camera_t.view_matrices(ct.Camera(**cam), "cpu")
    return (camera_j.generate_rays(c2w_j, SIDE, SIDE, 2.0),
            camera_t.generate_rays(c2w_t, SIDE, SIDE, 2.0))


@pytest.mark.parametrize("scene", ["sphere", "csg_demo"])
def test_bake_matches_jax(params, scene):
    fj, ft, _ = _fields(params, scene)
    want = np.asarray(grid_j.bake(fj, RES, GBOUND))
    got = grid_t.bake(ft, RES, GBOUND, device="cpu").numpy()
    assert got.shape == (RES, RES, RES)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if scene == "sphere":  # the centre cell deep inside, the corner far outside
        assert got[RES // 2, RES // 2, RES // 2] < -0.5 and got[0, 0, 0] > 0.5


def test_trilinear_matches_jax_and_the_field():
    rng = np.random.default_rng(0)
    baked = grid_t.bake(lambda p: sdf_t.sphere(p, 0.7), 64, GBOUND, device="cpu")
    pts = rng.uniform(-1.3, 1.3, size=(2000, 3)).astype(np.float32)  # some clamp
    want = np.asarray(grid_j.trilinear(jnp.asarray(baked.numpy()), jnp.asarray(pts), GBOUND))
    got = grid_t.trilinear(baked, torch.from_numpy(pts), GBOUND).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    inside = np.abs(pts).max(axis=1) < 1.1
    field = np.linalg.norm(pts[inside], axis=1) - 0.7
    assert np.abs(got[inside] - field).max() < (2 * GBOUND / 64) * np.sqrt(3)


def _walk_both(params, scene, warm=False, **kw):
    fj, ft, _ = _fields(params, scene)
    (oj, dj), (ot, dt) = _rays()
    gj = grid_j.bake(fj, RES, GBOUND)
    gt = grid_t.bake(ft, RES, GBOUND, device="cpu")
    t_init = None
    if warm:  # half the lanes warm, 0.3 past the bounding sphere
        s0 = march_t.init_state(ot, dt, **BOUND)
        t_init = torch.where(torch.arange(SIDE * SIDE) % 2 == 0, s0.t + 0.3, -1.0)
    tj = None if t_init is None else jnp.asarray(t_init.numpy())
    sj = march_j.init_state(oj, dj, t_init=tj, **BOUND)
    st = march_t.init_state(ot, dt, t_init=t_init, **BOUND)
    wj = grid_j.grid_march(gj, oj, dj, sj, bound=GBOUND, **kw)
    wt = grid_t.grid_march(gt, ot, dt, st, bound=GBOUND, **kw)
    return wj, wt, st, (ot, dt)


@pytest.mark.parametrize("case", ["sphere", "csg_demo", "csg_demo_warm", "grid_steps_3",
                                  "max_steps_2"])
def test_grid_march_matches_jax(params, case):
    scene = "sphere" if case == "sphere" else "csg_demo"
    kw = dict(max_steps=6000)
    if case == "grid_steps_3":
        kw["grid_steps"] = 3
    if case == "max_steps_2":
        kw["max_steps"] = 2
    wj, wt, st, _ = _walk_both(params, scene, warm=case.endswith("warm"), **kw)
    assert int(wt.steps) == int(wj.steps)
    if case == "grid_steps_3":
        assert int(wt.steps) == 3
    if case == "max_steps_2":
        assert int(wt.steps) == 2
    assert int(wt.steps) > 0
    np.testing.assert_array_equal(wt.active.numpy(), np.asarray(wj.active))
    np.testing.assert_allclose(wt.t.numpy(), np.asarray(wj.t), rtol=0, atol=1e-5)
    np.testing.assert_allclose(wt.budget.numpy(), np.asarray(wj.budget), rtol=0, atol=1e-5)
    assert not wt.converged.any()
    assert (wt.t > st.t + 1e-3).any()


@pytest.mark.parametrize("scene", ["sphere", "csg_demo"])
def test_grid_march_never_crosses_surface(params, scene):
    _, wt, st, (origin, dirs) = _walk_both(params, scene, max_steps=6000)
    _, _, f64 = _fields(params, scene)
    act = wt.active
    pts = origin.double() + dirs[act].double() * wt.t[act].double()[:, None]
    assert (f64(pts) > 0.0).all()
    assert ((wt.t - st.t)[act]).max() > 0.1
    # the budget paid for the distance moved
    np.testing.assert_allclose((st.budget - wt.budget)[act].numpy(),
                               (wt.t - st.t)[act].numpy(), rtol=0, atol=1e-5)


def _mixed_bar(a, b):
    hit_a, hit_b = a[..., 3] > 0, b[..., 3] > 0
    assert (hit_a == hit_b).mean() >= 0.99
    both = hit_a & hit_b
    assert both.sum() > 50
    close = np.all(np.abs(b[both] - a[both]) < 1e-3, axis=-1).mean()
    assert close >= 0.97, close


def _cfg(pkg, **kw):
    return pkg.RenderConfig(**dict(dict(width=SIDE, height=SIDE, march_impl="staged",
                                        rgba_packed=False, max_steps=300), **kw))


def test_staged_grid_matches_jax_and_option_off(params):
    pj, pt = params
    sj, st = {}, {}
    want = np.asarray(cj.render_staged(pj, cj.Camera(**CAM), _cfg(cj, grid_res=RES),
                                       stats_out=sj))
    got = ct.render_staged(pt, ct.Camera(**CAM), _cfg(ct, grid_res=RES), stats_out=st).numpy()
    _mixed_bar(want, got)
    assert st["fast_path"] and sj["fast_path"]
    assert st["steps"] == sj["steps"] and abs(st["hits"] - sj["hits"]) <= 0.01 * sj["hits"]
    ct.reset_schedule_memo()
    _mixed_bar(ct.render_staged(pt, ct.Camera(**CAM), _cfg(ct)).numpy(), got)
    assert renderer_t.frame_reads_host(_cfg(ct, grid_res=RES))
    assert not renderer_t.frame_reads_host(_cfg(ct, width=1920, height=1080))


def _cams(pkg, n):
    return [pkg.Camera(rotation_x=-20.0, rotation_y=30.0 + i) for i in range(n)]


def test_warm_sequence_with_grid_matches_jax(params):
    pj, pt = params
    warm = ct.render_sequence(pt, _cams(ct, 3), _cfg(ct, grid_res=RES), warm_start=True)
    jax_warm = cj.render_sequence(pj, _cams(cj, 3), _cfg(cj, grid_res=RES), warm_start=True)
    for a, b in zip(jax_warm, warm):
        _mixed_bar(np.asarray(a), b.numpy())
    ct.reset_schedule_memo()
    chunked = ct.render_sequence(pt, _cams(ct, 3), _cfg(ct, grid_res=RES), chunk=2)
    ct.reset_schedule_memo()
    single = ct.render_sequence(pt, _cams(ct, 3), _cfg(ct, grid_res=RES))
    for a, b in zip(chunked, single):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_sharded_grid_frame_matches(params):
    pj, pt = params
    kw = dict(grid_res=RES, compact_min=64)
    got = sharding_t.render_image_sharded_staged(
        pt, ct.Camera(**CAM), _cfg(ct, **kw), mesh_t.make_mesh((4,), ("data",), ["cpu"] * 4))
    ct.reset_schedule_memo()
    # A lane's walk does not depend on its neighbours: bit for bit.
    np.testing.assert_array_equal(
        got.numpy(), ct.render_staged(pt, ct.Camera(**CAM), _cfg(ct, **kw)).numpy())
    jax_off = dict(coarse_pallas=False, refine_pallas=False, tail_pallas=False)
    want = sharding_j.render_image_sharded_staged(
        pj, cj.Camera(**CAM), _cfg(cj, **kw, **jax_off),
        mesh_j.make_mesh((4,), ("data",), jax.devices()[:4]))
    _mixed_bar(np.asarray(want), got.numpy())


def test_solve_surface_with_grid_matches_jax(params):
    pj, pt = params
    tj, hj = diff_j.solve_surface(pj, cj.Camera(**CAM), _cfg(cj, grid_res=RES))
    tt, ht = ct.diff.solve_surface(pt, ct.Camera(**CAM), _cfg(ct, grid_res=RES))
    hj, ht = np.asarray(hj), ht.numpy()
    assert (hj == ht).mean() >= 0.99
    both = hj & ht
    assert (np.abs(np.asarray(tj)[both] - tt.numpy()[both]) <= 1e-4).mean() >= 0.99


@pytest.mark.parametrize("option", [dict(grid_res=RES), dict(prepass_factor=4)],
                         ids=["grid", "prepass"])
def test_multigeom_batch_with_option(params, option):
    _, pt = params
    rng = np.random.default_rng(7)
    noisy = ct.from_numpy_params(
        [(w + 0.01 * rng.standard_normal(w.shape).astype(np.float32), b)
         for w, b in ct.mlp.to_numpy_params(pt)], device="cpu")
    cfg = _cfg(ct, **option)
    batch = multigeom_t.render_batch_staged([pt, noisy], ct.Camera(**CAM), cfg)
    for net, img in zip((pt, noisy), batch):
        ct.reset_schedule_memo()
        np.testing.assert_array_equal(
            img.numpy(), ct.render_staged(net, ct.Camera(**CAM), cfg).numpy())
