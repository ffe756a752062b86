"""Camera, march init, shading and compaction parity with the JAX package.

Inputs are made with numpy from fixed seeds and fed to both packages.
Tolerances: 1e-6 for camera/ray/init math (float32, a few ops that may
round differently), exact for the u32 colour packing and for sort
permutations, 1e-4 for autodiff normals (a 9-layer float32 gradient in
another summation order, then normalised).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import cudaneuralrender_torch as ct  # noqa: E402
import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch.ops import camera as cam_t  # noqa: E402
from cudaneuralrender_torch.ops import compaction as comp_t  # noqa: E402
from cudaneuralrender_torch.ops import march as march_t  # noqa: E402
from cudaneuralrender_torch.ops import shading as shade_t  # noqa: E402
from cudaneuralrender_torch.render import renderer as rend_t  # noqa: E402
from cudaneuralrender_tpu.ops import camera as cam_j  # noqa: E402
from cudaneuralrender_tpu.ops import compaction as comp_j  # noqa: E402
from cudaneuralrender_tpu.ops import march as march_j  # noqa: E402
from cudaneuralrender_tpu.ops import shading as shade_j  # noqa: E402
from cudaneuralrender_tpu.render import renderer as rend_j  # noqa: E402

H5 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples", "assets",
                  "csg_demo.h5")
CAMS = [(0.0, 0.0, (0.0, 0.0, -2.0)), (-20.0, 30.0, (0.0, 0.0, -2.0)),
        (35.0, -110.0, (0.1, -0.2, -2.5))]


def _cams(i):
    rx, ry, t = CAMS[i]
    return (cj.Camera(rotation_x=rx, rotation_y=ry, translation=t),
            ct.Camera(rotation_x=rx, rotation_y=ry, translation=t))


@pytest.mark.parametrize("cam", range(len(CAMS)))
def test_camera_and_rays_match(cam):
    cj_, ct_ = _cams(cam)
    c2w_j, w2c_j = cam_j.view_matrices(cj_)
    c2w_t, w2c_t = cam_t.view_matrices(ct_)
    np.testing.assert_allclose(c2w_t.numpy(), np.asarray(c2w_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(w2c_t.numpy(), np.asarray(w2c_j), rtol=0, atol=1e-6)
    c2w = np.array(c2w_j)
    o_j, d_j = cam_j.generate_rays(jnp.asarray(c2w), 24, 40, 2.0)
    o_t, d_t = cam_t.generate_rays(torch.from_numpy(c2w), 24, 40, 2.0)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=1e-6)
    idx = np.random.default_rng(cam).integers(0, 24 * 40, 300).astype(np.int32)
    dj = cam_j.ray_dirs_from_index(jnp.asarray(c2w), jnp.asarray(idx), 24, 40, 2.0)
    dt = cam_t.ray_dirs_from_index(torch.from_numpy(c2w), torch.from_numpy(idx), 24, 40, 2.0)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cam", range(len(CAMS)))
def test_intersect_sphere_and_init_state_match(cam):
    cj_, _ = _cams(cam)
    c2w = np.array(cam_j.view_matrices(cj_)[0])
    o, d = (np.array(a) for a in cam_j.generate_rays(jnp.asarray(c2w), 32, 32, 2.0))
    for center, radius in (((0.0, 0.0, 0.0), 1.2), ((0.1, -0.2, 0.05), 0.7)):
        tj = march_j.intersect_sphere(jnp.asarray(o), jnp.asarray(d), center, radius)
        tt = march_t.intersect_sphere(torch.from_numpy(o), torch.from_numpy(d), center, radius)
        np.testing.assert_array_equal(tt[2].numpy(), np.asarray(tj[2]))
        hit = np.asarray(tj[2])
        for a, b in zip(tt[:2], tj[:2]):
            np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], rtol=0, atol=1e-6)
        sj = march_j.init_state(jnp.asarray(o), jnp.asarray(d), center, radius)
        st = march_t.init_state(torch.from_numpy(o), torch.from_numpy(d), center, radius)
        np.testing.assert_array_equal(st.active.numpy(), np.asarray(sj.active))
        np.testing.assert_array_equal(st.converged.numpy(), np.asarray(sj.converged))
        np.testing.assert_allclose(st.t.numpy(), np.asarray(sj.t), rtol=0, atol=1e-6)
        np.testing.assert_allclose(st.budget.numpy(), np.asarray(sj.budget), rtol=0, atol=1e-6)
        assert int(st.steps) == int(sj.steps) == 0


def test_pack_unpack_rgba_u32_byte_identical():
    """Every level 0..255 on each channel, plus out-of-range and
    between-level values, packs to the same word and unpacks to the same
    float32 bits as the JAX package."""
    levels = np.arange(256, dtype=np.float32)
    rng = np.random.default_rng(3)
    cols = []
    for ch in range(4):
        c = rng.uniform(0, 1, (256, 4)).astype(np.float32)
        c[:, ch] = levels * np.float32(1.0 / 255.0)
        cols.append(c)
    cols.append(rng.uniform(-0.5, 1.5, (512, 4)).astype(np.float32))
    cols = np.concatenate(cols)
    pj = np.asarray(shade_j.pack_rgba_u32(jnp.asarray(cols)))
    pt = shade_t.pack_rgba_u32(torch.from_numpy(cols))
    np.testing.assert_array_equal(pt.numpy().astype(np.uint32), pj)
    uj = np.asarray(shade_j.unpack_rgba_u32(jnp.asarray(pj)))
    ut = shade_t.unpack_rgba_u32(pt).numpy()
    np.testing.assert_array_equal(ut.view(np.uint32), uj.view(np.uint32))
    # every level round-trips through the u8 conversion
    np.testing.assert_array_equal(
        (np.clip(ut, 0, 1) * 255.0).astype(np.uint8),
        (np.clip(cols, 0, 1) * 255.0).astype(np.uint8))


@pytest.mark.parametrize("use_order", [False, True], ids=["no_order", "order"])
@pytest.mark.parametrize("within", [None, 700], ids=["full", "within"])
def test_sort_pack_leaves_permutation_matches(use_order, within):
    rng = np.random.default_rng(11)
    n = 1000
    mask = rng.uniform(size=n) < 0.4
    if within is not None:
        mask[within:] = False  # the caller's within contract
    order = rng.integers(-3, 255, n).astype(np.int32) if use_order else None
    pos = np.arange(n, dtype=np.int32)
    t = rng.uniform(size=n).astype(np.float32)
    oj = None if order is None else jnp.asarray(order)
    ot = None if order is None else torch.from_numpy(order)
    pj, tj = comp_j.sort_pack_leaves(jnp.asarray(mask), (jnp.asarray(pos), jnp.asarray(t)),
                                     within=within, order=oj)
    pt, tt = comp_t.sort_pack_leaves(torch.from_numpy(mask), (torch.from_numpy(pos),
                                     torch.from_numpy(t)), within=within, order=ot)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    # the restore sort inverts it
    (back,) = comp_t.sort_restore_leaves(pt, (tt,))
    np.testing.assert_array_equal(back.numpy(), t)


def test_sort_pack_keeps_order_above_254():
    """int64 keys keep order keys above 254 distinct (the JAX package clips
    them to 254, ROADMAP queue 1 note)."""
    mask = torch.tensor([True, True, True, False])
    order = torch.tensor([300, 260, 254, 0], dtype=torch.int32)
    (pos,) = comp_t.sort_pack_leaves(mask, (torch.arange(4),), order=order)
    assert pos.tolist() == [2, 1, 0, 3]


def test_compact_indices_and_scatter_state_match():
    rng = np.random.default_rng(5)
    mask = rng.uniform(size=500) < 0.3
    for cap in (64, 256):
        ij, vj = comp_j.compact_indices(jnp.asarray(mask), cap)
        it, vt = comp_t.compact_indices(torch.from_numpy(mask), cap)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_array_equal(it.numpy()[vt.numpy()], np.asarray(ij)[np.asarray(vj)])
        full = rng.uniform(size=500).astype(np.float32)
        comp = rng.uniform(size=cap).astype(np.float32)
        (sj,) = comp_j.scatter_state((jnp.asarray(full),), (jnp.asarray(comp),), ij, vj)
        (st,) = comp_t.scatter_state((torch.from_numpy(full),), (torch.from_numpy(comp),), it, vt)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert comp_t.capacity_bucket_of(5000, 2 ** 20, 2048) == comp_j.capacity_bucket_of(
        5000, 2 ** 20, 2048)


@pytest.mark.parametrize("mode", ["autodiff", "tetrahedron"])
def test_normals_match(mode):
    pj, pt = cj.load(H5), ct.load(H5, device="cpu")
    cfg = cj.RenderConfig()
    pts = np.random.default_rng(2).uniform(-0.8, 0.8, (2048, 3)).astype(np.float32)
    fj = rend_j.shade_fn(pj, cfg, 0.0)
    ft = rend_t.shade_fn(pt, ct.RenderConfig(), 0.0)
    if mode == "autodiff":
        nj = shade_j.autodiff_normals(fj, jnp.asarray(pts))
        nt = shade_t.autodiff_normals(ft, torch.from_numpy(pts))
    else:
        nj = shade_j.tetrahedron_normals(fj, jnp.asarray(pts), 1e-2)
        nt = shade_t.tetrahedron_normals(ft, torch.from_numpy(pts), 1e-2)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-4)


def test_autodiff_normals_under_no_grad_and_sphere():
    """Shading enables grad itself, and the analytic sphere's normal is the
    radial direction."""
    f = ct.sdf.make_scene("sphere")
    p = torch.tensor([[0.0, 0.0, 0.9], [0.9, 0.0, 0.0]])
    with torch.no_grad():
        n = shade_t.autodiff_normals(f, p)
    np.testing.assert_allclose(n.numpy(), [[0, 0, 1], [1, 0, 0]], atol=1e-6)


def test_matcap_and_facing_colors_match():
    rng = np.random.default_rng(9)
    n = rng.normal(size=(500, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    w2c = np.array(cam_j.view_matrices(cj.Camera(rotation_y=40.0))[1])
    tex = rng.uniform(size=(16, 24, 3)).astype(np.float32)
    mj = shade_j.matcap_color(jnp.asarray(n), jnp.asarray(w2c), jnp.asarray(tex))
    mt = shade_t.matcap_color(torch.from_numpy(n), torch.from_numpy(w2c), torch.from_numpy(tex))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    fj = shade_j.facing_color(jnp.asarray(n), jnp.asarray(d))
    ft = shade_t.facing_color(torch.from_numpy(n), torch.from_numpy(d))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-6)


def test_unported_scenes_raise():
    """Every scene of the registry composes now; an unknown name, or a
    neural scene without a neural field, raises."""
    p = torch.zeros((5, 3))
    from cudaneuralrender_torch.utils.config import SCENE_NAMES

    for name in sorted(SCENE_NAMES):
        assert ct.sdf.make_scene(name, lambda q: q[..., 0])(p).shape == (5,)
    with pytest.raises(ValueError, match="unknown scene"):
        ct.sdf.make_scene("many_cubes", lambda q: q[..., 0])
    with pytest.raises(ValueError, match="requires a neural SDF"):
        ct.sdf.make_scene("many_sphere")

