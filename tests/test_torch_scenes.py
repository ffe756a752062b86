"""CSG scenes and the march kernel's scene compose against the JAX package.

Inputs are made with numpy from fixed seeds and fed to both packages; the
JAX side runs compiled (``jax.jit``), as its renderer does. Float32 results
cannot be bit-equal here: XLA:CPU contracts multiply-adds into FMAs and its
tanh, sqrt and sin round differently from PyTorch's CPU ones, so a value
may sit a few ulps away. Tolerances:
  * ops/sdf.py primitives, operators and scenes on 4096 points in
    [-1.2, 1.2]^3 with the csg_demo neural field: 1e-5;
  * kernels/scenes.compose_fn on the same raw distances: 1e-6 (the bar of
    tests/test_pallas.py:222-226), and against the dense scene wherever
    the grid window is exact (its band);
  * march_state_plain against ``march_pallas_state`` in Pallas interpret
    mode at 32x32 for the staged renderer's coarse call (with
    ``cyl_window_coarse``), refine rung 0 and terminal rung: converged
    flags agree on >99%, t within 1e-4 where both converged, resolve steps
    equal on >=99%, equal step counters (the bar of
    tests/test_torch_megakernel.py);
  * fit_bound_sphere: center and radius within one probe cell (2.4/47).
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import cudaneuralrender_torch as ct  # noqa: E402
import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch.kernels import build as build_t  # noqa: E402
from cudaneuralrender_torch.kernels import megakernel as mk_t  # noqa: E402
from cudaneuralrender_torch.kernels import scenes as ks_t  # noqa: E402
from cudaneuralrender_torch.ops import march as march_t  # noqa: E402
from cudaneuralrender_torch.ops import sdf as sdf_t  # noqa: E402
from cudaneuralrender_torch.render import renderer as rend_t  # noqa: E402
from cudaneuralrender_tpu.ops import camera as cam_j  # noqa: E402
from cudaneuralrender_tpu.ops import march as march_j  # noqa: E402
from cudaneuralrender_tpu.ops import sdf as sdf_j  # noqa: E402
from cudaneuralrender_tpu.pallas import megakernel as mk_j  # noqa: E402
from cudaneuralrender_tpu.pallas import scenes as ks_j  # noqa: E402
from cudaneuralrender_tpu.render import renderer as rend_j  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "examples", "assets")
CSG = os.path.join(ASSETS, "csg_demo.h5")
ANIM = os.path.join(ASSETS, "anim_demo.h5")
FRAMES = (0.0, 17.0, 90.0, 359.0)
RES = 32


@pytest.fixture(scope="module")
def csg():
    return cj.load(CSG), ct.load(CSG, device="cpu")


@pytest.fixture(scope="module")
def points():
    return np.random.default_rng(7).uniform(-1.2, 1.2, (4096, 3)).astype(np.float32)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


# name -> call on a module (JAX's or the port's ops/sdf), points p and a
# distance row d
PRIMITIVES = {
    "sphere": (lambda m, p, d: m.sphere(p, 0.4)),
    "sphere_center": (lambda m, p, d: m.sphere(p, 0.3, center=(0.1, -0.2, 0.3))),
    "box": (lambda m, p, d: m.box(p, (0.3, 0.5, 0.2))),
    "box_round": (lambda m, p, d: m.box(p, (0.3, 0.5, 0.2), round_radius=0.05)),
    "plane": (lambda m, p, d: m.plane(p)),
    "cylinder": (lambda m, p, d: m.cylinder(p, (0.1, 0.25, -0.3))),
    "displace": (lambda m, p, d: m.displace(p, d)),
    "round_op": (lambda m, p, d: m.round_op(d, 0.1)),
    "onion": (lambda m, p, d: m.onion(d, 0.05)),
    "intersect": (lambda m, p, d: m.intersect(d, m.sphere(p, 0.5))),
    "union": (lambda m, p, d: m.union(d, m.sphere(p, 0.5))),
    "subtract": (lambda m, p, d: m.subtract(d, m.sphere(p, 0.5))),
    "smooth_subtract": (lambda m, p, d: m.smooth_subtract(d, m.sphere(p, 0.5), 0.1)),
    "smooth_union": (lambda m, p, d: m.smooth_union(d, m.sphere(p, 0.5), 0.1)),
}


@pytest.mark.parametrize("name", list(PRIMITIVES))
def test_sdf_primitives_and_operators_match(points, name):
    fn = PRIMITIVES[name]
    d = np.random.default_rng(8).uniform(-0.5, 0.5, len(points)).astype(np.float32)
    a = jax.jit(lambda p, dd: fn(sdf_j, p, dd))(jnp.asarray(points), jnp.asarray(d))
    b = fn(sdf_t, torch.from_numpy(points), torch.from_numpy(d))
    _close(b.numpy(), a, 1e-5)


# (scene, cyl_window) for make_scene; None keeps the full 300-term chain
DENSE_SCENES = [("neural_raw", None), ("neural_tanh", None), ("many_sphere", None),
                ("many_sphere_cut", None), ("many_cylinder_cut", None),
                ("many_cylinder_cut", 1), ("many_cylinder_cut", 3),
                ("many_cylinder_cut", 5), ("displacement", None), ("sphere", None)]


@pytest.mark.parametrize("scene,window", DENSE_SCENES,
                         ids=[f"{s}-w{w}" for s, w in DENSE_SCENES])
def test_make_scene_matches_jax(csg, points, scene, window):
    pj, pt = csg
    fn_j = jax.jit(lambda p, f: sdf_j.make_scene(
        scene, rend_j.neural_sdf_fn(pj, f), f, window)(p))
    for frame in FRAMES:
        dj = fn_j(jnp.asarray(points), jnp.float32(frame))
        ft = sdf_t.make_scene(scene, rend_t.neural_sdf_fn(pt, frame), frame, window)
        with torch.no_grad():
            dt = ft(torch.from_numpy(points))
        _close(dt.numpy(), dj, 1e-5)


KERNEL_COMPOSES = [("neural_raw", 5), ("neural_tanh", 5), ("many_sphere", 5),
                   ("many_sphere_cut", 5), ("displacement", 5),
                   ("many_cylinder_cut", 1), ("many_cylinder_cut", 3),
                   ("many_cylinder_cut", 5)]
# The window reproduces the full chain wherever the scene distance exceeds
# its band: omitted cylinders sit >= 0.03 (window 1), ~0.11 (3) or ~0.21
# (5) away, and smooth_subtract with k=0.01 is the identity there.
BAND = {1: -0.02, 3: -0.1, 5: -0.2}


@pytest.fixture(scope="module")
def raw_d(csg, points):
    pj, _ = csg
    return np.array(jax.jit(lambda p: cj.mlp.apply_scalar(pj, p))(jnp.asarray(points)))


@pytest.mark.parametrize("scene,window", KERNEL_COMPOSES,
                         ids=[f"{s}-w{w}" for s, w in KERNEL_COMPOSES])
def test_compose_fn_matches_jax_and_dense(points, raw_d, scene, window):
    pts_t, d_t = torch.from_numpy(points), torch.from_numpy(raw_d)
    cj_fn = jax.jit(lambda p, d, f: ks_j.compose_fn(scene, window)(p, d, f))
    for frame in FRAMES:
        want = np.asarray(cj_fn(jnp.asarray(points.T), jnp.asarray(raw_d[None]),
                                jnp.float32(frame)))[0]
        got = ks_t.compose_fn(scene, window)(pts_t, d_t, frame).numpy()
        _close(got, want, 1e-6)
        # against the port's dense scene (the full chain) on the same raw
        # distances, inside the band
        dense = sdf_t.make_scene(scene, lambda p: d_t, frame)(pts_t).numpy()
        band = dense > BAND[window] if scene == "many_cylinder_cut" else np.ones_like(dense, bool)
        assert band.sum() > 1000
        _close(got[band], dense[band], 1e-6)


# ---------------------------------------------------------------------------
# The march kernel's plain version per scene, against the JAX megakernel
# ---------------------------------------------------------------------------

CFG_J = cj.RenderConfig(width=RES, height=RES)
# name -> (march_eps, num_steps, relax_omega, cyl_window override)
VARIANTS = {
    "coarse": (0.05, None, 1.6, CFG_J.cyl_window_coarse),
    "rung0": (1e-6, 16, 0.0, None),
    "terminal": (1e-6, None, 1.6, None),
}
# (scene, frame, asset, num_inputs)
MARCH_CASES = {
    "neural_tanh": ("neural_tanh", 0.0, CSG, 3),
    "many_sphere": ("many_sphere", 90.0, CSG, 3),
    "many_sphere_cut": ("many_sphere_cut", 90.0, CSG, 3),
    "many_cylinder_cut": ("many_cylinder_cut", 0.0, CSG, 3),
    "displacement": ("displacement", 0.0, CSG, 3),
    "anim_many_sphere": ("many_sphere", 37.0, ANIM, 4),
}


def _state_np(s):
    return {k: np.array(getattr(s, k)) for k in ("t", "budget", "active", "converged", "steps")}


def _refine_entry(s, origin, dirs):
    near = s["converged"] | s["active"]
    tnear, tfar, bhit = (np.asarray(a) for a in march_j.intersect_sphere(
        jnp.asarray(origin), jnp.asarray(dirs), CFG_J.bound_center, CFG_J.bound_radius))
    budget = np.where(bhit, tfar - (s["t"] - np.maximum(tnear, 0.0)), 0.0).astype(np.float32)
    return dict(t=s["t"], budget=budget, active=near, converged=np.zeros_like(near),
                steps=s["steps"])


@pytest.fixture(scope="module", params=list(MARCH_CASES))
def scene_chain(request):
    """Both packages' outputs for the three calls of one scene, each call
    starting from the JAX package's output of the one before."""
    scene, frame, asset, n_in = MARCH_CASES[request.param]
    pj, pt = cj.load(asset), ct.load(asset, device="cpu")
    cfg_j = CFG_J.replace(scene=scene, num_inputs=n_in)
    cfg_t = ct.RenderConfig(width=RES, height=RES, scene=scene, num_inputs=n_in)
    c2w, _ = cam_j.view_matrices(cj.Camera(rotation_y=30.0, rotation_x=-20.0))
    origin, dirs = (np.array(a) for a in cam_j.generate_rays(c2w, RES, RES, CFG_J.focal))
    s = _state_np(march_j.init_state(jnp.asarray(origin), jnp.asarray(dirs),
                                     CFG_J.bound_center, CFG_J.bound_radius))
    out = {}
    for variant, (eps, num_steps, omega, window) in VARIANTS.items():
        if variant == "rung0":
            s = _refine_entry(s, origin, dirs)
        prec = jax.lax.Precision.DEFAULT if variant == "coarse" else jax.lax.Precision.HIGHEST
        sj_in = march_j.MarchState(
            t=jnp.asarray(s["t"]), budget=jnp.asarray(s["budget"]),
            active=jnp.asarray(s["active"]), converged=jnp.asarray(s["converged"]),
            steps=jnp.asarray(s["steps"], jnp.int32))
        jo, jr = mk_j.march_pallas_state(
            pj, jnp.asarray(origin), jnp.asarray(dirs), sj_in, cfg_j, jnp.float32(frame),
            tile=dirs.shape[0], interpret=True, march_eps=eps, precision=prec,
            num_steps=num_steps, relax_omega=omega, return_resolve=True, cyl_window=window)
        st_in = march_t.MarchState(
            t=torch.tensor(s["t"]), budget=torch.tensor(s["budget"]),
            active=torch.tensor(s["active"]), converged=torch.tensor(s["converged"]),
            steps=torch.tensor(int(s["steps"]), dtype=torch.int32))
        to, tr = mk_t.march_state(
            pt, torch.tensor(origin), torch.tensor(dirs), st_in, cfg_t, frame,
            march_eps=eps, num_steps=num_steps, relax_omega=omega, return_resolve=True,
            cyl_window=window)
        out[variant] = (s, (_state_np(jo), np.asarray(jr).astype(np.int64)),
                        (_state_np(to), tr.numpy().astype(np.int64)))
        s = out[variant][1][0]
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_march_state_plain_matches_jax_per_scene(scene_chain, variant):
    entry, (sj, rj), (st, rt) = scene_chain[variant]
    assert entry["active"].sum() > 50  # the call has work to do
    assert (sj["converged"] == st["converged"]).mean() > 0.99
    both = sj["converged"] & st["converged"]
    assert both.sum() > 0
    np.testing.assert_allclose(st["t"][both], sj["t"][both], rtol=0, atol=1e-4)
    assert int(st["steps"]) == int(sj["steps"])
    assert (st["active"] == sj["active"]).mean() > 0.99
    assert (rt == rj).mean() >= 0.99, (rt != rj).sum()


def test_fit_bound_sphere_matches_jax(csg):
    pj, pt = csg
    cfg = cj.RenderConfig(scene="neural_raw")
    cell = 2.4 / 47
    cj_, rj = cj.fit_bound_sphere(rend_j.scene_fn(pj, cfg, 0.0), cfg.bound_center,
                                  cfg.bound_radius)
    ct_, rt = ct.fit_bound_sphere(rend_t.scene_fn(pt, ct.RenderConfig(), 0.0),
                                  cfg.bound_center, cfg.bound_radius)
    assert np.abs(np.subtract(ct_, cj_)).max() <= cell
    assert abs(rt - rj) <= cell
    # the analytic sphere shrinks the bound, in both packages alike
    cs, rs = ct.fit_bound_sphere(sdf_t.make_scene("sphere"), (0.0, 0.0, 0.0), 1.2)
    assert np.linalg.norm(cs) < 0.1 and 0.9 < rs < 1.2


def test_unknown_scene_id_rejected_before_launch(monkeypatch):
    """The CUDA wrapper maps the scene and window to the kernel's ids
    before it loads the library: a scene or window without an
    instantiation raises, and nothing is built or launched."""
    def no_library():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(build_t, "load_library", no_library)
    pt = ct.load(CSG, device="cpu")
    n = 4
    state = march_t.MarchState(
        t=torch.zeros(n), budget=torch.ones(n), active=torch.ones(n, dtype=torch.bool),
        converged=torch.zeros(n, dtype=torch.bool), steps=torch.zeros((), dtype=torch.int32))
    dirs = torch.tensor([[0.0, 0.0, 1.0]] * n)
    for cfg, window in ((ct.RenderConfig(scene="sphere"), None),
                        (ct.RenderConfig(scene="many_cylinder_cut"), 2),
                        (ct.RenderConfig(scene="neural_raw"), 4)):
        with pytest.raises(ValueError, match="scene|cyl_window"):
            mk_t._march_state_cuda(pt, torch.zeros(3), dirs, state, cfg, 0.0, None, None,
                                   0.0, False, window)
    launches = mk_t.KERNEL_LAUNCHES
    assert mk_t.kernel_scene(ct.RenderConfig(scene="many_cylinder_cut"), 1) == (4, 1)
    assert mk_t.KERNEL_LAUNCHES == launches
    assert set(mk_t.SCENE_LAUNCHES) == ks_t.KERNEL_SCENES


def test_kernel_source_constants_match_tables():
    """The CUDA compose's constants (it cannot run here) against the
    tables and float32 arithmetic of the plain version: the sphere centers,
    the reciprocals of the constant divisors, and the z step per frame."""
    src = open(os.path.join(REPO, "cudaneuralrender_torch", "csrc", "march.cuh")).read()

    def floats(name):
        body = re.search(r"const float %s\[3\] = \{([^}]*)\}" % name, src).group(1)
        return np.array([np.float32(v.strip().rstrip("f")) for v in body.split(",")])

    centers = sdf_t._MANY_SPHERE_CENTERS
    np.testing.assert_array_equal(floats("cx"), centers[:3, 0])
    np.testing.assert_array_equal(floats("cy"), centers[::3, 1])

    def const(name):
        return re.search(r"constexpr float %s = ([^;]*);" % name, src).group(1)

    assert np.float32(const("kInvSmoothK").rstrip("f")) == sdf_t._recip(0.01)
    assert np.float32(const("kInvCell").rstrip("f")) == sdf_t._recip(0.1)
    assert "2.0 * 0.7 / 360.0" in const("kSphereZStep")
    # the z offset: one float32 multiply, then one float32 add (op by op)
    for frame in FRAMES + (1.0, 2.0, 37.0):
        want = -0.7 + jnp.float32(frame) * (2.0 * 0.7 / 360.0)
        assert sdf_t.many_sphere_z(frame) == float(want)
