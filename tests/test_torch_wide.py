"""SDF networks 64-256 wide: the port against the JAX package on the CPU.

Nets: csg_demo widened k = 2, 4, 8 times by ``chip_smoke.widen`` (the same
function, 3->32k x8->1, copies with distinct weights in permuted
positions), anim_demo widened (the 4-input net), and random nets from the
JAX package's ``init_mlp`` at the sizes of tests/test_pallas.py:290-321.
Weights are carried across as numpy arrays; points and rays are made from
fixed seeds. The JAX side runs its Pallas kernels in interpret mode, as its
own tests do; this package runs the kernels' plain versions (CPU tensors).
Tolerances, each the JAX package's own bar:
  * the fused forward (K3): atol 1e-5 (test_pallas.py:295-308);
  * the march (K1): converged flags agree on >99%, t within 1e-4 where both
    converged, resolve steps equal on >=99%, equal step counters
    (test_pallas.py:49-72);
  * dense ``render_image`` with use_pallas: atol 1e-5 (test_pallas.py:311-321);
  * ``render_staged``: hits agree on >=99%, >=97% of common hits within
    1e-3 (test_render.py:85-101).
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
from cudaneuralrender_torch.kernels import build  # noqa: E402
from cudaneuralrender_torch.kernels import fused_mlp as fused_t  # noqa: E402
from cudaneuralrender_torch.kernels import megakernel as mk_t  # noqa: E402
from cudaneuralrender_torch.ops import march as march_t  # noqa: E402
from cudaneuralrender_tpu.ops import camera as cam_j  # noqa: E402
from cudaneuralrender_tpu.ops import march as march_j  # noqa: E402
from cudaneuralrender_tpu.pallas import fused_mlp as fused_j  # noqa: E402
from cudaneuralrender_tpu.pallas import megakernel as mk_j  # noqa: E402

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples", "assets")
CSG = os.path.join(ASSETS, "csg_demo.npz")
ANIM = os.path.join(ASSETS, "anim_demo.npz")
CAM = dict(rotation_y=30.0, rotation_x=-20.0)


def _layers(path):
    with np.load(path) as data:
        return [(data[f"w{i}"], data[f"b{i}"]) for i in range(len(data.files) // 2)]


def _both(layers):
    """(JAX params, torch params on the CPU) from (w, b) arrays."""
    pj = tuple(cj.mlp.DenseParams(jnp.asarray(w), jnp.asarray(b)) for w, b in layers)
    return pj, ct.from_numpy_params(layers, device="cpu")


def _init_jax(seed, sizes):
    pj = cj.init_mlp(jax.random.key(seed), sizes=sizes)
    return _both([(np.asarray(l.w), np.asarray(l.b)) for l in pj])


@pytest.mark.parametrize("k", [2, 4, 8])
def test_widen_is_exact(k):
    """The widened csg_demo is csg_demo's function: 4096 seeded points
    within 1e-5 (float32 sums over k times as many terms)."""
    layers = _layers(CSG)
    wide = chip_smoke.widen(layers, k, seed=k)
    assert ct.mlp.layer_sizes(ct.from_numpy_params(wide, device="cpu")) == (
        (3,) + (32 * k,) * 8 + (1,))
    pts = torch.from_numpy(np.random.default_rng(5).uniform(-1.2, 1.2, (4096, 3))
                           .astype(np.float32))
    want = ct.mlp.apply_scalar(ct.from_numpy_params(layers, device="cpu"), pts)
    got = ct.mlp.apply_scalar(ct.from_numpy_params(wide, device="cpu"), pts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    # no two copies of a unit share a weight: the first layer's columns differ
    assert np.unique(wide[0][0], axis=1).shape[1] == wide[0][0].shape[1]


def test_padded_width():
    assert [fused_t.padded_width(h) for h in (1, 32, 33, 64, 100, 128, 129, 256)] == [
        32, 32, 64, 64, 128, 128, 256, 256]
    with pytest.raises(ValueError, match="ROADMAP section 2"):
        fused_t.padded_width(257)


@pytest.mark.parametrize("sizes", [(3, 64, 64, 64, 1), (3, 128, 128, 1), (3, 256, 256, 1)],
                         ids=["64", "128", "256"])
def test_mlp_forward_plain_matches_jax(sizes):
    pj, pt = _init_jax(0, sizes)
    wj, bj, n_in_j, h_j = fused_j.pack_params(pj)
    w, b, n_in, h = fused_t.pack_params(pt)
    assert (n_in, h) == (n_in_j, h_j) == (3, max(sizes))
    np.testing.assert_array_equal(w.numpy(), np.asarray(wj))
    pts = np.random.default_rng(1).uniform(-1, 1, (4096, 3)).astype(np.float32)
    want = np.asarray(fused_j.mlp_forward_pallas(wj, bj, jnp.asarray(pts), interpret=True))
    launches = fused_t.MLP_LAUNCHES
    got = fused_t.mlp_forward(w, b, torch.from_numpy(pts)).numpy()
    assert fused_t.MLP_LAUNCHES == launches  # CPU tensors never reach the kernel
    assert got.shape == (4096,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("asset,k,frame", [(CSG, 2, 0.0), (ANIM, 4, 37.0)],
                         ids=["csg_demo_x2", "anim_demo_x4"])
def test_neural_sdf_fn_kernel_matches_jax(asset, k, frame):
    layers = chip_smoke.widen(_layers(asset), k, seed=1)
    pj, pt = _both(layers)
    n_in = layers[0][0].shape[0]
    pts = np.random.default_rng(2).uniform(-1, 1, (2, 300, 3)).astype(np.float32)
    want = np.asarray(fused_j.neural_sdf_fn_pallas(pj, frame, n_in, interpret=True)(
        jnp.asarray(pts)))
    got = fused_t.neural_sdf_fn_kernel(pt, frame, n_in)(torch.from_numpy(pts)).numpy()
    assert got.shape == (2, 300)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# name -> (march_eps, num_steps, relax_omega)
VARIANTS = {"coarse": (0.05, None, 1.6), "rung0": (1e-6, 16, 0.0), "terminal": (1e-6, None, 1.6)}
MARCH_NETS = {"random_128": 16, "csg_demo_x2": 32}  # name -> image side


def _net(name):
    if name == "random_128":
        return _init_jax(2, (3, 128, 128, 1))
    return _both(chip_smoke.widen(_layers(CSG), 2, seed=3))


def _state_np(s):
    return {k: np.array(getattr(s, k)) for k in ("t", "budget", "active", "converged", "steps")}


@pytest.fixture(scope="module", params=list(MARCH_NETS))
def wide_chain(request):
    """Both packages' outputs for the staged renderer's three kinds of
    march call, each starting from the JAX package's output of the one
    before (the refine entry re-marks the near set active)."""
    res = MARCH_NETS[request.param]
    pj, pt = _net(request.param)
    cfg_j = cj.RenderConfig(width=res, height=res)
    cfg_t = ct.RenderConfig(width=res, height=res)
    c2w, _ = cam_j.view_matrices(cj.Camera(**CAM))
    origin, dirs = (np.array(a) for a in cam_j.generate_rays(c2w, res, res, cfg_j.focal))
    s = _state_np(march_j.init_state(jnp.asarray(origin), jnp.asarray(dirs),
                                     cfg_j.bound_center, cfg_j.bound_radius))
    out = {}
    for variant, (eps, num_steps, omega) in VARIANTS.items():
        if variant == "rung0":
            near = s["converged"] | s["active"]
            tnear, tfar, bhit = (np.asarray(a) for a in march_j.intersect_sphere(
                jnp.asarray(origin), jnp.asarray(dirs), cfg_j.bound_center, cfg_j.bound_radius))
            s = dict(t=s["t"], active=near, converged=np.zeros_like(near), steps=s["steps"],
                     budget=np.where(bhit, tfar - (s["t"] - np.maximum(tnear, 0.0)), 0.0)
                     .astype(np.float32))
        prec = jax.lax.Precision.DEFAULT if variant == "coarse" else jax.lax.Precision.HIGHEST
        jo, jr = mk_j.march_pallas_state(
            pj, jnp.asarray(origin), jnp.asarray(dirs),
            march_j.MarchState(**{k: jnp.asarray(v) for k, v in s.items()}), cfg_j,
            tile=dirs.shape[0], interpret=True, march_eps=eps, precision=prec,
            num_steps=num_steps, relax_omega=omega, return_resolve=True)
        state_t = march_t.MarchState(
            t=torch.tensor(s["t"]), budget=torch.tensor(s["budget"]),
            active=torch.tensor(s["active"]), converged=torch.tensor(s["converged"]),
            steps=torch.tensor(int(s["steps"]), dtype=torch.int32))
        to, tr = mk_t.march_state(pt, torch.tensor(origin), torch.tensor(dirs), state_t, cfg_t,
                                  march_eps=eps, num_steps=num_steps, relax_omega=omega,
                                  return_resolve=True)
        out[variant] = (s, (_state_np(jo), np.asarray(jr).astype(np.int64)),
                        (_state_np(to), tr.numpy().astype(np.int64)))
        s = out[variant][1][0]
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_march_state_plain_matches_jax_wide(wide_chain, variant):
    entry, (sj, rj), (st, rt) = wide_chain[variant]
    assert entry["active"].sum() > 20  # the call has work to do
    assert (sj["converged"] == st["converged"]).mean() > 0.99
    both = sj["converged"] & st["converged"]
    assert both.sum() > 0
    np.testing.assert_allclose(st["t"][both], sj["t"][both], rtol=0, atol=1e-4)
    assert int(st["steps"]) == int(sj["steps"])
    assert (st["active"] == sj["active"]).mean() > 0.99
    assert (rt == rj).mean() >= 0.99, (rt != rj).sum()


def test_render_image_use_pallas_matches_jax():
    """Dense render of a 128-wide random net with use_pallas, both packages
    (the JAX twin of test_pallas.py:311-321 evaluates through K3 here)."""
    pj, pt = _init_jax(2, (3, 128, 128, 1))
    kw = dict(width=16, height=16, scene="neural_raw", max_steps=64, use_pallas=True)
    want = np.asarray(cj.render_image(pj, cj.Camera(), cj.RenderConfig(**kw)))
    got = ct.render_image(pt, ct.Camera(), ct.RenderConfig(**kw)).numpy()
    assert (want[..., 3] > 0).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_render_staged_widened_matches_jax():
    pj, pt = _both(chip_smoke.widen(_layers(CSG), 2, seed=4))
    kw = dict(width=32, height=32, scene="neural_raw", march_impl="staged", rgba_packed=False)
    cj.reset_schedule_memo()
    ct.reset_schedule_memo()
    a = np.asarray(cj.render_staged(pj, cj.Camera(**CAM), cj.RenderConfig(**kw)))
    b = ct.render_staged(pt, ct.Camera(**CAM), ct.RenderConfig(**kw)).numpy()
    hit_a, hit_b = a[..., 3] > 0, b[..., 3] > 0
    assert (hit_a == hit_b).mean() >= 0.99
    both = hit_a & hit_b
    assert both.sum() > 50
    assert np.all(np.abs(b[both] - a[both]) < 1e-3, axis=-1).mean() >= 0.97


def test_width_above_256_raises_before_any_library_load(monkeypatch):
    def no_load():
        raise AssertionError("the library must not be loaded")

    monkeypatch.setattr(build, "load_library", no_load)
    pt = ct.from_numpy_params(
        [(np.ones((3, 300), np.float32), np.zeros(300, np.float32)),
         (np.ones((300, 1), np.float32), np.zeros(1, np.float32))], device="cpu")
    cfg = ct.RenderConfig(width=4, height=4)
    dirs = torch.ones((4, 3))
    state = march_t.init_state(torch.zeros(3), dirs, cfg.bound_center, cfg.bound_radius)
    with pytest.raises(ValueError, match="ROADMAP section 2"):
        mk_t._march_state_cuda(pt, torch.zeros(3), dirs, state, cfg, 0.0, None, None, 0.0,
                               False, None)
    with pytest.raises(ValueError, match="ROADMAP section 2"):
        fused_t.neural_sdf_fn_kernel(pt)
    with pytest.raises(ValueError, match="ROADMAP section 2"):
        mk_t.march_state(pt, torch.zeros(3), dirs, state, cfg)
