"""The precision ladder and the cold-start kernel: the port against the JAX
package on the CPU.

Weights: csg_demo (the shipped 3->32x8->1 architecture), csg_demo widened by
``chip_smoke.widen`` to 64/128/256, and a 256-wide ``init_mlp`` stack;
points and rays from fixed seeds and Camera(rotation_y=30, rotation_x=-20).
The JAX side runs its Pallas kernels in interpret mode, as its own tests
do; this package runs the kernels' plain versions (CPU tensors). Bars:
  * ``split_hi_lo`` bit for bit;
  * the three-pass chain K2h (``mlp_chain_3pass_plain`` against
    ``_mlp_chain_3pass``) bit for bit on csg_demo, where every product of
    two bfloat16 values is exact in float32 and both sum in input order;
    atol 1e-5 on the wide nets (the JAX bar of tests/test_pallas.py:308);
  * the march at precision HIGH, and the raygen march K5 at DEFAULT and
    HIGH: the kernel bar of tests/test_pallas.py:49-72 (converged flags
    agree on >99%, t within 1e-4 where both converged, resolve steps
    equal on >=99%, equal step counters);
  * the secant-adaptive (Newton) relaxed stage: converged flags agree on
    >=99.9%, t within 1e-4 where both converged;
  * ``render_staged`` under the opt-in options at 64x64 (so that every
    refine rung's bucket, 2048 lanes, is smaller than the image and the
    rungs take the kernel): the mixed bar of tests/test_render.py:85-101
    (hits agree on >=99%, >=97% of common hits within 1e-3), the same
    fast-path verdict and hit counts within 1%.
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
from cudaneuralrender_torch.kernels import megakernel as mk_t  # noqa: E402
from cudaneuralrender_torch.ops import march as march_t  # noqa: E402
from cudaneuralrender_torch.render import renderer as renderer_t  # noqa: E402
from cudaneuralrender_tpu.ops import camera as cam_j  # noqa: E402
from cudaneuralrender_tpu.ops import march as march_j  # noqa: E402
from cudaneuralrender_tpu.pallas import fused_mlp as fused_j  # noqa: E402
from cudaneuralrender_tpu.pallas import megakernel as mk_j  # noqa: E402
from cudaneuralrender_tpu.render import renderer as renderer_j  # noqa: E402

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples", "assets")
CSG = os.path.join(ASSETS, "csg_demo.npz")
CAM = dict(rotation_y=30.0, rotation_x=-20.0)
HIGH = jax.lax.Precision.HIGH


def _layers(path):
    with np.load(path) as data:
        return [(data[f"w{i}"], data[f"b{i}"]) for i in range(len(data.files) // 2)]


def _both(layers):
    """(JAX params, torch params on the CPU) from (w, b) arrays."""
    pj = tuple(cj.mlp.DenseParams(jnp.asarray(w), jnp.asarray(b)) for w, b in layers)
    return pj, ct.from_numpy_params(layers, device="cpu")


def _net(name):
    """csg_demo, csg_demo widened k times ("x{k}"), or a random 256-wide
    ``init_mlp`` stack ("init_256")."""
    if name == "init_256":
        pj = cj.init_mlp(jax.random.key(7), sizes=(3, 256, 256, 256, 1))
        return _both([(np.asarray(l.w), np.asarray(l.b)) for l in pj])
    if name == "csg_demo":
        return _both(_layers(CSG))
    return _both(chip_smoke.widen(_layers(CSG), int(name[1:]), seed=int(name[1:])))


def _bits(x) -> np.ndarray:
    """The raw 16 bits of a bfloat16 array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


@pytest.mark.parametrize("net", ["csg_demo", "init_256"])
def test_split_hi_lo_matches_jax(net):
    pj, pt = _net(net)
    wj = fused_j.pack_params(pj)[0]
    wt = fused_t.pack_params(pt)[0]
    hi_j, lo_j = fused_j.split_hi_lo(wj)
    hi_t, lo_t = fused_t.split_hi_lo(wt)
    assert hi_t.dtype == lo_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(hi_t), _bits(hi_j))
    np.testing.assert_array_equal(_bits(lo_t), _bits(lo_j))
    # the packed module caches the same split
    np.testing.assert_array_equal(_bits(fused_t.packed_hi_lo(pt)[1]), _bits(lo_j))
    assert np.abs(lo_t.float().numpy()).max() > 0


@pytest.mark.parametrize("net,atol", [("csg_demo", 0.0), ("x2", 1e-5), ("x4", 1e-5),
                                      ("x8", 1e-5)], ids=["csg_demo", "x2", "x4", "x8"])
def test_mlp_chain_3pass_plain_matches_jax(net, atol):
    pj, pt = _net(net)
    wj, bj, _, h = fused_j.pack_params(pj)
    w, b, _, h_t = fused_t.pack_params(pt)
    assert h == h_t
    pts = np.random.default_rng(3).uniform(-1, 1, (4096, 3)).astype(np.float32)
    x = np.zeros((4096, h), np.float32)
    x[:, :3] = pts
    hi_j, lo_j = fused_j.split_hi_lo(wj)
    want = np.asarray(fused_j._mlp_chain_3pass(hi_j, lo_j, bj, jnp.asarray(x.T), wj.shape[0]))[0]
    hi, lo = fused_t.split_hi_lo(w)
    got = fused_t.mlp_chain_3pass_plain(hi, lo, b, torch.from_numpy(x), w.shape[0])[:, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # the three-pass chain is not the FP32 one: its error is visible
    fp32 = fused_t.mlp_chain_plain(w, b, torch.from_numpy(x), w.shape[0])[:, 0].numpy()
    assert 0 < np.abs(got - fp32).max() < 1e-3


def _state_np(s):
    return {k: np.array(getattr(s, k)) for k in ("t", "budget", "active", "converged", "steps")}


def _state_t(s):
    return march_t.MarchState(
        t=torch.tensor(s["t"]), budget=torch.tensor(s["budget"]),
        active=torch.tensor(s["active"]), converged=torch.tensor(s["converged"]),
        steps=torch.tensor(int(s["steps"]), dtype=torch.int32))


def _assert_kernel_bar(entry_active, jx, th):
    """The kernel bar: (state, resolve) of the JAX package against ours."""
    (sj, rj), (st, rt) = jx, th
    assert entry_active > 50  # the call has work to do
    assert (sj["converged"] == st["converged"]).mean() > 0.99
    both = sj["converged"] & st["converged"]
    assert both.sum() > 0
    np.testing.assert_allclose(st["t"][both], sj["t"][both], rtol=0, atol=1e-4)
    assert int(st["steps"]) == int(sj["steps"])
    assert (st["active"] == sj["active"]).mean() > 0.99
    assert (rt == rj).mean() >= 0.99, (rt != rj).sum()


RES = 32
# The HIGH phase's three kinds of call at eps 1e-3: name -> (num_steps,
# relax_omega). The coarse call (coarse_precision="high") starts cold; rung 0
# and the terminal rung start from the refine entry of a coarse pass to 0.05.
HIGH_VARIANTS = {"coarse": (None, 1.6), "rung0": (16, 0.0), "terminal": (None, 1.6)}


@pytest.fixture(scope="module", params=["csg_demo", "x2"])
def high_chain(request):
    """Both packages' HIGH-precision march outputs for the three calls on
    the same inputs (the JAX package's coarse pass feeds the refine entry,
    which re-marks the near set active)."""
    pj, pt = _net(request.param)
    cfg_j = cj.RenderConfig(width=RES, height=RES)
    cfg_t = ct.RenderConfig(width=RES, height=RES)
    c2w, _ = cam_j.view_matrices(cj.Camera(**CAM))
    origin, dirs = (np.array(a) for a in cam_j.generate_rays(c2w, RES, RES, cfg_j.focal))
    o_j, d_j = jnp.asarray(origin), jnp.asarray(dirs)
    cold = _state_np(march_j.init_state(o_j, d_j, cfg_j.bound_center, cfg_j.bound_radius))

    def jax_march(s, eps, num_steps, omega):
        return mk_j.march_pallas_state(
            pj, o_j, d_j, march_j.MarchState(**{k: jnp.asarray(v) for k, v in s.items()}),
            cfg_j, tile=dirs.shape[0], interpret=True, march_eps=eps, precision=HIGH,
            num_steps=num_steps, relax_omega=omega, return_resolve=True)

    s = _state_np(jax_march(cold, 0.05, None, 1.6)[0])
    near = s["converged"] | s["active"]
    tnear, tfar, bhit = (np.asarray(a) for a in march_j.intersect_sphere(
        o_j, d_j, cfg_j.bound_center, cfg_j.bound_radius))
    entry = dict(t=s["t"], active=near, converged=np.zeros_like(near), steps=s["steps"],
                 budget=np.where(bhit, tfar - (s["t"] - np.maximum(tnear, 0.0)), 0.0)
                 .astype(np.float32))
    launches = mk_t.KERNEL_LAUNCHES
    out = {}
    for variant, (num_steps, omega) in HIGH_VARIANTS.items():
        s = cold if variant == "coarse" else entry
        jo, jr = jax_march(s, 1e-3, num_steps, omega)
        to, tr = mk_t.march_state(pt, torch.tensor(origin), torch.tensor(dirs), _state_t(s),
                                  cfg_t, march_eps=1e-3, num_steps=num_steps, precision="high",
                                  relax_omega=omega, return_resolve=True)
        out[variant] = (int(s["active"].sum()),
                        (_state_np(jo), np.asarray(jr).astype(np.int64)),
                        (_state_np(to), tr.numpy().astype(np.int64)))
    assert mk_t.KERNEL_LAUNCHES == launches  # CPU tensors never reach the kernel
    return out


@pytest.mark.parametrize("variant", list(HIGH_VARIANTS))
def test_march_state_high_matches_jax(high_chain, variant):
    _assert_kernel_bar(*high_chain[variant])


def test_march_state_high_differs_from_fp32():
    """precision="high" runs the three-pass chain, not the FP32 one, and an
    unknown precision raises."""
    _, pt = _net("csg_demo")
    cfg = ct.RenderConfig(width=RES, height=RES)
    c2w, _ = ct.camera.view_matrices(ct.Camera(**CAM))
    origin, dirs = ct.camera.generate_rays(c2w, RES, RES, cfg.focal)
    state = march_t.init_state(origin, dirs, cfg.bound_center, cfg.bound_radius)
    kw = dict(march_eps=1e-3, num_steps=24)
    hi = mk_t.march_state(pt, origin, dirs, state, cfg, precision="high", **kw)
    fp = mk_t.march_state(pt, origin, dirs, state, cfg, precision="highest", **kw)
    df = mk_t.march_state(pt, origin, dirs, state, cfg, precision="default", **kw)
    assert torch.equal(fp.t, df.t)
    both = hi.converged & fp.converged
    assert int(both.sum()) > 50 and not torch.equal(hi.t, fp.t)
    assert (hi.t - fp.t)[both].abs().max() < 1e-3
    with pytest.raises(ValueError, match="precision"):
        mk_t.march_state(pt, origin, dirs, state, cfg, precision="bf16")
    with pytest.raises(ValueError, match="precision"):
        mk_t.march_raygen(pt, c2w, torch.arange(4, dtype=torch.int32), cfg, precision="tf32")


@pytest.mark.parametrize("prec", ["default", "high"])
def test_march_raygen_plain_matches_jax(prec):
    """K5's plain version against ``march_pallas_raygen``: csg_demo at 32x32
    in 16x16 block order plus 8 pad lanes, the coarse call's eps 0.05 and
    omega 1.6. Pad lanes stay inactive and unconverged in both."""
    pj, pt = _net("csg_demo")
    cfg_j = cj.RenderConfig(width=RES, height=RES)
    cfg_t = ct.RenderConfig(width=RES, height=RES)
    c2w_j, _ = cam_j.view_matrices(cj.Camera(**CAM))
    pos = np.concatenate([renderer_j._block_order_np(RES, RES, 16, 16),
                          np.full(8, -1, np.int32)]).astype(np.int32)
    jprec = {"default": jax.lax.Precision.DEFAULT, "high": HIGH}[prec]
    jo, jr = mk_j.march_pallas_raygen(
        pj, c2w_j, jnp.asarray(pos), cfg_j, 0.0, tile=pos.size, interpret=True,
        march_eps=0.05, precision=jprec, relax_omega=1.6, return_resolve=True)
    to, tr = mk_t.march_raygen(
        pt, torch.from_numpy(np.array(c2w_j)), torch.from_numpy(pos), cfg_t, 0.0,
        march_eps=0.05, precision=prec, relax_omega=1.6, return_resolve=True)
    sj, st = _state_np(jo), _state_np(to)
    pad = pos < 0
    for s in (sj, st):
        assert not s["active"][pad].any() and not s["converged"][pad].any()
    entry = int(mk_t.raygen_state(torch.from_numpy(np.array(c2w_j)), torch.from_numpy(pos),
                                  cfg_t)[2].active.sum())
    _assert_kernel_bar(entry, (sj, np.asarray(jr).astype(np.int64)),
                       (st, tr.numpy().astype(np.int64)))


def test_raygen_state_matches_ray_build_and_init():
    """``raygen_state``'s rays and init agree with the staged renderer's
    ray build (``ray_dirs_from_index``) and ``init_state`` to float32 ulps."""
    cfg = ct.RenderConfig(width=48, height=40)
    c2w, _ = ct.camera.view_matrices(ct.Camera(**CAM))
    pos = torch.from_numpy(np.random.default_rng(0).permutation(48 * 40).astype(np.int32))
    origin, dirs, state = mk_t.raygen_state(c2w, pos, cfg)
    ref = ct.camera.ray_dirs_from_index(c2w, pos, cfg.height, cfg.width, cfg.focal)
    init = march_t.init_state(origin, ref, cfg.bound_center, cfg.bound_radius)
    torch.testing.assert_close(dirs, ref, rtol=0, atol=1e-6)
    assert torch.equal(state.active, init.active)
    torch.testing.assert_close(state.t, init.t, rtol=0, atol=1e-5)
    torch.testing.assert_close(state.budget, init.budget, rtol=0, atol=1e-5)
    assert int(state.steps) == 0 and not state.converged.any()


def test_march_stage_newton_matches_jax():
    """The secant-adaptive relaxed stage on dense csg_demo rays at 32x32
    (omega 1.6, omega_max 8, eps 1e-3), against the JAX package's."""
    pj, pt = _net("csg_demo")
    cfg = cj.RenderConfig(width=RES, height=RES)
    c2w, _ = cam_j.view_matrices(cj.Camera(**CAM))
    origin, dirs = (np.array(a) for a in cam_j.generate_rays(c2w, RES, RES, cfg.focal))
    kw = dict(num_steps=400, max_steps=400, march_eps=1e-3, relax_omega=1.6, newton=True,
              omega_max=8.0)
    s0 = march_j.init_state(jnp.asarray(origin), jnp.asarray(dirs), cfg.bound_center,
                            cfg.bound_radius)
    sj = _state_np(march_j.march_stage(renderer_j.neural_sdf_fn(pj, 0.0), jnp.asarray(origin),
                                       jnp.asarray(dirs), s0, **kw))
    st = _state_np(march_t.march_stage(
        renderer_t.neural_sdf_fn(pt, 0.0), torch.from_numpy(origin),
        torch.from_numpy(dirs), _state_t(_state_np(s0)), **kw))
    assert (sj["converged"] == st["converged"]).mean() >= 0.999
    both = sj["converged"] & st["converged"]
    assert both.sum() > 200
    np.testing.assert_allclose(st["t"][both], sj["t"][both], rtol=0, atol=1e-4)
    # the Newton step is not the constant one
    sc = _state_np(march_t.march_stage(
        renderer_t.neural_sdf_fn(pt, 0.0), torch.from_numpy(origin),
        torch.from_numpy(dirs), _state_t(_state_np(s0)), **dict(kw, newton=False)))
    assert not np.array_equal(sc["t"], st["t"])


# The port's coarse phase (utils/config.py, set from the H100's chain
# errors), given to both packages: the JAX package's default is the TPU's.
LADDER = dict(coarse_precision=ct.RenderConfig.coarse_precision,
              coarse_eps=ct.RenderConfig.coarse_eps)
COARSE = LADDER["coarse_precision"]

# option -> (config fields over LADDER, the precisions of the march-kernel
# calls it makes)
STAGED_OPTIONS = {
    "mid_eps": (dict(mid_eps=1e-3), {COARSE, "high", "highest"}),
    "mid_schedule": (dict(mid_eps=1e-3, mid_schedule=((4, 8), (32, 0))),
                     {COARSE, "high", "highest"}),
    "coarse_high": (dict(coarse_precision="high", coarse_eps=1e-3), {"high", "highest"}),
    # the FP32 coarse call (the JAX package's ladder)
    "coarse_fp32": (dict(coarse_precision="default", coarse_eps=0.05), {"default", "highest"}),
    # the relaxed rungs leave the kernel, which has no Newton step
    "relax_newton": (dict(relax_newton=True), {COARSE}),
    # the rungs march densely but the terminal one, which the kernel takes
    "tail_pallas": (dict(tail_pallas=True, refine_pallas=False), {COARSE, "highest"}),
}


@pytest.mark.parametrize("option", list(STAGED_OPTIONS))
def test_staged_render_option_matches_jax(option, monkeypatch):
    fields, precisions = STAGED_OPTIONS[option]
    pj, pt = _net("csg_demo")
    kw = dict(width=64, height=64, scene="neural_raw", march_impl="staged",
              rgba_packed=False, **dict(LADDER, **fields))
    cj.reset_schedule_memo()
    ct.reset_schedule_memo()
    stats_j, stats_t = {}, {}
    a = np.asarray(cj.render_staged(pj, cj.Camera(**CAM), cj.RenderConfig(**kw),
                                    stats_out=stats_j))
    seen = set()
    real = mk_t.march_state

    def recording(*args, **kwargs):
        seen.add(kwargs.get("precision", "highest"))
        return real(*args, **kwargs)

    monkeypatch.setattr(mk_t, "march_state", recording)
    launches = mk_t.KERNEL_LAUNCHES
    b = ct.render_staged(pt, ct.Camera(**CAM), ct.RenderConfig(**kw), stats_out=stats_t).numpy()
    assert mk_t.KERNEL_LAUNCHES == launches  # CPU tensors never reach the kernel
    assert seen == precisions
    assert b.shape == (64, 64, 4) and np.isfinite(b).all()
    hit_a, hit_b = a[..., 3] > 0, b[..., 3] > 0
    assert (hit_a == hit_b).mean() >= 0.99
    both = hit_a & hit_b
    assert both.sum() > 50
    close = np.all(np.abs(b[both] - a[both]) < 1e-3, axis=-1).mean()
    assert close >= 0.97, close
    assert stats_t["fast_path"] == stats_j["fast_path"]
    assert abs(stats_t["hits"] - stats_j["hits"]) <= 0.01 * stats_j["hits"]
    assert stats_t["unresolved"] == stats_j["unresolved"]
