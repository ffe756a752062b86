"""SDF networks 64-1024 wide: the port against the JAX package on the CPU.

Nets: csg_demo widened k = 2, 4, 8 and 16 times by ``chip_smoke.widen``
(the same function, 3->32k x8->1, copies with distinct weights in permuted
positions), anim_demo widened (the 4-input net), and random nets from the
JAX package's ``init_mlp`` at the sizes of tests/test_pallas.py:290-321 and
at 512 and 1024 wide.
Weights are carried across as numpy arrays; points and rays are made from
fixed seeds. The JAX side runs its Pallas kernels in interpret mode, as its
own tests do; this package runs the kernels' plain versions (CPU tensors).
Tolerances, each the JAX package's own bar:
  * the fused forward (K3): atol 1e-5 (test_pallas.py:295-308);
  * the march (K1, and K2h at precision HIGH): converged flags agree on
    >99%, t within 1e-4 where both converged, resolve steps equal on >=99%,
    equal step counters (test_pallas.py:49-72); where a refine call's
    resolve steps fall below that share or its counters differ, every
    differing lane must part at a test float32 cannot decide
    (chip_smoke.undecided_lanes, ROADMAP section 3); at 1024 the refine
    calls bounded at 8 steps, and whole against a float64 witness
    (MARCH_NETS); the port's march with the model of the kernel's
    tensor-core FP32 chain (fused_mlp.mlp_chain_3xtf32_mma) on csg_demo at
    32 and widened to 64, and at 128 and 512, to the same bar;
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
    assert [fused_t.padded_width(h) for h in (1, 32, 33, 64, 100, 128, 129, 256, 257, 512,
                                              513, 1024)] == [
        32, 32, 64, 64, 128, 128, 256, 256, 512, 512, 1024, 1024]
    with pytest.raises(ValueError, match="ROADMAP section 2"):
        fused_t.padded_width(1025)


@pytest.mark.parametrize("sizes", [(3, 64, 64, 64, 1), (3, 128, 128, 1), (3, 256, 256, 1),
                                   (3, 512, 512, 1), (3, 1024, 1024, 1), "csg_demo_x16"],
                         ids=["64", "128", "256", "512", "1024", "csg_demo_x16"])
def test_mlp_forward_plain_matches_jax(sizes):
    if sizes == "csg_demo_x16":  # the widened shipped net, 512 wide
        pj, pt = _both(chip_smoke.widen(_layers(CSG), 16, seed=16))
        sizes = (3, 512)
    else:
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
# name -> (image side, the refine calls' step bound or None). At 1024 wide
# XLA:CPU and torch's CPU products sum the 1024 terms in different orders:
# the SDF of random_1024 is bit-equal on 5% of 4096 seeded points, each
# side's error against float64 up to ~1e-6 (test_march_1024_refine_float64_
# witness), as large as the refine rungs' eps 1e-6. Over the whole refine
# calls rays then resolve a step or more apart on over 1% of the lanes, in
# both packages alike against a float64 march. So the 1024-wide net's
# refine calls are held to the bar bounded at 8 steps (rung 0 from its 16,
# the terminal rung from running to dry), where both sides agree; the whole
# calls are held against the float64 witness below. On the card the kernel
# is held to its plain version on every call.
MARCH_NETS = {"random_128": (16, None), "csg_demo_x2": (32, None), "random_512": (16, None),
              "random_1024": (16, 8)}
MARCH_CASES = [(net, v) for net in MARCH_NETS for v in VARIANTS]
# The shipped net itself (3->32x8->1), marched only with the model below.
MODEL_NETS = {"csg_demo": (32, None)}
# The whole refine calls at 1024, for the float64 witness.
WITNESS_NET = "random_1024_whole"


def _net(name):
    if name.startswith("random_"):  # seed 4 crosses the bounding sphere at 512 and 1024
        h = int(name.split("_")[1])
        return _init_jax(2 if h == 128 else 4, (3, h, h, 1))
    if name == "csg_demo":
        return _both(_layers(CSG))
    return _both(chip_smoke.widen(_layers(CSG), 2, seed=3))


def _state_np(s):
    return {k: np.array(getattr(s, k)) for k in ("t", "budget", "active", "converged", "steps")}


@pytest.fixture(scope="module")
def wide_chain(request):
    """Both packages' outputs for the staged renderer's kinds of march call
    (MARCH_NETS, and WITNESS_NET: random_1024 with whole refine calls),
    each starting from the JAX package's output of the one before (the
    refine entry re-marks the near set active); the rays; and per call the
    port's march inputs and each side's chain, for ``_undecided``."""
    res, bound = {**MARCH_NETS, **MODEL_NETS}.get(request.param, (16, None))
    pj, pt = _net(request.param)
    cfg_j = cj.RenderConfig(width=res, height=res)
    cfg_t = ct.RenderConfig(width=res, height=res)
    c2w, _ = cam_j.view_matrices(cj.Camera(**CAM))
    origin, dirs = (np.array(a) for a in cam_j.generate_rays(c2w, res, res, cfg_j.focal))
    s = _state_np(march_j.init_state(jnp.asarray(origin), jnp.asarray(dirs),
                                     cfg_j.bound_center, cfg_j.bound_radius))
    out = {"rays": (origin, dirs, pj, pt)}
    for variant in VARIANTS:
        eps, num_steps, omega = VARIANTS[variant]
        if bound is not None and variant != "coarse":
            num_steps = bound if num_steps is None else min(num_steps, bound)
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
        kw = dict(march_eps=eps, num_steps=num_steps, relax_omega=omega)
        to, tr = mk_t.march_state(pt, torch.tensor(origin), torch.tensor(dirs), state_t, cfg_t,
                                  return_resolve=True, **kw)
        out[variant] = (s, (_state_np(jo), np.asarray(jr).astype(np.int64)),
                        (_state_np(to), tr.numpy().astype(np.int64)),
                        dict(call=(torch.tensor(origin), torch.tensor(dirs), state_t, cfg_t, 0.0,
                                   kw),
                             outs=((_state_t(jo), torch.from_numpy(np.array(jr)).int()),
                                   (to, tr)),
                             chains=(_jax_chain(pj, prec), None), pj=pj, pt=pt))
        s = out[variant][1][0]
    return out


@pytest.mark.parametrize("wide_chain,variant", MARCH_CASES, indirect=["wide_chain"])
def test_march_state_plain_matches_jax_wide(wide_chain, variant):
    _check_march_bar(wide_chain[variant][:3], lambda: _undecided(wide_chain[variant][3]))


# The model of the kernel's FP32 chain on the tensor cores
# (fused_mlp.mlp_chain_3xtf32_mma) marches csg_demo at 32 and widened to 64
# (the chain_tf32_regs widths) and the nets at 128 and 512 wide.
MODEL_CASES = [(net, v) for net in ("csg_demo", "csg_demo_x2", "random_128", "random_512")
               for v in VARIANTS]


def _model_chain(pt):
    """``fused_mlp.mlp_chain_3xtf32_mma`` as ``march_state_plain`` takes a
    chain, on the rows up to the last nonzero one (the plain march pads its
    batch with zero rows, and the model sums each product one by one)."""
    weights, biases, _, _ = fused_t.pack_params(pt)

    def chain(x):
        n = int(x.abs().sum(dim=1).nonzero().max()) + 1
        out = torch.zeros_like(x)
        out[:n, 0] = fused_t.mlp_chain_3xtf32_mma(weights, biases, x[:n])
        return out

    return chain


@pytest.mark.parametrize("wide_chain,variant", MODEL_CASES, indirect=["wide_chain"])
def test_march_3xtf32_model_matches_jax_wide(wide_chain, variant):
    """The port's plain march with the model of the kernel's tensor-core
    FP32 chain in place of its plain chain, from the entry of
    test_march_state_plain_matches_jax_wide's call, against the JAX
    megakernel: the coarse call at JAX's own bar, the refine calls at that
    bar and, where float32 cannot decide a test, ``undecided_lanes`` of the
    model against JAX's chain."""
    entry, jax_out, _, rec = wide_chain[variant]
    pt, pj = rec["pt"], rec["pj"]
    origin, dirs, state, cfg, frame, kw = rec["call"]
    chain = _model_chain(pt)
    mo, mr = mk_t.march_state_plain(pt, origin, dirs, state, cfg, frame, chain=chain,
                                    return_resolve=True, **kw)

    def undecided():
        return chip_smoke.undecided_lanes(
            pt, rec["call"], (rec["chains"][0], chain), (rec["outs"][0], (mo, mr)),
            lambda pts: torch.from_numpy(_sdf64(pj, pts.numpy())))

    _check_march_bar((entry, jax_out, (_state_np(mo), mr.numpy().astype(np.int64))),
                     None if variant == "coarse" else undecided)


def _state_t(s):
    """A JAX MarchState as the port's, on the CPU."""
    return march_t.MarchState(
        t=torch.from_numpy(np.array(s.t)), budget=torch.from_numpy(np.array(s.budget)),
        active=torch.from_numpy(np.array(s.active)),
        converged=torch.from_numpy(np.array(s.converged)),
        steps=torch.tensor(int(s.steps), dtype=torch.int32))


def _jax_chain(pj, precision):
    """The JAX megakernel's chain (``fused_mlp._mlp_chain`` on [H, T]
    activations) as ``march_state_plain`` takes a chain, x [T, H] -> [T, H].
    At the call's tile (T = 256 rows, which ``march_state_plain`` pads any
    16x16 call to on the CPU) its sums are the megakernel's bit for bit, so
    a replay lands on the JAX march (``chip_smoke.undecided_lanes`` checks)."""
    wj, bj, _, _ = fused_j.pack_params(pj)

    def chain(x):
        y = fused_j._mlp_chain(wj, bj, jnp.asarray(x.numpy().T), len(pj), precision)
        return torch.from_numpy(np.asarray(y).T.copy())

    return chain


def _undecided(rec):
    """``chip_smoke.undecided_lanes`` of a call, JAX against the port, the
    float64 distance from ``_sdf64``."""
    pj = rec["pj"]
    return chip_smoke.undecided_lanes(
        rec["pt"], rec["call"], rec["chains"], rec["outs"],
        lambda pts: torch.from_numpy(_sdf64(pj, pts.numpy())))


def _check_march_bar(call, undecided=None):
    """test_pallas.py:49-72's bar on (entry, JAX output, port output).
    Where float32 cannot decide a test at the refine rungs' eps 1e-6
    (ROADMAP section 3), the two packages' sums in their own orders send a
    ray to resolve a step apart: if resolve steps are equal on fewer than
    99% of the lanes, or the step counters differ, ``undecided()``
    (``_undecided``) must find every differing lane undecidable by float32
    at the step where the two marches part, each replay landing on its
    side's results."""
    entry, (sj, rj), (st, rt) = call
    assert entry["active"].sum() > 20  # the call has work to do
    assert (sj["converged"] == st["converged"]).mean() > 0.99
    both = sj["converged"] & st["converged"]
    assert both.sum() > 0
    np.testing.assert_allclose(st["t"][both], sj["t"][both], rtol=0, atol=1e-4)
    assert (st["active"] == sj["active"]).mean() > 0.99
    if undecided is not None and (int(st["steps"]) != int(sj["steps"])
                                  or (rt == rj).mean() < 0.99):
        u = undecided()
        print(f"resolve steps equal on {(rt == rj).mean():.4f}, step counters port "
              f"{int(st['steps'])} JAX {int(sj['steps'])}: {u}")
        assert (u["replay_equal"] and u["lanes"] > 0 and u["n_decided"] == 0
                and u["n_unparted"] == 0), u
        return
    assert int(st["steps"]) == int(sj["steps"])
    assert (rt == rj).mean() >= 0.99, (rt != rj).sum()


def test_undecided_lanes_fails_a_decidable_disagreement():
    """``chip_smoke.undecided_lanes`` on a disagreement float32 decides:
    csg_demo's refine rung 0 (eps 1e-6) at 16x16 against the same march at
    eps 1e-3, a fault of the step rule. Both sides run the same chain, so
    its error bounds delta and the two replays never part: no differing
    lane has a test float32 cannot decide, and the faulty side's replay
    does not land on it."""
    pt = ct.from_numpy_params(_layers(CSG), device="cpu")
    cfg = ct.RenderConfig(width=16, height=16)
    c2w, _ = cam_j.view_matrices(cj.Camera(**CAM))
    origin, dirs = (torch.from_numpy(np.array(a)) for a in
                    cam_j.generate_rays(c2w, 16, 16, cfg.focal))
    cold = march_t.init_state(origin, dirs, cfg.bound_center, cfg.bound_radius)
    coarse = mk_t.march_state(pt, origin, dirs, cold, cfg, march_eps=0.05, relax_omega=1.6)
    entry = chip_smoke.refine_entry(coarse, origin, dirs, cfg)
    kw = dict(march_eps=1e-6, num_steps=16, relax_omega=0.0)
    good = mk_t.march_state(pt, origin, dirs, entry, cfg, return_resolve=True, **kw)
    bad = mk_t.march_state(pt, origin, dirs, entry, cfg, return_resolve=True,
                           **dict(kw, march_eps=1e-3))
    sdf64 = lambda pts: chip_smoke.sdf_float64(pt, pts)  # noqa: E731
    u = chip_smoke.undecided_lanes(pt, (origin, dirs, entry, cfg, 0.0, kw), (None, None),
                                   (good, bad), sdf64)
    assert u["lanes"] > 0 and u["n_unparted"] == u["lanes"] and not u["replay_equal"], u
    assert u["delta"] < 1e-5
    same = chip_smoke.undecided_lanes(pt, (origin, dirs, entry, cfg, 0.0, kw), (None, None),
                                      (good, good), sdf64)
    assert same["lanes"] == 0 and same["n_decided"] == 0


def _sdf64(pj, pts):
    """The JAX net's SDF at points [n, 3] in float64."""
    x = np.asarray(pts, np.float64)
    for i, layer in enumerate(pj):
        x = x @ np.asarray(layer.w, np.float64) + np.asarray(layer.b, np.float64)
        if i + 1 < len(pj):
            x = np.maximum(x, 0.0)
    return x[:, 0]


def _march64(pj, origin, dirs, s, eps, num_steps, omega, max_steps):
    """``march_state_plain``'s march in float64 (t, budget, points, SDF),
    from the float32 entry state ``s``: (converged, t, lane steps)."""
    t, budget = s["t"].astype(np.float64), s["budget"].astype(np.float64)
    act, conv = s["active"].copy(), s["converged"].copy()
    start = step = int(s["steps"])
    res = np.full(act.shape, start)
    prev_r, step_len = np.zeros_like(t), np.zeros_like(t)
    relax = omega > 1.0
    limit = max_steps if num_steps is None else min(max_steps, start + num_steps)
    while step < limit and act.any():
        idx = np.nonzero(act)[0]
        ti, pr, sl = t[idx], prev_r[idx], step_len[idx]
        d = _sdf64(pj, origin.astype(np.float64) + dirs[idx].astype(np.float64) * ti[:, None])
        sor_fail = (sl > pr) & (d + pr < sl) if relax else np.zeros(idx.size, bool)
        near = ~sor_fail & (d < eps)
        om = np.where(sl < 0.0, 1.0, omega) if relax else 1.0
        stepv = np.where(sor_fail, pr - sl, np.where(near, d, om * d))
        bi = budget[idx] - stepv
        moved = sor_fail | ~(bi <= 0.0)
        conv_now = moved & near
        still = moved & ~conv_now
        budget[idx] = bi
        t[idx] = np.where(moved, ti + stepv, ti)
        conv[idx] |= conv_now
        act[idx] = still
        res[idx] = np.where(still, res[idx], step + 1)
        if relax:
            prev_r[idx] = np.where(moved & ~sor_fail, d, pr)
            step_len[idx] = np.where(moved, stepv, sl)
        step += 1
    return conv, t, np.where(act, step, res)


@pytest.mark.parametrize("wide_chain", [WITNESS_NET], indirect=True)
@pytest.mark.parametrize("variant", ["rung0", "terminal"])
def test_march_1024_refine_float64_witness(wide_chain, variant):
    """The whole refine calls at 1024 wide (rung 0's 16 steps, the terminal
    rung run to dry), against a float64 witness. At the points the call
    starts from, the port's SDF is as close to float64 as the JAX
    package's (mean |error| within 1.25x, max within 2x). The two float32
    marches agree with each other and each with the float64 march on the
    converged flags (>99%) and on t where both converged (1e-4). Their
    resolve steps, which float32 cannot decide at eps 1e-6, are printed:
    the port against JAX, and each against float64."""
    origin, dirs, pj, pt = wide_chain["rays"]
    entry, (sj, rj), (st, rt) = wide_chain[variant][:3]
    eps, num_steps, omega = VARIANTS[variant]
    act = entry["active"]
    assert act.sum() > 20
    pts = (origin.astype(np.float64) + dirs[act].astype(np.float64)
           * entry["t"][act, None].astype(np.float64)).astype(np.float32)
    want = _sdf64(pj, pts)
    wj, bj, _, _ = fused_j.pack_params(pj)
    w, b, _, _ = fused_t.pack_params(pt)
    err_j = np.abs(np.asarray(fused_j.mlp_forward_pallas(wj, bj, jnp.asarray(pts),
                                                         interpret=True)) - want)
    err_t = np.abs(fused_t.mlp_forward(w, b, torch.from_numpy(pts)).numpy() - want)
    print(f"{variant}: |SDF - float64| at {act.sum()} points: port mean {err_t.mean():.3g} "
          f"max {err_t.max():.3g}, JAX mean {err_j.mean():.3g} max {err_j.max():.3g}")
    assert err_t.mean() <= 1.25 * err_j.mean() and err_t.max() <= 2.0 * err_j.max()
    conv64, t64, r64 = _march64(pj, origin, dirs, entry, eps, num_steps, omega,
                                ct.RenderConfig().max_steps)
    s64 = dict(converged=conv64, t=t64)
    for a, c in ((st, sj), (st, s64), (sj, s64)):
        assert (a["converged"] == c["converged"]).mean() > 0.99
        both = a["converged"] & c["converged"]
        assert both.sum() > 0
        np.testing.assert_allclose(a["t"][both], c["t"][both], rtol=0, atol=1e-4)
    print(f"{variant}: resolve steps equal, port vs JAX {(rt == rj).mean():.4f}, port vs "
          f"float64 {(rt == r64).mean():.4f}, JAX vs float64 {(rj == r64).mean():.4f}; step "
          f"counters port {int(st['steps'])}, JAX {int(sj['steps'])}")


def test_march_state_high_plain_matches_jax_512():
    """The three-pass chain (K2h) at width 512: a cold coarse call at the
    HIGH phase's eps 1e-3 on csg_demo widened 16 times, 16x16 rays, against
    the JAX megakernel at Precision.HIGH in interpret mode."""
    pj, pt = _both(chip_smoke.widen(_layers(CSG), 16, seed=5))
    res = 16
    cfg_j = cj.RenderConfig(width=res, height=res)
    c2w, _ = cam_j.view_matrices(cj.Camera(**CAM))
    origin, dirs = (np.array(a) for a in cam_j.generate_rays(c2w, res, res, cfg_j.focal))
    s = _state_np(march_j.init_state(jnp.asarray(origin), jnp.asarray(dirs),
                                     cfg_j.bound_center, cfg_j.bound_radius))
    kw = dict(march_eps=1e-3, relax_omega=1.6, return_resolve=True)
    jo, jr = mk_j.march_pallas_state(
        pj, jnp.asarray(origin), jnp.asarray(dirs),
        march_j.MarchState(**{k: jnp.asarray(v) for k, v in s.items()}), cfg_j,
        tile=dirs.shape[0], interpret=True, precision=jax.lax.Precision.HIGH, **kw)
    state_t = march_t.MarchState(
        t=torch.tensor(s["t"]), budget=torch.tensor(s["budget"]),
        active=torch.tensor(s["active"]), converged=torch.tensor(s["converged"]),
        steps=torch.tensor(int(s["steps"]), dtype=torch.int32))
    to, tr = mk_t.march_state(pt, torch.tensor(origin), torch.tensor(dirs), state_t,
                              ct.RenderConfig(width=res, height=res), precision="high", **kw)
    _check_march_bar((s, (_state_np(jo), np.asarray(jr).astype(np.int64)),
                      (_state_np(to), tr.numpy().astype(np.int64))))


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
        [(np.ones((3, 1100), np.float32), np.zeros(1100, np.float32)),
         (np.ones((1100, 1), np.float32), np.zeros(1, np.float32))], device="cpu")
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
