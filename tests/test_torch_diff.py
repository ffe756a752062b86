"""The PyTorch package's differentiable rendering (``diff/``) against the
JAX package's, on the CPU.

csg_demo (the shipped 3->32x8->1 net) and a (3,16,16,1) ``init_mlp`` net,
32x32 images; the JAX side marches with ``coarse_pallas=False,
refine_pallas=False`` as tests/test_diff.py:412-445 does. Both packages
get the same surface solve (t_star, hit) where a function takes one, so
each comparison isolates the function under test. Bars, stated per test:
  * the shading repair: with ``differentiable=False`` the normals carry no
    gradient, which differs from JAX's ``jax.grad``; with it the gradient
    equals JAX's within |d| <= 1e-4 |g|;
  * ``implicit_surface_t``, ``render_depth_diff``, ``render_image_diff``:
    values within 1e-5, the gradient of every weight and bias within
    |d| <= 1e-4 |g_jax|;
  * ``pixel_loss`` (dense, ``compact_cap``) and ``pixel_loss_packed``:
    loss rtol 1e-5, gradients |d| <= 1e-4 |g|;
  * ``silhouette_loss``, ``sdf_distillation_loss``, ``eikonal_loss``: loss
    rtol 1e-5, the whole gradient |d| <= 1e-5 |g| and each leaf's within
    1e-4 (a one-entry bias gradient sums 2^14 terms that cancel);
  * ``solve_surface`` ("full" and "mixed", 64x64): hits agree on >= 99%
    of rays, |dt| <= 1e-4 where both hit (the kernel bar of
    tests/test_pallas.py:49-72), the same fast path or dense fallback;
    ``solve_surface_packed_async`` gives the same hit set as the
    scheduled solve in image order;
  * after a training step the solve marches the new weights: it equals a
    solve of the same weights loaded fresh, bit for bit.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cudaneuralrender_torch as ct  # noqa: E402
import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch.diff import implicit as t_imp  # noqa: E402
from cudaneuralrender_torch.diff import losses as t_loss  # noqa: E402
from cudaneuralrender_torch.diff import solve as t_solve  # noqa: E402
from cudaneuralrender_torch.diff import train as t_train  # noqa: E402
from cudaneuralrender_tpu.diff import implicit as j_imp  # noqa: E402
from cudaneuralrender_tpu.diff import losses as j_loss  # noqa: E402
from cudaneuralrender_tpu.diff import solve as j_solve  # noqa: E402

NPZ = "examples/assets/csg_demo.npz"
CAM = dict(rotation_y=30.0, rotation_x=-20.0)
SIDE = 32
FIELDS = dict(width=SIDE, height=SIDE, scene="neural_raw", max_steps=300,
              march_impl="staged", coarse_pallas=False, refine_pallas=False)


def _nets():
    """name -> list of (w, b) float32 arrays."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with np.load(os.path.join(root, NPZ)) as f:
        csg = [(f[f"w{i}"], f[f"b{i}"]) for i in range(len(f.files) // 2)]
    tiny = [(np.asarray(l.w), np.asarray(l.b))
            for l in cj.init_mlp(jax.random.key(3), sizes=(3, 16, 16, 1))]
    return {"csg_demo": csg, "tiny": tiny}


NETS = _nets()


def _jax(layers):
    return [cj.DenseParams(jnp.asarray(w), jnp.asarray(b)) for w, b in layers]


def _torch(layers):
    """Trainable port params over the same values (requires_grad)."""
    return t_train._trainable(ct.from_numpy_params(layers, device="cpu"))


def _noisy(layers, seed=7, scale=0.01):
    rng = np.random.default_rng(seed)
    return [(w + scale * rng.standard_normal(w.shape).astype(np.float32),
             b + scale * rng.standard_normal(b.shape).astype(np.float32)) for w, b in layers]


def _grads(loss, params):
    return [g.numpy() for g in torch.autograd.grad(loss, t_train._flat(params),
                                                   allow_unused=True, materialize_grads=True)]


def _assert_grads(g_jax, g_torch, rel, rel_leaf=None):
    """|d| <= rel |g| for each leaf, or with ``rel_leaf`` for the whole
    gradient and rel_leaf for each leaf."""
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(g_jax)]
    assert len(leaves) == len(g_torch)
    assert [a.shape for a in leaves] == [b.shape for b in g_torch]
    if rel_leaf is not None:
        a, b = (np.concatenate([x.ravel() for x in xs]) for xs in (leaves, g_torch))
        assert np.linalg.norm(a - b) <= rel * np.linalg.norm(a)
        rel = rel_leaf
    assert sum(float(np.linalg.norm(a)) for a in leaves) > 0
    for i, (a, b) in enumerate(zip(leaves, g_torch)):
        delta, norm = np.linalg.norm(a - b), np.linalg.norm(a)
        assert delta <= rel * norm, (i, delta, norm)


def _solve_jax(layers, fields=FIELDS, cam=CAM):
    t, hit = j_solve.solve_surface(_jax(layers), cj.Camera(**cam), cj.RenderConfig(**fields))
    return np.asarray(t), np.asarray(hit)


@pytest.fixture(scope="module", params=list(NETS))
def net(request):
    layers = NETS[request.param]
    t_star, hit = _solve_jax(layers)
    assert hit.sum() > 20, hit.sum()
    return request.param, layers, t_star, hit


@pytest.mark.parametrize("points", ["constant", "implicit"])
def test_shade_gradient_through_normals(points):
    """Step 0's repair: the gradient of sum(shade(...)) with respect to the
    weights reaches the normals only with ``differentiable=True``; at
    constant surface points, and at points that carry the implicit
    surface gradient themselves."""
    layers = NETS["csg_demo"]
    t_star, hit = _solve_jax(layers)
    c2w, _ = cj.camera.view_matrices(cj.Camera(**CAM))
    origin, dirs = cj.camera.generate_rays(c2w, SIDE, SIDE, 2.0)
    sel = np.flatnonzero(hit)
    o, d, ts = np.asarray(origin), np.asarray(dirs)[sel], t_star[sel]
    cfg_j, cfg_t = cj.RenderConfig(**FIELDS), ct.RenderConfig(**FIELDS)

    def jax_colors(p):
        f = cj.scene_fn(p, cfg_j, 0.0, for_grad=True)
        t = jnp.asarray(ts)
        if points == "implicit":
            t = j_imp.implicit_surface_t(f, jnp.asarray(o), jnp.asarray(d), t)
        pts = jnp.asarray(o) + jnp.asarray(d) * t[:, None]
        return cj.shading.shade(f, pts, jnp.asarray(d))

    g_jax = jax.grad(lambda p: jnp.sum(jax_colors(p) * 0.7 + 0.1))(_jax(layers))
    params = _torch(layers)
    f = ct.scene_fn(params, cfg_t, 0.0, for_grad=True)
    t = torch.tensor(ts)
    if points == "implicit":
        t = t_imp.implicit_surface_t(f, torch.tensor(o), torch.tensor(d), t)
        assert t.requires_grad
    pts = torch.tensor(o) + torch.tensor(d) * t[:, None]
    # Off (the render default): the colours are constants, so the weights'
    # gradient is zero where JAX's is not.
    assert not ct.shading.shade(f, pts, torch.tensor(d)).requires_grad
    on = ct.shading.shade(f, pts, torch.tensor(d), differentiable=True)
    np.testing.assert_allclose(on.detach().numpy(), np.asarray(jax_colors(_jax(layers))),
                               rtol=0, atol=1e-5)
    _assert_grads(g_jax, _grads(torch.sum(on * 0.7 + 0.1), params), 1e-4)


@pytest.mark.parametrize("what", ["implicit_surface_t", "render_depth_diff", "render_image_diff"])
def test_implicit_matches_jax(net, what):
    """Values within 1e-5, gradients |d| <= 1e-4 |g_jax| for every leaf,
    given the same (t_star, hit)."""
    _, layers, t_star, hit = net
    cfg_j, cfg_t = cj.RenderConfig(**FIELDS), ct.RenderConfig(**FIELDS)
    cam_j, cam_t = cj.Camera(**CAM), ct.Camera(**CAM)
    ts_j, hit_j = jnp.asarray(t_star), jnp.asarray(hit)
    ts_t, hit_t = torch.tensor(t_star), torch.tensor(hit)
    c2w, _ = cj.camera.view_matrices(cam_j)
    origin, dirs = cj.camera.generate_rays(c2w, SIDE, SIDE, 2.0)
    sel = np.flatnonzero(hit)

    def jax_fn(p):
        if what == "implicit_surface_t":
            f = cj.scene_fn(p, cfg_j, 0.0, for_grad=True)
            out = j_imp.implicit_surface_t(f, origin, dirs[sel], ts_j[sel])
            return jnp.sum(out), out
        if what == "render_depth_diff":
            t, h = j_imp.render_depth_diff(p, cam_j, cfg_j, t_star=ts_j, hit=hit_j)
            out = jnp.where(h, t, 0.0)
            return jnp.sum(out), out
        out = j_imp.render_image_diff(p, cam_j, cfg_j, t_star=ts_j, hit=hit_j)
        return jnp.sum((out - 0.3) ** 2), out

    (_, out_j), g_jax = jax.value_and_grad(jax_fn, has_aux=True)(_jax(layers))
    params = _torch(layers)
    if what == "implicit_surface_t":
        f = ct.scene_fn(params, cfg_t, 0.0, for_grad=True)
        out = t_imp.implicit_surface_t(f, torch.tensor(np.asarray(origin)),
                                       torch.tensor(np.asarray(dirs)[sel]), ts_t[sel])
        loss = torch.sum(out)
    elif what == "render_depth_diff":
        t, h = t_imp.render_depth_diff(params, cam_t, cfg_t, t_star=ts_t, hit=hit_t)
        assert not h.requires_grad and torch.equal(h, hit_t)
        out = torch.where(h, t, 0.0)
        loss = torch.sum(out)
    else:
        out = t_imp.render_image_diff(params, cam_t, cfg_t, t_star=ts_t, hit=hit_t)
        assert out.shape == (SIDE, SIDE, 4)
        loss = torch.sum((out - 0.3) ** 2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=0, atol=1e-5)
    _assert_grads(g_jax, _grads(loss, params), 1e-4)


def test_render_diff_rejects_half_solve():
    params = _torch(NETS["tiny"])
    with pytest.raises(ValueError):
        t_imp.render_image_diff(params, ct.Camera(**CAM), ct.RenderConfig(**FIELDS),
                                t_star=torch.zeros(SIDE * SIDE))
    with pytest.raises(ValueError):
        t_loss.pixel_loss(params, ct.Camera(**CAM), ct.RenderConfig(**FIELDS),
                          torch.zeros(SIDE, SIDE, 4), compact_cap=64)


@pytest.fixture(scope="module")
def pixel_case():
    """Noisy csg_demo, its solve at 32x32 with compact_min=64 (so the first
    refine bucket is a real prefix and the packed bundle has a bound), and
    the target: csg_demo rendered from another yaw."""
    layers = _noisy(NETS["csg_demo"])
    fields = dict(FIELDS, compact_min=64)
    cfg_j = cj.RenderConfig(**fields)
    target = np.asarray(cj.render_image(_jax(NETS["csg_demo"]), cj.Camera(rotation_y=24.0),
                                        cfg_j.replace(march_impl="while")))
    cam = cj.Camera(rotation_y=20.0)
    t_star, hit = j_solve.solve_surface(_jax(layers), cam, cfg_j)
    pos, t_p, conv, within, check = j_solve.solve_surface_packed_async(_jax(layers), cam,
                                                                       cfg_j)
    assert check() and within is not None
    packed = tuple(np.asarray(x) for x in (pos, t_p, conv))
    return layers, fields, target, np.asarray(t_star), np.asarray(hit), packed, within


@pytest.mark.parametrize("kind", ["dense", "compact", "packed"])
def test_pixel_loss_matches_jax(pixel_case, kind):
    """Loss rtol 1e-5, gradients |d| <= 1e-4 |g| on the same solve."""
    layers, fields, target, t_star, hit, packed, within = pixel_case
    hits = int(hit.sum())
    cap = cj.compaction.capacity_pow2_of(hits, SIDE * SIDE, minimum=64)
    assert cap == ct.compaction.capacity_pow2_of(hits, SIDE * SIDE, minimum=64)
    cfg_j, cfg_t = cj.RenderConfig(**fields), ct.RenderConfig(**fields)
    cam = dict(rotation_y=20.0)

    def jax_fn(p):
        tgt = jnp.asarray(target)
        if kind == "packed":
            return j_loss.pixel_loss_packed(p, cj.Camera(**cam), cfg_j, tgt,
                                            *(jnp.asarray(x) for x in packed),
                                            min(cap, within), within)
        return j_loss.pixel_loss(p, cj.Camera(**cam), cfg_j, tgt, t_star=jnp.asarray(t_star),
                                 hit=jnp.asarray(hit),
                                 compact_cap=(cap if kind == "compact" else None))

    loss_j, g_jax = jax.value_and_grad(jax_fn)(_jax(layers))
    params = _torch(layers)
    tgt = torch.tensor(target)
    if kind == "packed":
        loss = t_loss.pixel_loss_packed(params, ct.Camera(**cam), cfg_t, tgt,
                                        *(torch.tensor(x) for x in packed), min(cap, within),
                                        within)
    else:
        loss = t_loss.pixel_loss(params, ct.Camera(**cam), cfg_t, tgt,
                                 t_star=torch.tensor(t_star), hit=torch.tensor(hit),
                                 compact_cap=(cap if kind == "compact" else None))
    assert float(loss_j) > 0
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    _assert_grads(g_jax, _grads(loss, params), 1e-4)


@pytest.mark.parametrize("what", ["silhouette", "distillation", "eikonal"])
def test_aux_losses_match_jax(net, what):
    """Loss rtol 1e-5, gradients |d| <= 1e-5 |g| on the same points."""
    _, layers, _, hit = net
    side = 16
    fields = dict(FIELDS, width=side, height=side)
    rng = np.random.default_rng(11)
    pts = rng.uniform(-1.0, 1.0, (512, 3)).astype(np.float32)
    target_d = (np.linalg.norm(pts, axis=-1) - 0.5).astype(np.float32)
    mask = np.asarray(hit).reshape(SIDE, SIDE)[::2, ::2]

    def jax_fn(p):
        if what == "silhouette":
            return j_loss.silhouette_loss(p, cj.Camera(**CAM), cj.RenderConfig(**fields),
                                          jnp.asarray(mask))
        if what == "distillation":
            return j_loss.sdf_distillation_loss(p, jnp.asarray(pts), jnp.asarray(target_d))
        return j_loss.eikonal_loss(p, jnp.asarray(pts))

    loss_j, g_jax = jax.value_and_grad(jax_fn)(_jax(layers))
    params = _torch(layers)
    if what == "silhouette":
        loss = t_loss.silhouette_loss(params, ct.Camera(**CAM), ct.RenderConfig(**fields),
                                      torch.tensor(mask))
    elif what == "distillation":
        loss = t_loss.sdf_distillation_loss(params, torch.tensor(pts), torch.tensor(target_d))
    else:
        loss = t_loss.eikonal_loss(params, torch.tensor(pts))
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    _assert_grads(g_jax, _grads(loss, params), 1e-5, rel_leaf=1e-4)


@pytest.mark.parametrize("precision", ["full", "mixed"])
def test_solve_surface_matches_jax(precision):
    """Hits agree on >= 99% of rays, |dt| <= 1e-4 where both hit, and the
    fast path or dense fallback as JAX's (at 64x64 the "full" schedule
    leaves budgeted rays for the dense march in both); no graph. The
    packed solve's hit set equals the image-order scheduled solve's."""
    side = 64
    fields = dict(FIELDS, width=side, height=side, march_precision=precision)
    stats_j, stats = {}, {}
    t_j, hit_j = j_solve.solve_surface(_jax(NETS["csg_demo"]), cj.Camera(**CAM),
                                       cj.RenderConfig(**fields), stats_out=stats_j)
    t_j, hit_j = np.asarray(t_j), np.asarray(hit_j)
    params = _torch(NETS["csg_demo"])
    cfg = ct.RenderConfig(**fields)
    t, hit = t_solve.solve_surface(params, ct.Camera(**CAM), cfg, stats_out=stats)
    assert not t.requires_grad
    assert stats["fast_path"] == stats_j["fast_path"] == (precision == "mixed")
    assert stats.get("dense_fallback") == stats_j.get("dense_fallback")
    t, hit = t.numpy(), hit.numpy()
    assert (hit == hit_j).mean() >= 0.99
    both = hit & hit_j
    assert both.sum() > 500
    assert np.abs(t[both] - t_j[both]).max() <= 1e-4
    t_a, hit_a, check_a = t_solve.solve_surface_async(params, ct.Camera(**CAM), cfg)
    pos, t_p, conv, within, check = t_solve.solve_surface_packed_async(
        params, ct.Camera(**CAM), cfg)
    assert check() == check_a() == stats["fast_path"]
    assert (within is None) == (precision == "full")
    packed_hits = np.zeros(side * side, bool)
    packed_hits[pos.numpy()[conv.numpy()]] = True
    np.testing.assert_array_equal(packed_hits, hit_a.numpy())
    if stats["fast_path"]:
        np.testing.assert_array_equal(hit_a.numpy(), hit)


def test_solve_follows_a_training_step():
    """The solve packs the weights it marches once per parameter state
    (``fused_mlp.packed_params``): after a step it must march the NEW
    weights, exactly as a solve of those weights loaded fresh does."""
    fields = dict(FIELDS, width=64, height=64)
    cfg = ct.RenderConfig(**fields)
    cam = ct.Camera(**CAM)
    state = t_train.init_train_state(ct.from_numpy_params(_noisy(NETS["csg_demo"]),
                                                          device="cpu"), 1e-2)
    before = t_solve.solve_surface(state.params, cam, cfg)
    target = torch.zeros(64, 64, 4)
    state, _ = t_train.pixel_train_step_fast(state, cam, target, cfg, 1e-2)
    after = t_solve.solve_surface(state.params, cam, cfg)
    fresh = ct.from_numpy_params(ct.mlp.to_numpy_params(state.params), device="cpu")
    again = t_solve.solve_surface(fresh, cam, cfg)
    assert torch.equal(after[0], again[0]) and torch.equal(after[1], again[1])
    assert not torch.equal(after[0], before[0])
