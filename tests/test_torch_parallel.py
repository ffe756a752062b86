"""The PyTorch package's parallel/ (mesh, sharding, dryrun) against the JAX
package's, on the CPU.

The port's mesh is one of logical shards (``make_mesh(..., ["cpu"] * S)``);
the JAX side runs on its 8 virtual CPU devices (tests/conftest.py) with
``coarse_pallas=False, refine_pallas=False, tail_pallas=False``, as its own
tests do. Weights: csg_demo (examples/assets/csg_demo.npz), loaded into both
packages. Bars, stated per test:
  * ``_shard_pos`` equal to JAX's ``_shard_pos_np`` entry for entry, for
    interleaved rows, contiguous bands (h % S != 0) and block orders;
    ``_assemble`` inverts it exactly;
  * ``make_mesh`` shapes, ``tp_mlp_shardings`` specs and
    ``shard_load_stats`` equal to JAX's; the schedule encoding round-trips,
    and a ladder longer than ``_ENC_MAX`` raises (JAX stores its length and
    decodes past the field, sharding.py:417);
  * ``render_image_sharded_staged`` at 96x96 with S = 1, 2, 4, 8 equal to
    the port's own ``render_staged`` bit for bit (the march is per-lane
    deterministic and a shard's rungs march each ray as the whole frame's
    do). ``compact_min=64`` keeps every shard's refine buckets real
    prefixes, as the whole frame's are: with the default 2048 a 1152-lane
    shard's buckets span it and march densely (``renderer._dense_rung``),
    with relaxation on in its entry rung, which moves t within eps and
    changes a few pixels. At S = 8 against JAX's sharded frame, the mixed-
    path bar of tests/test_render.py:85-101 (hit masks agree on >= 99%,
    >= 97% of common hits within 1e-3), with equal per-shard stats;
  * a refine overflow on a shard retries the frame widened and teaches the
    memo (tests/test_parallel.py's overflow config);
  * ``solve_surface_sharded`` equal to the port's ``solve_surface`` bit for
    bit, and to JAX's at hit masks >= 99% and |dt| <= 1e-4 on >= 99% of
    common hits;
  * ``pixel_train_step_sharded`` at S = 4 (noisy csg_demo, 32x32): loss
    within rtol 1e-5 and each leaf's gradient (the first Adam moment, a
    tenth of it) within |d| <= 1e-4 |g| (tests/test_torch_diff.py's bar)
    of the port's unsharded step and of JAX's sharded step, on the dense
    march and on a precomputed staged solve (the same solve for all three);
  * a zero-bias ``init_mlp`` net at Camera(), whose ray through the origin
    meets a ReLU tie in every unit: the pixel loss within rtol 1e-5 and the
    gradient within |d| <= 1e-4 |g| per leaf of JAX's, unsharded and at
    S = 4 (and NaN with ``torch.relu``'s zero gradient at ties);
  * ``dryrun.run(8)`` and ``run(3)`` complete on JAX's kind of nets
    (``init_mlp``, zero biases; the TP step inside holds its loss and
    gradients to the unsharded step's, rtol 1e-5).
"""
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cudaneuralrender_torch as ct  # noqa: E402
import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch.diff import implicit as t_implicit  # noqa: E402
from cudaneuralrender_torch.diff import train as t_train  # noqa: E402
from cudaneuralrender_torch.parallel import dryrun  # noqa: E402
from cudaneuralrender_torch.parallel import mesh as t_mesh  # noqa: E402
from cudaneuralrender_torch.parallel import sharding as t_sh  # noqa: E402
from cudaneuralrender_tpu.diff import train as j_train  # noqa: E402
from cudaneuralrender_tpu.parallel import mesh as j_mesh  # noqa: E402
from cudaneuralrender_tpu.parallel import sharding as j_sh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "examples", "assets", "csg_demo.npz")
CAM = dict(rotation_y=30.0, rotation_x=-20.0)
# The port's coarse phase (utils/config.py, set from the H100's chain
# errors), given to both packages: the JAX package's default is the TPU's.
LADDER = dict(coarse_precision=ct.RenderConfig.coarse_precision,
              coarse_eps=ct.RenderConfig.coarse_eps)
STAGED = dict(width=96, height=96, max_steps=600, march_impl="staged", compact_min=64,
              **LADDER)
JAX_OFF = dict(coarse_pallas=False, refine_pallas=False, tail_pallas=False)
# The JAX package's ladder (the FP32 coarse call to 0.05), for the bars
# below that were set on it and need the same coarse chain on both sides.
JAX_LADDER = dict(coarse_precision=cj.RenderConfig.coarse_precision,
                  coarse_eps=cj.RenderConfig.coarse_eps)
TRAIN = dict(width=32, height=32, scene="neural_raw", max_steps=300)


def _layers():
    with np.load(NPZ) as f:
        return [(f[f"w{i}"], f[f"b{i}"]) for i in range(len(f.files) // 2)]


def _noisy(layers, seed=7, scale=0.01):
    rng = np.random.default_rng(seed)
    return [(w + scale * rng.standard_normal(w.shape).astype(np.float32),
             b + scale * rng.standard_normal(b.shape).astype(np.float32)) for w, b in layers]


def _jax(layers):
    return [cj.DenseParams(jnp.asarray(w), jnp.asarray(b)) for w, b in layers]


def _tmesh(n):
    return t_mesh.make_mesh((n,), ("data",), ["cpu"] * n)


def _jmesh(n):
    return j_mesh.make_mesh((n,), ("data",), jax.devices()[:n])


@pytest.fixture(scope="module")
def params():
    return cj.load(NPZ), ct.load(NPZ, device="cpu")


@pytest.fixture(autouse=True)
def _fresh_memo():
    ct.reset_schedule_memo()
    cj.reset_schedule_memo()
    yield
    ct.reset_schedule_memo()
    cj.reset_schedule_memo()


def _mixed_bar(a, b):
    hit_a, hit_b = a[..., 3] > 0, b[..., 3] > 0
    assert (hit_a == hit_b).mean() >= 0.99
    both = hit_a & hit_b
    close = (np.abs(a - b).max(axis=-1)[both] <= 1e-3).mean()
    assert close >= 0.97, close


@pytest.mark.parametrize("h,w,n_shards,block", [
    (96, 96, 8, (16, 16)), (64, 64, 4, None), (30, 32, 4, (8, 8)), (32, 24, 3, (8, 16)),
    (1080, 1920, 8, (128, 128)),
])
def test_shard_pos_matches_jax_and_assemble_inverts_it(h, w, n_shards, block):
    pos = t_sh._shard_pos(h, w, n_shards, block)
    np.testing.assert_array_equal(pos, j_sh._shard_pos_np(h, w, n_shards, block))
    assert pos.dtype == np.int32 and not pos.flags.writeable
    # Every pixel once; each shard's pos-ascending outputs assemble to raster.
    flat = torch.as_tensor(np.sort(pos, axis=1).reshape(-1).astype(np.int64))
    np.testing.assert_array_equal(t_sh._assemble(flat, h, w, n_shards).numpy(),
                                  np.arange(h * w))
    rgba = torch.stack([flat.float(), -flat.float(), flat.float() * 2, flat.float()], dim=1)
    got = t_sh._assemble(rgba, h, w, n_shards).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_sh._assemble(jnp.asarray(rgba.numpy()), h, w,
                                                                 n_shards)))


def test_make_mesh_and_specs_match_jax():
    devs = jax.devices()[:8]
    for shape, names in (((8, 1), ("data", "model")), ((4, 2), ("data", "model")),
                         ((8,), ("data",))):
        assert t_mesh.make_mesh(shape, names, ["cpu"] * 8).shape == dict(
            j_mesh.make_mesh(shape, names, devs).shape)
    assert t_mesh.make_mesh(devices=["cpu"] * 8).shape == {"data": 8, "model": 1}
    with pytest.raises(ValueError, match="does not cover"):
        t_mesh.make_mesh((3, 2), ("data", "model"), ["cpu"] * 8)
    jm = j_mesh.make_mesh((4, 2), ("data", "model"), devs)
    tm = t_mesh.make_mesh((4, 2), ("data", "model"), ["cpu"] * 8)
    layers = [(np.zeros((3, 16), np.float32), np.zeros(16, np.float32)),
              (np.zeros((16, 16), np.float32), np.zeros(16, np.float32)),
              (np.zeros((16, 16), np.float32), np.zeros(16, np.float32)),
              (np.zeros((16, 1), np.float32), np.zeros(1, np.float32))]
    got = t_mesh.tp_mlp_shardings(ct.from_numpy_params(layers, device="cpu"), tm)
    want = j_mesh.tp_mlp_shardings(_jax(layers), jm)
    assert [(s.w, s.b) for s in got] == [(tuple(s.w.spec), tuple(s.b.spec)) for s in want]
    assert t_mesh.data_sharding(tm).spec == tuple(j_mesh.data_sharding(jm).spec)
    assert t_mesh.replicated(tm).spec == tuple(j_mesh.replicated(jm).spec)
    # device_put splits by a spec as JAX places a NamedSharding.
    x = torch.arange(16 * 16, dtype=torch.float32).reshape(16, 16)
    pieces = t_mesh.device_put(x, (None, "model"), tm)
    placed = jax.device_put(jnp.asarray(x.numpy()), want[2].w)
    for shard in placed.addressable_shards:
        i = devs.index(shard.device)
        np.testing.assert_array_equal(pieces[i // 2, i % 2].numpy(), np.asarray(shard.data))


def test_shard_load_stats_matches_jax():
    rng = np.random.default_rng(3)
    for fields in (dict(width=96, height=96), dict(width=96, height=96,
                                                   refine_caps=(4096, 2048, 512, 128))):
        cfg = dict(fields, march_impl="staged")
        k = 4
        per = rng.integers(0, 900, size=(8, 4 + k))
        stats = np.concatenate([[10, 300, 999, 0, 0], per.ravel()]).astype(np.int64)
        got = t_sh.shard_load_stats(stats, ct.RenderConfig(**cfg))
        want = j_sh.shard_load_stats(stats, cj.RenderConfig(**cfg))
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-12)


def test_schedule_encoding_round_trips_and_refuses_overlong_ladders():
    cfg = ct.RenderConfig(refine_schedule=((4, 16), (8, 24), (32, 64), (256, 0)),
                          mid_schedule=((2, 8), (4, 0)), refine_caps=(9000, 4000, 800, 64))
    v = t_sh._encode_sched(cfg)
    np.testing.assert_array_equal(v, j_sh._encode_sched(cj.RenderConfig(
        refine_schedule=cfg.refine_schedule, mid_schedule=cfg.mid_schedule,
        refine_caps=cfg.refine_caps)))
    assert t_sh._decode_sched(ct.RenderConfig(), v) == ct.RenderConfig().replace(
        refine_schedule=cfg.refine_schedule, mid_schedule=cfg.mid_schedule,
        refine_caps=cfg.refine_caps)
    full = tuple((2, 1) for _ in range(t_sh._ENC_MAX))
    assert t_sh._decode_sched(ct.RenderConfig(), t_sh._encode_sched(
        ct.RenderConfig(refine_schedule=full))).refine_schedule == full
    long = tuple((2, 1) for _ in range(t_sh._ENC_MAX + 1))
    with pytest.raises(ValueError, match="more than 16 rungs"):
        t_sh._encode_sched(ct.RenderConfig(refine_schedule=long))
    # JAX's encoding stores 17 and decodes a 17th rung out of the next field;
    # the port's decoder refuses any length beyond the field.
    jv = j_sh._encode_sched(cj.RenderConfig(refine_schedule=long))
    assert jv[0] == t_sh._ENC_MAX + 1
    with pytest.raises(ValueError, match="outside"):
        t_sh._decode_sched(ct.RenderConfig(), jv)
    bad = np.zeros_like(v)
    bad[0] = -1  # the vector rank 0 sends for a schedule it cannot encode
    with pytest.raises(ValueError):
        t_sh._decode_sched(ct.RenderConfig(), bad)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_staged_sharded_equals_render_staged(params, n_shards):
    _, pt = params
    cfg = ct.RenderConfig(**STAGED)
    cam = ct.Camera(**CAM)
    want = ct.render_staged(pt, cam, cfg).numpy()
    ct.reset_schedule_memo()
    stats = {}
    got = t_sh.render_image_sharded_staged(pt, cam, cfg, _tmesh(n_shards), stats_out=stats)
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["refine_overflow"] == 0 and stats["shade_excess"] == 0
    assert len(stats["shard_near"]) == n_shards
    assert sum(stats["shard_hits"]) == stats["hits"] == int((want[..., 3] > 0).sum())
    assert 0.0 < stats["predicted_scaling_efficiency"] <= 1.0


def test_staged_sharded_matches_jax(params):
    pj, pt = params
    sj, st = {}, {}
    # JAX's coarse phase off its kernel leaves the actives beyond its bucket
    # near: at the JAX package's ladder its near counts are the port's
    staged = dict(STAGED, **JAX_LADDER)
    a = np.asarray(j_sh.render_image_sharded_staged(
        pj, cj.Camera(**CAM), cj.RenderConfig(**staged, **JAX_OFF), _jmesh(8), stats_out=sj))
    b = t_sh.render_image_sharded_staged(pt, ct.Camera(**CAM), ct.RenderConfig(**staged),
                                         _tmesh(8), stats_out=st).numpy()
    _mixed_bar(a, b)
    for key in ("fast_path", "refine_overflow", "shade_excess"):
        assert st[key] == sj[key], key
    assert abs(st["hits"] - sj["hits"]) <= 0.01 * sj["hits"]
    np.testing.assert_allclose(st["shard_near"], sj["shard_near"], rtol=0.02)


def test_staged_sharded_matcap(params):
    """Matcap shading rides the shard body: equal to render_staged."""
    _, pt = params
    from cudaneuralrender_torch.utils import image_io

    matcap = torch.as_tensor(image_io.load_matcap(
        os.path.join(REPO, "benchmarks", "recovered_matcaps", "plane_1.png")))
    cfg = ct.RenderConfig(**STAGED, shading="matcap")
    want = ct.render_staged(pt, ct.Camera(**CAM), cfg, matcap=matcap).numpy()
    ct.reset_schedule_memo()
    got = t_sh.render_image_sharded_staged(pt, ct.Camera(**CAM), cfg, _tmesh(4), matcap=matcap)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="divisible"):
        t_sh.render_image_sharded_staged(pt, ct.Camera(), ct.RenderConfig(
            width=15, height=15, march_impl="staged"), _tmesh(8))


def test_staged_sharded_contiguous_bands(params):
    """96 rows over 9 shards (96 % 9 != 0) take contiguous bands: the object
    fills the middle bands (near-surface lanes up to 80% of a band against
    none in the outer ones), a band's refine bucket overflows, and the frame
    is rendered again widened (the layout's caveat, sharding.py). The
    widened schedule doubles every bucket where render_staged's retry
    resizes them from the frame's rung counts, so the two frames march
    different rungs: the mixed-path bar, with the overflow seen."""
    _, pt = params
    cfg = ct.RenderConfig(**STAGED)
    want = ct.render_staged(pt, ct.Camera(**CAM), cfg).numpy()
    ct.reset_schedule_memo()
    stats = {}
    got = t_sh.render_image_sharded_staged(pt, ct.Camera(**CAM), cfg, _tmesh(9), stats_out=stats)
    assert np.array_equal(t_sh._shard_pos(96, 96, 9, (128, 128)).min(axis=1),
                          np.arange(9) * 1024)
    assert not stats["fast_path"] and stats["shard_imbalance"] > 0.5
    _mixed_bar(got.numpy(), want)


def test_staged_sharded_animation_mode():
    """A 4-input net (the frame number as its 4th input) through the shard
    body, at two frames, equal to render_staged."""
    layers = [(np.asarray(l.w), np.asarray(l.b))
              for l in cj.init_mlp(jax.random.key(5), sizes=(4, 32, 32, 1))]
    pt = ct.from_numpy_params(layers, device="cpu")
    cfg = ct.RenderConfig(width=32, height=32, max_steps=200, march_impl="staged",
                          num_inputs=4, compact_min=64)
    cam = ct.Camera.from_cli(ry=25.0, zoom=3.5)  # the net fills less of the frame
    for frame in (0.0, 120.0):
        want = ct.render_staged(pt, cam, cfg, frame=frame).numpy()
        ct.reset_schedule_memo()
        stats = {}
        got = t_sh.render_image_sharded_staged(pt, cam, cfg, _tmesh(8), frame=frame,
                                               stats_out=stats)
        assert stats["fast_path"]
        np.testing.assert_array_equal(got.numpy(), want)


def test_staged_sharded_overflow_widens_and_teaches(params, monkeypatch):
    """A shard's refine overflow renders the frame again with every bucket
    doubled, until none overflows, and teaches the memo: the next frame
    dispatches the taught schedule at once (one program run). Here the taught buckets
    span the shards, whose hits then outgrow the shade bucket, so both
    frames end on the dense fallback, as JAX's do."""
    _, pt = params
    from cudaneuralrender_torch.render import renderer as r_t

    runs = []
    real = t_sh._staged_sharded_program

    def counting(params, camera, config, *args, **kw):
        runs.append(config.refine_schedule)
        return real(params, camera, config, *args, **kw)

    monkeypatch.setattr(t_sh, "_staged_sharded_program", counting)
    # at the JAX package's ladder, under which the buckets double down to 1
    cfg = ct.RenderConfig(width=32, height=32, max_steps=300, march_impl="staged",
                          compact_min=8, refine_schedule=((1024, 4), (1024, 0)), **JAX_LADDER)
    stats = {}
    img = t_sh.render_image_sharded_staged(pt, ct.Camera(), cfg, _tmesh(8), stats_out=stats)
    assert not stats["fast_path"]
    taught = r_t.memo_lookup(pt, cfg)
    # Doubled until the buckets span the shards: 1024 -> 512 -> ... -> 1.
    assert runs == [((d, 4), (d, 0)) for d in (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1)]
    assert taught.refine_schedule == runs[-1]
    runs.clear()
    stats2 = {}
    again = t_sh.render_image_sharded_staged(pt, ct.Camera(), cfg, _tmesh(8), stats_out=stats2)
    assert runs == [taught.refine_schedule] and stats2["refine_overflow"] == 0
    np.testing.assert_array_equal(again.numpy(), img.numpy())
    safe = t_sh.render_image_sharded_staged(
        pt, ct.Camera(), cfg.replace(refine_schedule=((4, 16), (32, 0))), _tmesh(8)).numpy()
    assert ((img.numpy()[..., 3] > 0) == (safe[..., 3] > 0)).mean() > 0.99


def test_solve_surface_sharded_matches(params):
    pj, pt = params
    from cudaneuralrender_torch.diff import solve as t_solve

    cam = dict(rotation_y=20.0)
    stats = {}
    t_sh_, hit_sh = t_sh.solve_surface_sharded(pt, ct.Camera(**cam), ct.RenderConfig(**STAGED),
                                               _tmesh(8), stats_out=stats)
    ct.reset_schedule_memo()
    t1, hit1 = t_solve.solve_surface(pt, ct.Camera(**cam), ct.RenderConfig(**STAGED))
    assert torch.equal(t_sh_, t1) and torch.equal(hit_sh, hit1)
    assert stats["refine_overflow"] == 0 and len(stats["shard_near"]) == 8
    tj, hj = j_sh.solve_surface_sharded(pj, cj.Camera(**cam), cj.RenderConfig(**STAGED, **JAX_OFF),
                                        _jmesh(8))
    tj, hj = np.asarray(tj), np.asarray(hj)
    hit = hit_sh.numpy()
    assert (hit == hj).mean() >= 0.99
    assert (np.abs(t_sh_.numpy() - tj)[hit & hj] <= 1e-4).mean() >= 0.99


def _moments_t(state):
    return [m.detach().numpy() for m in t_train._flat(state.opt_state.mu)]


def _moments_j(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state.opt_state[0].mu)]


def _assert_grads(want, got, rel=1e-4):
    """|d| <= rel |g| per leaf; the first Adam moments are 0.1 g."""
    assert sum(float(np.linalg.norm(a)) for a in want) > 0
    for i, (a, b) in enumerate(zip(want, got)):
        delta, norm = np.linalg.norm(a - b), np.linalg.norm(a)
        assert delta <= rel * norm, (i, delta, norm)


@pytest.fixture(scope="module")
def train_case():
    """Noisy csg_demo (weights and biases, seed 7) and the target: csg_demo
    from another yaw."""
    layers = _noisy(_layers())
    target = np.array(cj.render_image(_jax(_layers()), cj.Camera(rotation_y=24.0),
                                      cj.RenderConfig(**TRAIN)))
    return layers, target


@pytest.mark.parametrize("solve", ["dense", "staged_solve"])
def test_pixel_train_step_sharded_matches(train_case, solve):
    """S = 4, the surface solved by the dense march inside the step, or by
    ``solve_surface_sharded`` before it; the unsharded step and JAX's
    sharded step get the same solve."""
    layers, target = train_case
    cfg = ct.RenderConfig(**TRAIN)
    cam = ct.Camera(rotation_y=20.0)
    s0 = t_train.init_train_state(ct.from_numpy_params(layers, device="cpu"))
    tgt = torch.as_tensor(target)
    j0 = j_train.init_train_state(_jax(layers), lr=1e-3)
    kw, j_kw = {}, {}
    if solve == "staged_solve":
        scfg = cfg.replace(march_impl="staged", compact_min=64)
        kw = dict(zip(("t_star", "hit"), t_sh.solve_surface_sharded(s0.params, cam, scfg,
                                                                    _tmesh(4))))
        j_kw = {k: jnp.asarray(v.numpy()) for k, v in kw.items()}
        ref_state, ref_loss = t_train._pixel_grad_step_from_t(s0, cam, tgt, kw["t_star"],
                                                               kw["hit"], cfg, 1e-3)
    else:
        ref_state, ref_loss = t_train.pixel_train_step(s0, cam, tgt, cfg)
    state, loss = t_sh.pixel_train_step_sharded(s0, cam, tgt, cfg, _tmesh(4), **kw)
    j_state, j_loss = j_sh.pixel_train_step_sharded(
        j0, cj.Camera(rotation_y=20.0), jnp.asarray(target), cj.RenderConfig(**TRAIN),
        _jmesh(4), **j_kw)
    assert int(state.step) == 1
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    _assert_grads(_moments_t(ref_state), _moments_t(state))
    _assert_grads(_moments_j(j_state), _moments_t(state))
    with pytest.raises(ValueError, match="both"):
        t_sh.pixel_train_step_sharded(s0, cam, tgt, cfg, _tmesh(4), t_star=torch.zeros(1024))


@pytest.mark.parametrize("n_shards", [0, 4])
def test_zero_bias_net_at_the_origin_matches_jax(n_shards, monkeypatch):
    """``init_mlp``'s zero-bias net (the dry run's, seed 3) at Camera() and
    16x8: pixel (4, 8)'s ray meets the surface at the origin, where every
    pre-activation is exactly 0. JAX's ``jnp.maximum`` gives each tie the
    gradient 1/2; the port's differentiated chain (``mlp.relu_tie``) must
    too, or the normal there is NaN. The loss within rtol 1e-5 and each
    leaf's gradient within |d| <= 1e-4 |g| of JAX's, and the same step with
    ``torch.relu`` gives a NaN loss. Unsharded (0), both steps take the
    port's dense solve: the two packages' 16-step dense marches part at one
    marginal lane, pixel (7, 7), which only the port converges. At S = 4
    each sharded step solves for itself (the shards' marches agree)."""
    net = ct.init_mlp(torch.Generator().manual_seed(3), device="cpu")
    layers = ct.models.mlp.to_numpy_params(net)
    assert not any(b.any() for _, b in layers)
    cfg = ct.RenderConfig(width=16, height=8, scene="neural_raw", max_steps=16)
    j_cfg = cj.RenderConfig(width=16, height=8, scene="neural_raw", max_steps=16)
    tgt = np.zeros((8, 16, 4), np.float32)
    j0 = j_train.init_train_state(_jax(layers), lr=1e-3)
    origin, dirs, _ = t_implicit._rays(net, ct.Camera(), cfg)
    t_star, hit = t_implicit._solve_t_dense(net, cfg, 0.0, origin, dirs)

    def step():
        s0 = t_train.init_train_state(ct.from_numpy_params(layers, device="cpu"))
        if n_shards:
            return t_sh.pixel_train_step_sharded(s0, ct.Camera(), torch.as_tensor(tgt), cfg,
                                                 _tmesh(n_shards))
        return t_train._pixel_grad_step_from_t(s0, ct.Camera(), torch.as_tensor(tgt),
                                               t_star, hit, cfg, 1e-3)

    state, loss = step()
    if n_shards:
        j_state, j_loss = j_sh.pixel_train_step_sharded(
            j0, cj.Camera(), jnp.asarray(tgt), j_cfg, _jmesh(n_shards))
    else:
        j_state, j_loss = j_train._pixel_grad_step_from_t(
            j0, cj.Camera(), jnp.asarray(tgt), jnp.asarray(t_star.numpy()),
            jnp.asarray(hit.numpy()), j_cfg, 1e-3)
    assert np.isfinite(float(j_loss))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    _assert_grads(_moments_j(j_state), _moments_t(state))
    monkeypatch.setattr(ct.models.mlp, "relu_tie", torch.relu)
    assert np.isnan(float(step()[1]))


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun(n):
    dryrun.run(n, device="cpu")

