"""The PyTorch package's training (``diff/train.py``) against the JAX
package's, on the CPU.

Bars, stated per test:
  * the out-of-place Adam on identical gradients, 5 steps, against
    ``optax.adam`` and against ``torch.optim.Adam``: params and both
    moments within rtol 1e-6, atol 1e-9 (against torch.optim in float32
    the moments, in float64 everything: see the test);
  * 3 steps of ``pixel_train_step_fast`` (and 2 of the dense
    ``pixel_train_step``) from the same noisy csg_demo state in both
    packages, at 32x32 (24x24 dense) with ``coarse_pallas=False,
    refine_pallas=False`` on the JAX side: losses within rtol 1e-4, >= 99.9%
    of parameter entries within 1e-6 + 1e-4 |x|, and every entry within
    2 lr steps (the most Adam moves two runs apart when a near-zero
    gradient flips sign); with ``compact_min=64`` the pipelined steps take
    the packed path;
  * ``train_loop_fast`` against the same steps taken one by one (losses
    and params rtol 1e-6), and the forced-overflow redo (``compact_min=8``,
    ``refine_schedule=((1024, 4), (1024, 0))``, tests/test_diff.py:447-466);
  * ``save_train_state`` / ``load_train_state``: resuming is bit-identical
    to an uninterrupted run; a JAX-saved state loads in this package and
    the other way round, each leaf bit-equal; shape, dtype and leaf-count
    mismatches raise;
  * 25 steps of ``pixel_train_step_fast`` and of ``pixel_train_step`` from
    tests/test_diff.py's sphere-distilled start bring the best loss below
    0.85 of the first (that file's bar);
  * ``fit_sdf`` reduces the loss; each example runs 2 steps on the CPU at
    16x16.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import cudaneuralrender_torch as ct  # noqa: E402
import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch.diff import train as t_train  # noqa: E402
from cudaneuralrender_tpu.diff import train as j_train  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "examples", "assets", "csg_demo.npz")
LR = 1e-3
# The port's coarse phase (utils/config.py, set from the H100's chain
# errors), given to both packages: the JAX package's default is the TPU's.
LADDER = dict(coarse_precision=ct.RenderConfig.coarse_precision,
              coarse_eps=ct.RenderConfig.coarse_eps)
FIELDS = dict(width=32, height=32, scene="neural_raw", max_steps=300, march_impl="staged",
              coarse_pallas=False, refine_pallas=False, **LADDER)
PATHS = {"image": {}, "packed": dict(compact_min=64)}


def _csg():
    with np.load(NPZ) as f:
        return [(f[f"w{i}"], f[f"b{i}"]) for i in range(len(f.files) // 2)]


def _noisy(layers, seed=7, scale=0.01):
    rng = np.random.default_rng(seed)
    return [(w + scale * rng.standard_normal(w.shape).astype(np.float32),
             b + scale * rng.standard_normal(b.shape).astype(np.float32)) for w, b in layers]


def _tiny():
    return [(np.asarray(l.w), np.asarray(l.b))
            for l in cj.init_mlp(jax.random.key(3), sizes=(3, 16, 16, 1))]


def _jax(layers):
    return [cj.DenseParams(jnp.asarray(w), jnp.asarray(b)) for w, b in layers]


def _torch(layers):
    return ct.from_numpy_params(layers, device="cpu")


def _leaves_t(state):
    return [t.detach().numpy() for t in t_train._state_leaves(state)]


def _leaves_j(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


def _target():
    cfg = cj.RenderConfig(**FIELDS).replace(march_impl="while")
    return np.asarray(cj.render_image(_jax(_csg()), cj.Camera(rotation_y=24.0), cfg))


def _assert_params_close(a, b, steps):
    a = np.concatenate([x.ravel() for x in a])
    b = np.concatenate([x.ravel() for x in b])
    d = np.abs(a - b)
    assert (d <= 1e-6 + 1e-4 * np.abs(a)).mean() >= 0.999
    assert d.max() <= 2 * LR * steps


def _adam_run(reference, layers, grads):
    """5 steps of ``reference`` ("port", "optax" or "torch.optim") on the
    same gradients: (params, mu, nu) as lists of arrays in tree order."""
    if reference == "port":
        opt = t_train.make_optimizer(LR)
        dtype = torch.float64 if layers[0][0].dtype == np.float64 else torch.float32
        params = t_train._trainable(ct.from_numpy_params(layers, device="cpu", dtype=dtype))
        state = opt.init(params)
        for g in grads:
            params, state = opt.update([torch.tensor(x) for gl in g for x in gl], state, params)
        assert int(state.count) == len(grads) and state.count.dtype == torch.int32
        out = [t_train._flat(params), t_train._flat(state.mu), t_train._flat(state.nu)]
    elif reference == "optax":
        opt = optax.adam(LR)
        p = _jax(layers)
        s = opt.init(p)
        for g in grads:
            u, s = opt.update(_jax(g), s, p)
            p = optax.apply_updates(p, u)
        out = [jax.tree_util.tree_leaves(x) for x in (p, s[0].mu, s[0].nu)]
    else:
        p = [torch.nn.Parameter(torch.tensor(x)) for wb in layers for x in wb]
        opt = torch.optim.Adam(p, lr=LR)
        for g in grads:
            for q, x in zip(p, (x for gl in g for x in gl)):
                q.grad = torch.tensor(x)
            opt.step()
        out = [p, [opt.state[q]["exp_avg"] for q in p], [opt.state[q]["exp_avg_sq"] for q in p]]
    return [[x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in xs]
            for xs in out]


@pytest.mark.parametrize("reference,dtype", [("optax", np.float32),
                                             ("torch.optim", np.float32),
                                             ("torch.optim", np.float64)])
def test_adam_matches_reference(reference, dtype):
    """rtol 1e-6, atol 1e-9 on params, mu and nu after 5 steps, from
    zero-initialized biases (whose values are their accumulated updates).

    optax (and so this package) forms 1 - b2^t in the parameters' dtype and
    the moment weight 1 - b2 in float64; torch.optim.Adam forms both in
    float64. In float32, 1 - float32(0.999) is 1.3e-5 of itself away from
    1 - 0.999, which moves a zero-initialized bias by about 1e-5 of its
    updates: against torch.optim the float32 run holds the moments to the
    bar, and the float64 run, where that rounding is gone, everything."""
    layers = [(w.astype(dtype), b.astype(dtype)) for w, b in _tiny()]
    rng = np.random.default_rng(5)
    grads = [[(rng.standard_normal(w.shape).astype(dtype) * 10.0 ** -k,
               rng.standard_normal(b.shape).astype(dtype) * 10.0 ** -k)
              for w, b in layers] for k in range(5)]
    got = _adam_run("port", layers, grads)
    want = _adam_run(reference, layers, grads)
    if reference == "torch.optim" and dtype == np.float32:
        got, want = got[1:], want[1:]
    for got_l, want_l in zip(got, want):
        for a, b in zip(got_l, want_l):
            assert a.dtype == b.dtype == dtype
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)


@pytest.fixture(scope="module")
def target():
    return _target()


@pytest.mark.parametrize("path", list(PATHS))
def test_pixel_train_step_fast_matches_jax(target, path):
    fields = dict(FIELDS, **PATHS[path])
    layers = _noisy(_csg())
    sj, st_j, loss_j = j_train.init_train_state(_jax(layers), LR), {}, []
    s, st, loss_t = t_train.init_train_state(_torch(layers), LR), {}, []
    for i in range(3):
        sj, lj = j_train.pixel_train_step_fast(sj, cj.Camera(rotation_y=20.0 + 2 * i),
                                               jnp.asarray(target), cj.RenderConfig(**fields),
                                               LR, stats_out=st_j)
        s, lt = t_train.pixel_train_step_fast(s, ct.Camera(rotation_y=20.0 + 2 * i),
                                              torch.tensor(target), ct.RenderConfig(**fields),
                                              LR, stats_out=st)
        assert lt.shape == () and not lt.requires_grad
        loss_j.append(float(lj))
        loss_t.append(float(lt))
        assert st["fast_path"] == st_j["fast_path"]
        assert abs(st["hits"] - st_j["hits"]) <= 0.005 * st_j["hits"]
    assert st["fast_path"]  # the pipelined steps (step 1 retries at compact_min=64)
    if path == "packed":
        assert ct.render.schedule.conv_within(ct.RenderConfig(**fields)) is not None
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4)
    assert int(s.step) == 3 and int(s.opt_state.count) == 3
    _assert_params_close(_leaves_j(sj.params), _leaves_t(s)[:len(layers) * 2], 3)


def test_pixel_train_step_dense_matches_jax():
    side = 24
    fields = dict(FIELDS, width=side, height=side, march_impl="while")
    cfg_j = cj.RenderConfig(**fields)
    target = np.asarray(cj.render_image(_jax(_csg()), cj.Camera(rotation_y=24.0), cfg_j))
    layers = _noisy(_csg())
    sj = j_train.init_train_state(_jax(layers), LR)
    s = t_train.init_train_state(_torch(layers), LR)
    for i in range(2):
        sj, lj = j_train.pixel_train_step(sj, cj.Camera(rotation_y=20.0), jnp.asarray(target),
                                          cfg_j, LR)
        s, lt = t_train.pixel_train_step(s, ct.Camera(rotation_y=20.0), torch.tensor(target),
                                         ct.RenderConfig(**fields), LR)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)
    _assert_params_close(_leaves_j(sj.params), _leaves_t(s)[:len(layers) * 2], 2)


@pytest.fixture(scope="module")
def sphere_start():
    """tests/test_diff.py's tiny_params (the (3,16,16,1) net distilled by
    the JAX package to a sphere of radius 0.7), its 16x16 target, and the
    same start: every leaf plus 0.01 jax.random.normal(key(7))."""
    from cudaneuralrender_tpu.diff import implicit as j_imp
    from cudaneuralrender_tpu.models import mlp as j_mlp
    from cudaneuralrender_tpu.ops import sdf as j_sdf

    def sample(key, n):
        pts = jax.random.uniform(key, (n, 3), minval=-1.2, maxval=1.2)
        return pts, j_sdf.sphere(pts, 0.7)

    params, history = j_train.fit_sdf(j_mlp.init_mlp(jax.random.key(3), sizes=(3, 16, 16, 1)),
                                      sample, steps=300, batch=2048, lr=3e-3)
    assert history[-1] < 0.002, history[-1]
    cfg = cj.RenderConfig(width=16, height=16, scene="neural_raw", max_steps=128)
    target = j_imp.render_image_diff(params, cj.Camera(), cfg)
    noisy = jax.tree_util.tree_map(
        lambda x: x + 0.01 * jax.random.normal(jax.random.key(7), x.shape), params)
    return [(np.asarray(l.w), np.asarray(l.b)) for l in noisy], np.asarray(target)


@pytest.mark.parametrize("step", ["pixel_train_step_fast", "pixel_train_step"])
def test_pixel_train_step_reduces_loss(sphere_start, step):
    """tests/test_diff.py:144-160 and :275-291 run on this package from the
    same start: 25 Adam steps at 16x16 bring the best loss below 0.85 of
    the first (Adam oscillates on this objective, discontinuous at the
    silhouette; the bar reads the best iterate)."""
    layers, target = sphere_start
    cfg = ct.RenderConfig(width=16, height=16, scene="neural_raw", max_steps=128)
    state, history = t_train.init_train_state(_torch(layers), 1e-3), []
    for _ in range(25):
        state, loss = getattr(t_train, step)(state, ct.Camera(), torch.tensor(target), cfg,
                                             1e-3)
        history.append(float(loss))
    assert min(history) < 0.85 * history[0], history


@pytest.mark.parametrize("path", list(PATHS))
def test_train_loop_fast_matches_sequential(target, path):
    cfg = ct.RenderConfig(**dict(FIELDS, **PATHS[path]))
    cams = [ct.Camera(rotation_y=20.0 + 2 * i) for i in range(4)]
    s0 = t_train.init_train_state(_torch(_noisy(_csg())), LR)
    seq, seq_losses, st = s0, [], {}
    for cam in cams:
        seq, loss = t_train.pixel_train_step_fast(seq, cam, torch.tensor(target), cfg, LR,
                                                  stats_out=st)
        seq_losses.append(float(loss))
    stats = []
    loop, loop_losses = t_train.train_loop_fast(s0, cams, torch.tensor(target), cfg, LR,
                                                stats_out=stats)
    assert len(stats) == 4 and all(x["fast_path"] for x in stats)
    np.testing.assert_allclose(loop_losses, seq_losses, rtol=1e-6)
    for a, b in zip(_leaves_t(loop), _leaves_t(seq)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_train_loop_fast_overflow_redo():
    """Tiny refine buckets fail the fast path mid-loop: the loop rolls back
    and redoes the step synchronously, as JAX's does, with the same
    losses (rtol 1e-4). At the JAX package's ladder: at the port's
    coarse_eps the second step's solve has a lane at the 200-step budget's
    edge (JAX resolves it at step 200, the port at 204)."""
    fields = dict(FIELDS, max_steps=200, compact_min=8,
                  refine_schedule=((1024, 4), (1024, 0)))
    fields.update(coarse_precision=cj.RenderConfig.coarse_precision,
                  coarse_eps=cj.RenderConfig.coarse_eps)
    cams = [dict(rotation_y=20.0 + 2 * i) for i in range(3)]
    layers = _csg()
    cj.reset_schedule_memo()
    _, loss_j = j_train.train_loop_fast(j_train.init_train_state(_jax(layers), LR),
                                        [cj.Camera(**c) for c in cams],
                                        jnp.zeros((32, 32, 4), jnp.float32),
                                        cj.RenderConfig(**fields), LR)
    cj.reset_schedule_memo()
    ct.reset_schedule_memo()
    stats = []
    state, loss_t = t_train.train_loop_fast(t_train.init_train_state(_torch(layers), LR),
                                            [ct.Camera(**c) for c in cams],
                                            torch.zeros(32, 32, 4), ct.RenderConfig(**fields),
                                            LR, stats_out=stats)
    ct.reset_schedule_memo()
    assert len(loss_t) == 3 and np.isfinite(loss_t).all()
    assert not stats[0]["fast_path"]  # the seed step overflowed and retried
    assert int(state.step) == 3
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4)


def _sphere_batch(generator, n, radius=0.5):
    pts = torch.rand((n, 3), generator=generator) * 2.0 - 1.0
    return pts, torch.linalg.vector_norm(pts, dim=-1) - radius


def test_train_state_resume_bit_identical(tmp_path):
    g = torch.Generator().manual_seed(0)
    batches = [_sphere_batch(g, 256) for _ in range(5)]
    state = t_train.init_train_state(_torch(_tiny()), LR)
    for pts, d in batches[:3]:
        state, _ = t_train.sdf_train_step(state, pts, d, LR, eikonal_weight=0.1)
    path = str(tmp_path / "ckpt.npz")
    t_train.save_train_state(path, state)
    resumed = t_train.load_train_state(path, t_train.init_train_state(_torch(_tiny()), LR))
    assert int(resumed.step) == 3
    cont, res = state, resumed
    for pts, d in batches[3:]:
        cont, loss_a = t_train.sdf_train_step(cont, pts, d, LR, eikonal_weight=0.1)
        res, loss_b = t_train.sdf_train_step(res, pts, d, LR, eikonal_weight=0.1)
        assert float(loss_a) == float(loss_b)
    for a, b in zip(_leaves_t(cont), _leaves_t(res)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_train_state_crosses_packages(tmp_path, direction):
    """One ``leaf{i}`` per tensor in the JAX tree order: params, the Adam
    count, mu, nu, step; each leaf arrives bit-equal."""
    path = str(tmp_path / "state.npz")
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    d = (np.linalg.norm(pts, axis=-1) - 0.5).astype(np.float32)
    if direction == "jax_to_torch":
        state = j_train.init_train_state(_jax(_tiny()), LR)
        for _ in range(2):
            state, _ = j_train.sdf_train_step(state, jnp.asarray(pts), jnp.asarray(d), LR)
        j_train.save_train_state(path, state)
        loaded = t_train.load_train_state(path, t_train.init_train_state(_torch(_tiny()), LR))
        saved, got = _leaves_j(state), _leaves_t(loaded)
        assert loaded.params[0].w.requires_grad
    else:
        state = t_train.init_train_state(_torch(_tiny()), LR)
        for _ in range(2):
            state, _ = t_train.sdf_train_step(state, torch.tensor(pts), torch.tensor(d), LR)
        t_train.save_train_state(path, state)
        loaded = j_train.load_train_state(path, j_train.init_train_state(_jax(_tiny()), LR))
        saved, got = _leaves_t(state), _leaves_j(loaded)
    assert len(saved) == len(got) == 6 * 3 + 2
    for a, b in zip(saved, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[6].dtype == np.int32 and got[6] == 2 and got[-1] == 2


@pytest.mark.parametrize("mismatch", ["shape", "dtype", "leaves"])
def test_load_train_state_rejects_mismatch(tmp_path, mismatch):
    path = str(tmp_path / "ckpt.npz")
    state = t_train.init_train_state(_torch(_tiny()), LR)
    t_train.save_train_state(path, state)
    if mismatch == "shape":
        template = t_train.init_train_state(
            _torch([(np.zeros((3, 8), np.float32), np.zeros(8, np.float32))]
                   + [(np.zeros((8, 16), np.float32), np.zeros(16, np.float32))]
                   + _tiny()[2:]), LR)
    elif mismatch == "dtype":
        with np.load(path) as f:
            leaves = {k: f[k] for k in f.files}
        leaves["leaf0"] = leaves["leaf0"].astype(np.float64)
        np.savez(path, **leaves)
        template = state
    else:  # one layer fewer
        template = t_train.init_train_state(_torch(_tiny()[:1] + [
            (np.zeros((16, 1), np.float32), np.zeros(1, np.float32))]), LR)
    with pytest.raises(ValueError):
        t_train.load_train_state(path, template)


def test_fit_sdf_reduces_loss():
    params, history = t_train.fit_sdf(_torch(_tiny()), _sphere_batch, steps=40, batch=512,
                                      lr=3e-3, seed=1)
    assert len(history) == 40 and np.isfinite(history).all()
    assert np.mean(history[-5:]) < 0.5 * np.mean(history[:5])
    assert isinstance(params, ct.MLP)


@pytest.mark.parametrize("example", ["train_sdf", "train_animated", "inverse_render"])
def test_example_runs(tmp_path, example):
    args = [sys.executable, "-m", f"cudaneuralrender_torch.examples.{example}",
            "--steps", "2", "--device", "cpu"]
    if example == "inverse_render":
        args += ["--res", "16", "--fast"]
    else:
        args += ["--batch", "256", "--render", "16", "--out", str(tmp_path / example)]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(args, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "loss" in out.stdout
    if example != "inverse_render":
        assert (tmp_path / f"{example}.npz").exists()
