"""Warm-started and chunked sequences of the PyTorch package against the
JAX package's, on the CPU.

csg_demo weights, 48x48, Camera(rotation_x=-20, rotation_y=30+i) (a
1-degree orbit), max_steps 300:
  * ``march.init_state``'s warm lanes against the JAX package's (four lanes:
    warm, -inf, 0, clipped to tfar), within 1e-6 (tests/test_render.py:258);
  * ``render_sequence(warm_start=True)`` in both lane orders: the default
    coarse_block (128x128: the identity at 48x48) and (16, 16), a real
    block permutation. Against this package's cold sequence, the bars of
    tests/test_render.py:236-300 (frame 0 bit-equal; later frames' hit
    masks agree on > 0.995 and pixels are equal on > 0.98); against the JAX
    package's warm sequence, the mixed-path bar (hits agree >= 99%, >= 97%
    of common hits within 1e-3);
  * ``render_sequence(chunk=k)``, k = 2 and 4, 5 frames of many_sphere
    whose frame numbers vary (the tail chunk padded): equal to ``chunk=1``
    bit for bit with equal ``stats_out`` (on the CPU the chunk runs frame
    by frame; the card's CUDA graphs are held to the same bar in
    tests/test_torch_cuda.py), and to the JAX package's ``chunk=k`` at the
    mixed-path bar;
  * ``frame_reads_host`` against the marches a frame actually runs outside
    the kernel, and a host-reading config (``refine_pallas=False``) with
    ``chunk=4`` equal to ``chunk=1``;
  * a frame given as a [] tensor and a pose tensor (a CUDA graph's inputs)
    against the float frame and the Camera, bit for bit;
  * the CLI's ``--spin --warm-start`` at 16x16, resuming.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import cudaneuralrender_torch as ct  # noqa: E402
import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch.ops import camera as camera_t  # noqa: E402
from cudaneuralrender_torch.ops import march as march_t  # noqa: E402
from cudaneuralrender_torch.render import renderer as renderer_t  # noqa: E402
from cudaneuralrender_torch.utils import image_io  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "examples", "assets")
H5 = os.path.join(ASSETS, "csg_demo.h5")
ANIM = os.path.join(ASSETS, "anim_demo.h5")
SIDE = 48
STEPS = 300
# The port's coarse phase (utils/config.py, set from the H100's chain
# errors), given to both packages: the JAX package's default is the TPU's.
LADDER = dict(coarse_precision=ct.RenderConfig.coarse_precision,
              coarse_eps=ct.RenderConfig.coarse_eps)


@pytest.fixture(scope="module")
def params():
    return cj.load(H5), ct.load(H5, device="cpu")


def _cams(pkg, n):
    return [pkg.Camera(rotation_x=-20.0, rotation_y=30.0 + i) for i in range(n)]


def _mixed_bar(a, b):
    hit_a, hit_b = a[..., 3] > 0, b[..., 3] > 0
    assert (hit_a == hit_b).mean() >= 0.99
    both = hit_a & hit_b
    assert both.sum() > 50
    close = np.all(np.abs(b[both] - a[both]) < 1e-3, axis=-1).mean()
    assert close >= 0.97, close


def test_init_state_warm_matches_jax():
    from cudaneuralrender_tpu.ops import march as march_j
    import jax.numpy as jnp

    origin = np.array([0.0, 0.0, -2.0], np.float32)
    dirs = np.array([[0.0, 0.0, 1.0]] * 4, np.float32)
    t_init = np.array([1.5, -np.inf, 0.0, 100.0], np.float32)
    want = march_j.init_state(jnp.asarray(origin), jnp.asarray(dirs), (0, 0, 0), 1.2,
                              t_init=jnp.asarray(t_init), warm_margin=0.1)
    got = march_t.init_state(torch.from_numpy(origin), torch.from_numpy(dirs), (0, 0, 0), 1.2,
                             t_init=torch.from_numpy(t_init), warm_margin=0.1)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-6)
    np.testing.assert_allclose(got.budget.numpy(), np.asarray(want.budget), rtol=1e-6)
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    cold = march_t.init_state(torch.from_numpy(origin), torch.from_numpy(dirs), (0, 0, 0), 1.2)
    np.testing.assert_array_equal(got.t[1:3].numpy(), cold.t[1:3].numpy())
    tnear, tfar, _ = march_t.intersect_sphere(torch.from_numpy(origin), torch.from_numpy(dirs),
                                              (0, 0, 0), 1.2)
    assert got.t[0].item() == pytest.approx(1.4, rel=1e-6)
    assert got.t[3].item() == tfar[3].item()
    assert got.budget[0].item() == pytest.approx((tfar[0] - (1.4 - tnear[0])).item(), rel=1e-6)


@pytest.mark.parametrize("block", [(128, 128), (16, 16)], ids=["default_block", "block16"])
def test_warm_sequence_matches_cold_and_jax(params, block):
    pj, pt = params
    kw = dict(width=SIDE, height=SIDE, max_steps=STEPS, march_impl="staged", coarse_block=block,
              **LADDER)
    ct.reset_schedule_memo()
    cold = ct.render_sequence(pt, _cams(ct, 3), ct.RenderConfig(**kw))
    ct.reset_schedule_memo()
    stats = []
    warm = ct.render_sequence(pt, _cams(ct, 3), ct.RenderConfig(**kw), warm_start=True,
                              stats_out=stats)
    cj.reset_schedule_memo()
    jax_warm = cj.render_sequence(pj, _cams(cj, 3), cj.RenderConfig(**kw), warm_start=True)
    assert all(s["fast_path"] for s in stats)
    np.testing.assert_array_equal(warm[0].numpy(), cold[0].numpy())
    for c, w in zip(cold[1:], warm[1:]):
        c, w = c.numpy(), w.numpy()
        assert ((c[..., 3] > 0) == (w[..., 3] > 0)).mean() > 0.995
        assert np.all(c == w, axis=-1).mean() > 0.98
    for a, b in zip(jax_warm, warm):
        _mixed_bar(np.asarray(a), b.numpy())


def test_warm_state_hand_off_order(params):
    """The outgoing (t, hit) comes back in the lane order the next frame
    consumes: block-major (the permutation ``_block_order`` gives) when the
    coarse pass runs block-major, image order otherwise."""
    _, pt = params
    for block in ((16, 16), ()):
        cfg = ct.RenderConfig(width=SIDE, height=SIDE, max_steps=STEPS, march_impl="staged",
                              coarse_block=block)
        ct.reset_schedule_memo()
        _, pr, _, (t, hit) = renderer_t._render_scheduled(pt, _cams(ct, 1)[0], cfg, None, 0.0,
                                                          return_state=True)
        t_img, hit_img = ct.compaction.sort_restore_leaves(pr.pos, (pr.t, pr.converged))
        order = (renderer_t._block_order(SIDE, SIDE, *block, torch.device("cpu")).long()
                 if block else torch.arange(SIDE * SIDE))
        assert renderer_t._warm_block_order(cfg) == bool(block)
        np.testing.assert_array_equal(t.numpy(), t_img[order].numpy())
        np.testing.assert_array_equal(hit.numpy(), hit_img[order].numpy())


@pytest.mark.parametrize("k", [2, 4])
def test_chunk_matches_per_frame_and_jax(params, k):
    pj, pt = params
    kw = dict(width=SIDE, height=SIDE, max_steps=STEPS, march_impl="staged",
              scene="many_sphere", rgba_packed=False, **LADDER)
    frames = [float(7 * i) for i in range(5)]
    out = {}
    for chunk in (1, k):
        ct.reset_schedule_memo()
        stats = []
        out[chunk] = (ct.render_sequence(pt, _cams(ct, 5), ct.RenderConfig(**kw), frames=frames,
                                         stats_out=stats, chunk=chunk), stats)
    assert len(out[k][0]) == 5
    assert out[k][1] == out[1][1]
    for a, b in zip(out[1][0], out[k][0]):
        np.testing.assert_array_equal(b.numpy(), a.numpy())
    cj.reset_schedule_memo()
    jax_out = cj.render_sequence(pj, _cams(cj, 5), cj.RenderConfig(**kw), frames=frames, chunk=k)
    for a, b in zip(jax_out, out[k][0]):
        _mixed_bar(np.asarray(a), b.numpy())


HOST_CASES = {
    "default": dict(),
    "refine_off": dict(refine_pallas=False),
    "coarse_off": dict(coarse_pallas=False),
    "full": dict(march_precision="full"),
    "relax_newton": dict(relax_newton=True),
    "mid_eps": dict(mid_eps=1e-3),
    "tail_pallas": dict(tail_pallas=True, refine_pallas=False),
    "small_image": dict(width=32, height=32),
    "sphere_scene": dict(scene="sphere"),
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_frame_reads_host_matches_the_marches(params, case, monkeypatch):
    """``frame_reads_host`` (which decides whether ``render_sequence(chunk)``
    captures a CUDA graph on the card) is true exactly when a frame runs a
    march outside the kernel (``march.march_stage``, which reads the host
    every step)."""
    _, pt = params
    kw = dict(width=SIDE, height=SIDE, max_steps=STEPS, march_impl="staged")
    kw.update(HOST_CASES[case])
    cfg = ct.RenderConfig(**kw)
    calls = []
    real = march_t.march_stage

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(march_t, "march_stage", counting)
    ct.reset_schedule_memo()
    # The model-free sphere scene renders where a model-free render does,
    # on the card; its coarse phase is a dense march like coarse_off's.
    net = None if cfg.scene == "sphere" else pt
    if net is not None:
        renderer_t._render_scheduled(net, _cams(ct, 1)[0], cfg, None, 0.0)
    else:
        from cudaneuralrender_torch.kernels import scenes
        assert not scenes.kernel_supported(cfg.scene)
        calls.append(1)
    assert renderer_t.frame_reads_host(cfg) == bool(calls), (case, len(calls))


def test_host_reading_config_chunked_equals_per_frame(params):
    _, pt = params
    cfg = ct.RenderConfig(width=SIDE, height=SIDE, max_steps=STEPS, march_impl="staged",
                          refine_pallas=False)
    assert renderer_t.frame_reads_host(cfg)
    out = {}
    for chunk in (1, 4):
        ct.reset_schedule_memo()
        stats = []
        out[chunk] = (ct.render_sequence(pt, _cams(ct, 5), cfg, stats_out=stats, chunk=chunk),
                      stats)
    assert out[4][1] == out[1][1]
    for a, b in zip(out[1][0], out[4][0]):
        np.testing.assert_array_equal(b.numpy(), a.numpy())


@pytest.mark.parametrize("case", ["many_sphere", "anim_4_inputs"])
def test_tensor_frame_and_pose_match_float_frame_and_camera(params, case):
    """A CUDA graph feeds ``_render_scheduled`` a pose tensor and a [] frame
    tensor; on the same values they give the frame a Camera and a float
    give, bit for bit (many_sphere's animated spheres, a 4-input net's
    frame input)."""
    _, pt = params
    if case == "many_sphere":
        net, kw = pt, dict(scene="many_sphere")
    else:
        net, kw = ct.load(ANIM, device="cpu"), dict(scene="many_sphere", num_inputs=4)
    cfg = ct.RenderConfig(width=SIDE, height=SIDE, max_steps=STEPS, march_impl="staged", **kw)
    cam = _cams(ct, 1)[0]
    ct.reset_schedule_memo()
    a, _, sa = renderer_t._render_scheduled(net, cam, cfg, None, 37.0)
    ct.reset_schedule_memo()
    b, _, sb = renderer_t._render_scheduled(net, camera_t.pose_tensor(cam), cfg, None,
                                            torch.tensor(37.0))
    np.testing.assert_array_equal(b.numpy(), a.numpy())
    np.testing.assert_array_equal(sb.numpy(), sa.numpy())
    assert (a[..., 3] > 0).float().mean() > 0.05


def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", "cudaneuralrender_torch.cli", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=600)


def test_cli_spin_warm_start_resumes_on_cpu(tmp_path):
    """--spin --warm-start writes {prefix}_{i:03d}.png and skips frames on
    disk: with 0-355 present it renders 356-359, warm-chained."""
    prefix = str(tmp_path / "spin")
    for i in range(356):
        open(f"{prefix}_{i:03d}.png", "wb").close()
    r = _cli(["-d", "cpu", "-i", H5, "--spin", "--warm-start", "-W", "16", "-H", "16",
              "-rx", "-20", "-o", prefix], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "turntable resume: 356 frames already on disk" in r.stdout
    assert "turntable done: 360 frames" in r.stdout
    for i in (356, 357, 358, 359):
        img = image_io.load_png(f"{prefix}_{i:03d}.png")
        assert img.shape == (16, 16, 4) and (img[..., 3] > 0).any()
