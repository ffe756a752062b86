"""End-to-end render parity of the PyTorch package with the JAX package.

csg_demo weights (the shipped 3->32x8->1 architecture), Camera(rotation_y=30,
rotation_x=-20), on the CPU:
  * dense ``render_image`` at 32x32 against the JAX package's, at the
    full-precision bar of tests/test_render.py:60-82 (hit masks agree on
    >=99.9% of pixels, common-hit rgba within 1e-4);
  * ``render_staged`` at 64x64, where every refine rung's bucket (2048
    lanes) is smaller than the image, so the JAX side marches its rungs in
    the megakernel (interpret mode) and this package in the march kernel's
    plain version; the mixed bar of tests/test_render.py:85-101 (hits
    agree on >=99%, >=97% of common hits within 1e-3), with matching stats;
  * the 256x256 golden render examples/assets/csg_demo.png at the bar of
    tests/test_artifact.py:51-64;
  * the CSG scenes: dense ``render_image`` per scene at 24x24 (full bar,
    ``max_steps`` 200 so the 300-term many_cylinder_cut chain stays cheap
    here), ``render_staged`` at 64x64 (mixed bar), and ``render_sequence``
    over three turntable frames of many_sphere at 32x32 (mixed bar, per-frame
    stats);
  * ``prepass_factor`` and ``grid_res`` frames against the option off;
  * the CLI, its turntable (``--spin``), ``--profile`` and ``--save-ckpt``
    included.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import cudaneuralrender_torch as ct  # noqa: E402
import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch.kernels import megakernel as mk_t  # noqa: E402
from cudaneuralrender_torch.utils import image_io  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "examples", "assets")
H5 = os.path.join(ASSETS, "csg_demo.h5")
GOLDEN = os.path.join(ASSETS, "csg_demo.png")
# The port's coarse phase (utils/config.py, set from the H100's chain
# errors), given to both packages: the JAX package's default is the TPU's.
LADDER = dict(coarse_precision=ct.RenderConfig.coarse_precision,
              coarse_eps=ct.RenderConfig.coarse_eps)
CAM = dict(rotation_y=30.0, rotation_x=-20.0)


@pytest.fixture(scope="module")
def params():
    return cj.load(H5), ct.load(H5, device="cpu")


def _both(params, fn_name, cfg_kw, **kw):
    pj, pt = params
    cj.reset_schedule_memo()
    ct.reset_schedule_memo()
    a = np.asarray(getattr(cj, fn_name)(pj, cj.Camera(**CAM), cj.RenderConfig(**cfg_kw), **kw))
    b_kw = dict(kw)
    if "stats_out" in kw:
        b_kw["stats_out"] = {}
    b = getattr(ct, fn_name)(pt, ct.Camera(**CAM), ct.RenderConfig(**cfg_kw), **b_kw).numpy()
    return a, b, b_kw.get("stats_out")


def test_dense_render_image_matches_jax(params):
    a, b, _ = _both(params, "render_image",
                    dict(width=32, height=32, scene="neural_raw", max_steps=300))
    assert b.shape == (32, 32, 4) and np.isfinite(b).all()
    hit_a, hit_b = a[..., 3] > 0, b[..., 3] > 0
    assert (hit_a == hit_b).mean() >= 0.999
    both = hit_a & hit_b
    assert both.sum() > 50
    np.testing.assert_allclose(b[both], a[both], rtol=0, atol=1e-4)


def test_staged_render_matches_jax(params):
    stats_j = {}
    kw = dict(width=64, height=64, scene="neural_raw", march_impl="staged",
              rgba_packed=False, **LADDER)
    a, b, stats_t = _both(params, "render_staged", kw, stats_out=stats_j)
    hit_a, hit_b = a[..., 3] > 0, b[..., 3] > 0
    assert (hit_a == hit_b).mean() >= 0.99
    both = hit_a & hit_b
    close = np.all(np.abs(b[both] - a[both]) < 1e-3, axis=-1).mean()
    assert close >= 0.97, close
    assert stats_t["fast_path"] is True and stats_j["fast_path"] is True
    assert abs(stats_t["hits"] - stats_j["hits"]) <= 0.01 * stats_j["hits"]
    assert stats_t["rays"] == 64 * 64 and stats_t["unresolved"] == 0
    assert mk_t.KERNEL_LAUNCHES == 0  # CPU tensors never reach the kernel


def test_staged_render_matches_golden(params):
    """The committed 256x256 golden reproduces through this package's
    staged path (u8-quantized, both sides)."""
    _, pt = params
    ct.reset_schedule_memo()
    cfg = ct.RenderConfig(width=256, height=256, scene="neural_raw", max_steps=500,
                          march_impl="staged")
    img = ct.Renderer(pt, cfg).render_frame(ct.Camera(**CAM))
    golden = image_io.load_png(GOLDEN)
    assert img.shape == golden.shape
    hit_g, hit_o = golden[..., 3] > 0, img[..., 3] > 0
    iou = (hit_g & hit_o).sum() / max((hit_g | hit_o).sum(), 1)
    assert iou >= 0.99, iou
    fg = hit_g & hit_o
    diff = np.abs(img[..., :3].astype(int) - golden[..., :3].astype(int))
    assert (diff.max(axis=-1)[fg] <= 2).mean() >= 0.95


def test_unported_options_raise(params):
    """The options once refused (``prepass_factor``, ``grid_res``) render:
    a 16x16 ``Renderer.render`` frame under each meets the mixed-path bar
    (hits agree >= 99%, >= 97% of common hits within 1e-3) against the
    frame with the option off (tests/test_torch_prepass.py and
    tests/test_torch_grid.py hold them to JAX's)."""
    _, pt = params
    base = ct.RenderConfig(width=16, height=16, march_impl="staged", rgba_packed=False)
    ct.reset_schedule_memo()
    off = ct.Renderer(pt, base).render(ct.Camera(**CAM)).numpy()
    assert (off[..., 3] > 0).sum() > 20
    for kw in (dict(prepass_factor=4), dict(grid_res=32)):
        ct.reset_schedule_memo()
        on = ct.Renderer(pt, base.replace(**kw)).render(ct.Camera(**CAM)).numpy()
        hit_on, hit_off = on[..., 3] > 0, off[..., 3] > 0
        assert (hit_on == hit_off).mean() >= 0.99, kw
        both = hit_on & hit_off
        assert np.all(np.abs(on[both] - off[both]) < 1e-3, axis=-1).mean() >= 0.97, kw


def _cli(args, tmp_path):
    env = dict(os.environ, CNR_SCHEDULE_MEMO="")
    return subprocess.run(
        [sys.executable, "-m", "cudaneuralrender_torch.cli", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )


def test_cli_single_frame_on_cpu(tmp_path):
    out = tmp_path / "demo.png"
    r = _cli(["-d", "cpu", "-i", H5, "--single", "-W", "64", "-H", "64",
              "-ry", "30", "-rx", "-20", "-o", str(out)], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "volumeRender, Throughput" in r.stdout
    img = image_io.load_png(str(out))
    assert img.shape == (64, 64, 4)
    assert (img[..., 3] > 0).mean() > 0.05


def test_cli_rejects_animation_on_3_input_model_and_unported_modes(tmp_path):
    """--animation on a 3-input model exits 2; --profile (once refused) now
    writes a torch.profiler Chrome trace of the frame, with the staged
    frame's ``cnr.*`` spans (``cnr.trace``), and the trace's snapshot, and
    exits 0."""
    r = _cli(["-d", "cpu", "-i", H5, "--animation", "--single", "-W", "32", "-H", "32",
              "-o", str(tmp_path / "x.png")], tmp_path)
    assert r.returncode == 2
    assert "expects 3 inputs" in r.stderr
    trace = tmp_path / "trace"
    r = _cli(["-d", "cpu", "-i", H5, "--single", "-W", "16", "-H", "16", "--profile", str(trace),
              "-o", str(tmp_path / "p.png")], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    files = list(trace.glob("render_*.pt.trace.json"))
    assert len(files) == 1 and f"profile trace: {files[0]}" in r.stdout
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    assert any(e.get("name") == "cnr.sequence/enqueue/frame/coarse" for e in events)
    (snapshot,) = trace.glob("trace_*.json")
    assert f"trace snapshot: {snapshot}" in r.stdout
    with open(snapshot) as f:
        spans = json.load(f)["spans"]
    assert spans["sequence/enqueue/frame/coarse"]["calls"] == 1
    assert spans["sequence/enqueue/frame/coarse"]["device_ms"] is None
    from cudaneuralrender_torch import cli

    assert not hasattr(cli, "NOT_PORTED")


def test_cli_save_ckpt_roundtrip(tmp_path):
    """--save-ckpt re-saves the loaded weights as .npz (tests/test_cli.py:67):
    both packages load them back equal to the source."""
    ck = tmp_path / "w.npz"
    r = _cli(["-d", "cpu", "-i", H5, "--single", "-W", "8", "-H", "8", "--steps", "16",
              "--save-ckpt", str(ck), "-o", str(tmp_path / "x.png")], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"saved checkpoint: {ck}" in r.stdout
    src = ct.load(H5, device="cpu")
    for la, lb, lj in zip(src, ct.load(str(ck), device="cpu"), cj.load(str(ck))):
        np.testing.assert_array_equal(lb.w.numpy(), la.w.numpy())
        np.testing.assert_array_equal(lb.b.numpy(), la.b.numpy())
        np.testing.assert_array_equal(np.asarray(lj.w), la.w.numpy())


def test_cli_pallas_matches_plain_chain_on_cpu(tmp_path):
    """--pallas (use_pallas: the forward kernel's plain version on the CPU)
    renders the same PNG as the plain chain, within 1 u8 level."""
    imgs = []
    for extra in ([], ["--pallas"]):
        out = tmp_path / f"demo{len(imgs)}.png"
        r = _cli(["-d", "cpu", "-i", H5, "--single", "--march", "while", "-W", "32", "-H", "32",
                  "-ry", "30", "-rx", "-20", "-o", str(out), *extra], tmp_path)
        assert r.returncode == 0, r.stderr[-2000:]
        imgs.append(image_io.load_png(str(out)).astype(int))
    assert (imgs[0][..., 3] > 0).mean() > 0.05
    assert np.abs(imgs[1] - imgs[0]).max() <= 1


def test_cli_cuda_without_card_is_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _cli(["-i", H5, "--single", "-W", "16", "-H", "16", "-o", str(tmp_path / "x.png")],
             tmp_path)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not (tmp_path / "x.png").exists()


def test_cli_rejects_unsupported_input_count(tmp_path):
    """A model that is neither 3- nor 4-input gets a plain error (exit 2),
    not the hint to pass --animation."""
    path = str(tmp_path / "five_in.npz")
    ct.save_pytree(path, ct.init_mlp(torch.Generator().manual_seed(0), sizes=(5, 8, 1),
                                     device="cpu"))
    for extra in ([], ["--animation"]):
        r = _cli(["-d", "cpu", "-i", path, "--single", "-W", "8", "-H", "8",
                  "-o", str(tmp_path / "x.png"), *extra], tmp_path)
        assert r.returncode == 2, r.stderr[-2000:]
        assert "expects 5 inputs" in r.stderr
        assert "3-input (x,y,z) or 4-input" in r.stderr
        assert "pass --animation" not in r.stderr
    assert not (tmp_path / "x.png").exists()


def _mixed_bar(a, b):
    hit_a, hit_b = a[..., 3] > 0, b[..., 3] > 0
    assert (hit_a == hit_b).mean() >= 0.99
    both = hit_a & hit_b
    assert both.sum() > 50
    close = np.all(np.abs(b[both] - a[both]) < 1e-3, axis=-1).mean()
    assert close >= 0.97, close


CSG_SCENES = [("neural_tanh", 0.0), ("many_sphere", 90.0), ("many_sphere_cut", 90.0),
              ("many_cylinder_cut", 0.0), ("displacement", 0.0)]


@pytest.mark.parametrize("scene,frame", CSG_SCENES, ids=[s for s, _ in CSG_SCENES])
def test_dense_render_image_csg_scene_matches_jax(params, scene, frame):
    a, b, _ = _both(params, "render_image",
                    dict(width=24, height=24, scene=scene, max_steps=200), frame=frame)
    assert b.shape == (24, 24, 4) and np.isfinite(b).all()
    hit_a, hit_b = a[..., 3] > 0, b[..., 3] > 0
    assert (hit_a == hit_b).mean() >= 0.999
    both = hit_a & hit_b
    assert both.sum() > 50
    np.testing.assert_allclose(b[both], a[both], rtol=0, atol=1e-4)


@pytest.mark.parametrize("scene,frame", [("many_sphere", 90.0), ("many_cylinder_cut", 0.0),
                                         ("displacement", 0.0)],
                         ids=["many_sphere", "many_cylinder_cut", "displacement"])
def test_staged_render_csg_scene_matches_jax(params, scene, frame):
    stats_j = {}
    kw = dict(width=64, height=64, scene=scene, march_impl="staged", rgba_packed=False,
              **LADDER)
    a, b, stats_t = _both(params, "render_staged", kw, frame=frame, stats_out=stats_j)
    _mixed_bar(a, b)
    # many_sphere overflows the first refine bucket and retries, in both
    assert stats_t["fast_path"] == stats_j["fast_path"]
    assert stats_t["refine_overflow"] == stats_j["refine_overflow"]
    assert abs(stats_t["hits"] - stats_j["hits"]) <= 0.01 * stats_j["hits"]
    assert stats_t["unresolved"] == 0
    assert mk_t.KERNEL_LAUNCHES == 0  # CPU tensors never reach the kernel


def test_render_sequence_matches_jax(params):
    """Three turntable frames of many_sphere (yaw and frame number step
    together), pipelined, against the JAX package's render_sequence."""
    pj, pt = params
    kw = dict(width=32, height=32, scene="many_sphere", march_impl="staged",
              rgba_packed=False, **LADDER)
    frames = [0.0, 1.0, 2.0]
    cj.reset_schedule_memo()
    ct.reset_schedule_memo()
    stats_j, stats_t = [], []
    out_j = cj.render_sequence(pj, [cj.Camera(rotation_x=-20.0, rotation_y=f) for f in frames],
                               cj.RenderConfig(**kw), frames=frames, stats_out=stats_j)
    out_t = ct.render_sequence(pt, [ct.Camera(rotation_x=-20.0, rotation_y=f) for f in frames],
                               ct.RenderConfig(**kw), frames=frames, stats_out=stats_t)
    assert len(out_t) == len(stats_t) == 3
    for a, b, sj, st in zip(out_j, out_t, stats_j, stats_t):
        _mixed_bar(np.asarray(a), b.numpy())
        assert st["fast_path"] == sj["fast_path"]
        assert abs(st["hits"] - sj["hits"]) <= 0.01 * sj["hits"]
        assert st["unresolved"] == 0
    # warm starts and fused chunks run (tests/test_torch_sequence.py holds them)
    cams = [ct.Camera(rotation_x=-20.0, rotation_y=f) for f in frames]
    for extra in (dict(warm_start=True), dict(chunk=4)):
        out = ct.render_sequence(pt, cams, ct.RenderConfig(**kw), frames=frames, **extra)
        assert len(out) == 3 and all((o[..., 3] > 0).any() for o in out)


def test_cli_spin_resumes_on_cpu(tmp_path):
    """--spin writes {prefix}_{i:03d}.png for i < 360 and skips frames on
    disk: with 0-356 present, it renders only 357-359."""
    prefix = str(tmp_path / "spin")
    for i in range(357):
        open(f"{prefix}_{i:03d}.png", "wb").close()
    r = _cli(["-d", "cpu", "-i", H5, "--scene", "many_sphere", "--spin", "-W", "16",
              "-H", "16", "-rx", "-20", "-o", prefix], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "turntable resume: 357 frames already on disk" in r.stdout
    assert "turntable done: 360 frames" in r.stdout
    for i in (357, 358, 359):
        img = image_io.load_png(f"{prefix}_{i:03d}.png")
        assert img.shape == (16, 16, 4) and (img[..., 3] > 0).any()
    # every frame is on disk now: --warm-start resumes with nothing to render
    r = _cli(["-d", "cpu", "-i", H5, "--spin", "--warm-start", "-o", prefix], tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "turntable resume: 360 frames already on disk" in r.stdout
