"""Band-retry rendering (``parallel/fault.py``) against the JAX package's,
on the CPU.

  * dense bands (the sphere scene and csg_demo) assemble to the port's own
    ``render_image`` bit for bit and to JAX's ``render_tiled`` at the
    full-precision bar of tests/test_render.py:60-82 (hit masks agree on
    >= 99.9%, common-hit rgba within 1e-4);
  * injected faults are retried and counted, the image unchanged bit for
    bit; exhausted retries raise; a failure of the band's own render (not
    an injected one) is retried the same way;
  * staged bands (``render_band_auto``: the shard body on a band's pixels)
    assemble to the port's ``render_staged`` bit for bit, with faults too,
    and to JAX's staged ``render_tiled`` (its rungs off the kernel) at the
    mixed-path bar of tests/test_render.py:85-101 (hit masks >= 99%, >= 97%
    of common hits within 1e-3);
  * the CLI's ``--fault-inject 1`` writes the PNG a run without it writes,
    and says it recovered one fault.
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
from cudaneuralrender_torch.parallel import fault as t_fault  # noqa: E402
from cudaneuralrender_torch.utils import image_io  # noqa: E402
from cudaneuralrender_tpu.parallel import fault as j_fault  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "examples", "assets", "csg_demo.npz")
# The port's coarse phase (utils/config.py, set from the H100's chain
# errors), given to both packages: the JAX package's default is the TPU's.
LADDER = dict(coarse_precision=ct.RenderConfig.coarse_precision,
              coarse_eps=ct.RenderConfig.coarse_eps)
SPHERE = dict(width=16, height=16, scene="sphere", max_steps=64)
NEURAL = dict(width=32, height=32, scene="neural_raw", max_steps=200)
STAGED = dict(width=32, height=32, scene="neural_raw", max_steps=200, march_impl="staged",
              **LADDER)


@pytest.fixture(scope="module")
def params():
    return cj.load(NPZ), ct.load(NPZ, device="cpu")


@pytest.fixture(autouse=True)
def _fresh_memo():
    ct.reset_schedule_memo()
    cj.reset_schedule_memo()
    yield


def _full_bar(a, b):
    hit_a, hit_b = a[..., 3] > 0, b[..., 3] > 0
    assert (hit_a == hit_b).mean() >= 0.999
    both = hit_a & hit_b
    assert np.abs(a - b)[both].max() <= 1e-4


def _mixed_bar(a, b):
    hit_a, hit_b = a[..., 3] > 0, b[..., 3] > 0
    assert (hit_a == hit_b).mean() >= 0.99
    close = (np.abs(a - b).max(axis=-1)[hit_a & hit_b] <= 1e-3).mean()
    assert close >= 0.97, close


@pytest.mark.parametrize("scene", ["sphere", "neural_raw"])
def test_tiled_matches_monolithic(params, scene):
    pj, pt = params
    fields = SPHERE if scene == "sphere" else NEURAL
    cam = dict(rotation_y=30.0 if scene == "sphere" else 45.0)
    p_t, p_j = (None, None) if scene == "sphere" else (pt, pj)
    tiled = t_fault.render_tiled(p_t, ct.Camera(**cam), ct.RenderConfig(**fields), n_bands=4,
                                 device="cpu")
    whole = ct.render_image(p_t, ct.Camera(**cam), ct.RenderConfig(**fields), device="cpu")
    np.testing.assert_array_equal(tiled, whole.numpy())
    _full_bar(tiled, j_fault.render_tiled(p_j, cj.Camera(**cam), cj.RenderConfig(**fields),
                                          n_bands=4))


def test_injected_faults_are_retried():
    cfg = ct.RenderConfig(**SPHERE)
    inj = t_fault.FaultInjector(fail_times=2)
    tiled = t_fault.render_tiled(None, ct.Camera(), cfg, n_bands=4, injector=inj, device="cpu")
    assert inj.injected == 2
    np.testing.assert_array_equal(
        tiled, ct.render_image(None, ct.Camera(), cfg, device="cpu").numpy())


def test_retries_exhausted_raise():
    inj = t_fault.FaultInjector(fail_times=100)
    with pytest.raises(RuntimeError, match="failed .* times"):
        t_fault.render_tiled(None, ct.Camera(), ct.RenderConfig(**SPHERE), n_bands=2,
                             max_retries=2, injector=inj, device="cpu")
    assert inj.injected == 3


def test_a_failing_band_render_is_retried(monkeypatch):
    """A band whose own render raises (a lost device, a launch error) is
    rendered again by the same code: nothing else takes its place."""
    calls = []
    real = t_fault.render_band_auto

    def flaky(*args):
        calls.append(args[5])
        if len(calls) == 2:
            raise RuntimeError("launch failed")
        return real(*args)

    monkeypatch.setattr(t_fault, "render_band_auto", flaky)
    cfg = ct.RenderConfig(**SPHERE)
    tiled = t_fault.render_tiled(None, ct.Camera(), cfg, n_bands=4, device="cpu")
    assert calls == [0, 1, 1, 2, 3]
    np.testing.assert_array_equal(
        tiled, ct.render_image(None, ct.Camera(), cfg, device="cpu").numpy())


@pytest.mark.parametrize("faults", [0, 2])
def test_staged_bands(params, faults):
    pj, pt = params
    cam = dict(rotation_y=25.0, rotation_x=10.0)
    inj = t_fault.FaultInjector(fail_times=faults)
    tiled = t_fault.render_tiled(pt, ct.Camera(**cam), ct.RenderConfig(**STAGED), n_bands=4,
                                 max_retries=3, injector=inj)
    assert inj.injected == faults
    ct.reset_schedule_memo()
    np.testing.assert_array_equal(
        tiled, ct.render_staged(pt, ct.Camera(**cam), ct.RenderConfig(**STAGED)).numpy())
    if not faults:
        _mixed_bar(tiled, j_fault.render_tiled(
            pj, cj.Camera(**cam), cj.RenderConfig(**STAGED, coarse_pallas=False,
                                                  refine_pallas=False), n_bands=4))


def _cli(args, tmp_path):
    env = dict(os.environ, CNR_SCHEDULE_MEMO="", OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "cudaneuralrender_torch.cli", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=600)


def test_cli_fault_inject_writes_the_same_png(tmp_path):
    """At 32x32 the frame's refine buckets (compact_min 2048 lanes) span it
    and each band alike, so the bands march the frame's rungs; at 48x48 the
    frame's are prefixes of 2304 lanes and a band's span its 576, and a band
    marches its entry rung densely with relaxation on: 1-2 pixels move."""
    imgs = []
    for extra in ([], ["--fault-inject", "1"]):
        out = tmp_path / f"frame{len(imgs)}.png"
        r = _cli(["-d", "cpu", "-i", NPZ, "--single", "-W", "32", "-H", "32", "-ry", "30",
                  "-rx", "-20", "-o", str(out), *extra], tmp_path)
        assert r.returncode == 0, r.stderr[-2000:]
        assert ("fault drill: 1 injected failures recovered" in r.stdout) == bool(extra)
        imgs.append(image_io.load_png(str(out)))
    assert (imgs[0][..., 3] > 0).mean() > 0.05
    np.testing.assert_array_equal(imgs[1], imgs[0])


def test_overflowing_band_widens_before_the_dense_march(params, monkeypatch):
    """A staged band whose refine bucket overflows renders again with its
    buckets resized from its own rung counts, as a frame does, instead of
    finishing densely: with eighth-of-a-band buckets the middle bands
    overflow once, and every band ends on the staged path, at the mixed-path
    bar against render_staged."""
    _, pt = params
    passes, dense = [], []
    real_staged, real_dense = t_fault._render_band_staged, t_fault._render_band

    def staged(params, camera, config, *args):
        passes.append((args[2], config.refine_caps))
        return real_staged(params, camera, config, *args)

    def dense_band(*args):
        dense.append(args[5])
        return real_dense(*args)

    monkeypatch.setattr(t_fault, "_render_band_staged", staged)
    monkeypatch.setattr(t_fault, "_render_band", dense_band)
    cfg = ct.RenderConfig(width=64, height=64, max_steps=300, march_impl="staged",
                          compact_min=8, refine_schedule=((8, 16), (8, 0)))
    cam = ct.Camera.from_cli(rx=10.0, ry=25.0, zoom=3.0)  # the object within the bands
    tiled = t_fault.render_tiled(pt, cam, cfg, n_bands=4)
    retried = [band for band, caps in passes if caps]
    assert not dense and retried and len(passes) == 4 + len(retried), passes
    _mixed_bar(tiled, ct.render_staged(pt, cam, cfg).numpy())
