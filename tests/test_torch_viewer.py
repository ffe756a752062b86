"""The interactive path and the browser viewer of the PyTorch package, on
the CPU.

  * ``image_io``'s u32 helpers against the JAX package's, exact, and their
    round trip;
  * ``Renderer.render_frame_interactive`` (the u32 frame, unpacked on the
    host) gives the bytes of ``render_frame``;
  * ``render_interactive`` equals ``render_staged`` bit for bit on fast
    frames, and its deferred check teaches the schedule memo after an
    overflow frame (tests/test_viewer.py:74-100, with csg_demo);
  * ``native.codec.AsyncFrameWriter``: write, flush, read back;
  * ``render.viewer.make_server`` on port 0, on a thread: the page, a
    ``/frame`` PNG, a pan that moves the image, the ``/camera`` dump and
    ``/save``;
  * the CLI's ``--serve`` answering a ``/frame`` request (the server is
    killed by the PID the test started).
"""
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import cudaneuralrender_torch as ct  # noqa: E402
from cudaneuralrender_torch.render import schedule  # noqa: E402
from cudaneuralrender_torch.render import viewer  # noqa: E402
from cudaneuralrender_torch.utils import image_io  # noqa: E402
from cudaneuralrender_tpu.utils import image_io as image_io_j  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H5 = os.path.join(REPO, "examples", "assets", "csg_demo.h5")
CAM = dict(rotation_y=30.0, rotation_x=-20.0)


@pytest.fixture(scope="module")
def params():
    return ct.load(H5, device="cpu")


def test_u32_helpers_match_jax():
    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, (7, 9, 4), dtype=np.uint8)
    packed = image_io.pack_rgba_uint32(u8)
    np.testing.assert_array_equal(packed, image_io_j.pack_rgba_uint32(u8))
    assert packed.dtype == np.uint32
    np.testing.assert_array_equal(image_io.unpack_rgba_uint32(packed), u8)
    np.testing.assert_array_equal(image_io.unpack_rgba_uint32(packed),
                                  image_io_j.unpack_rgba_uint32(packed))
    for flip in (False, True):
        img = image_io.packed_u32_to_uint8_image(packed, parity_flip=flip)
        np.testing.assert_array_equal(img, image_io_j.packed_u32_to_uint8_image(
            packed, parity_flip=flip))
        # the same bits as int32 (what the renderer's packed frame holds)
        np.testing.assert_array_equal(
            image_io.packed_u32_to_uint8_image(packed.view(np.int32), parity_flip=flip), img)


def _staged(**kw):
    return ct.RenderConfig(width=48, height=48, max_steps=300, march_impl="staged", **kw)


@pytest.mark.parametrize("flip", [False, True], ids=["upright", "parity_flip"])
def test_render_frame_interactive_bytes_equal_render_frame(params, flip):
    ct.reset_schedule_memo()
    r = ct.Renderer(params, _staged())
    cam = ct.Camera(**CAM)
    want = r.render_frame(cam, parity_flip=flip)
    got = r.render_frame_interactive(cam, parity_flip=flip)
    assert got.dtype == np.uint8 and got.shape == (48, 48, 4)
    np.testing.assert_array_equal(got, want)
    assert (got[..., 3] > 0).mean() > 0.05
    packed = r.render_interactive_packed(cam)
    assert packed.dtype == torch.int32 and packed.shape == (48, 48)


def test_render_interactive_matches_staged_and_teaches_memo(params):
    ct.reset_schedule_memo()
    cfg = _staged()
    r = ct.Renderer(params, cfg)
    cams = [ct.Camera(rotation_x=-20.0, rotation_y=30.0 + i) for i in range(3)]
    for cam in cams:
        a = r.render_interactive(cam)
        b = ct.render_staged(params, cam, cfg)
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert r.last_stats["fast_path"]  # the second frame's, checked during the third
    # An overflowing config: the frame shows the optimistic image; the next
    # call checks it and teaches the widened schedule.
    tiny = cfg.replace(refine_schedule=((1024, 4), (1024, 0)), compact_min=8)
    r2 = ct.Renderer(params, tiny)
    r2.render_interactive(cams[0])
    assert schedule.memo_lookup(params, tiny) == tiny
    r2.render_interactive(cams[1])
    assert r2.last_stats["refine_overflow"] > 0
    assert schedule.memo_lookup(params, tiny) != tiny
    ct.reset_schedule_memo()


def test_async_frame_writer_round_trip(tmp_path):
    from cudaneuralrender_torch.native import codec

    if not codec.available():
        pytest.skip("the native codec library is not built and cannot be built here")
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (12, 20, 4), dtype=np.uint8) for _ in range(5)]
    gray = rng.integers(0, 256, (6, 5), dtype=np.uint8)
    with codec.AsyncFrameWriter(n_threads=2) as writer:
        for i, f in enumerate(frames):
            writer.enqueue(str(tmp_path / f"f{i}.png"), f)
        writer.enqueue(str(tmp_path / "gray.png"), gray)
        assert writer.flush() == 0
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(image_io.load_png(str(tmp_path / f"f{i}.png")), f)
    back = image_io.load_png(str(tmp_path / "gray.png"))
    np.testing.assert_array_equal(back[..., 0], gray)
    with pytest.raises(RuntimeError, match="closed"):
        writer.enqueue(str(tmp_path / "late.png"), gray)


@pytest.fixture(scope="module")
def server(params, tmp_path_factory):
    r = ct.Renderer(params, ct.RenderConfig(width=32, height=32, max_steps=300,
                                            march_impl="staged"))
    srv = viewer.make_server(r, ct.Camera(), port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    t.join(timeout=30)
    assert not t.is_alive()


def _get(url, timeout=120):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def test_viewer_page(server):
    page = _get(server + "/").decode()
    assert "canvas" in page and "shift-drag=pan" in page
    assert "p=play" in page and "q=camera" in page and "fps" in page
    assert "playing=!playing" in page.replace(" ", "")
    assert "/camera?" in page and "cudaneuralrender_torch viewer" in page


def test_viewer_frame_and_pan(server):
    from PIL import Image

    base = np.asarray(Image.open(io.BytesIO(_get(server + "/frame?rx=0&ry=0&zoom=2"))))
    panned = np.asarray(Image.open(io.BytesIO(
        _get(server + "/frame?rx=0&ry=0&zoom=2&tx=0.4&ty=0.0"))))
    assert base.shape == (32, 32, 4)
    assert (base[..., :3].sum(-1) > 0).any()
    assert not np.array_equal(base, panned), "pan must move the image"


def test_viewer_camera_dump(server):
    cam = json.loads(_get(server + "/camera?rx=15.5&ry=30.25&zoom=2.5&tx=0.1&ty=-0.2&frame=7"))
    assert cam == pytest.approx(dict(rotation_x=15.5, rotation_y=30.25, zoom=2.5,
                                     translation_x=0.1, translation_y=-0.2, frame=7.0))


def test_viewer_save(server, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    body = json.loads(_get(server + "/save?rx=0&ry=20&zoom=2"))
    img = image_io.load_png(str(tmp_path / body["saved"]))
    assert img.shape == (32, 32, 4) and (img[..., 3] > 0).any()
    with pytest.raises(urllib.error.HTTPError):
        _get(server + "/nothing")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serve_answers_a_frame(tmp_path):
    from PIL import Image

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cudaneuralrender_torch.cli", "-d", "cpu", "-i", H5, "--serve",
         "--port", str(port), "-W", "24", "-H", "24", "--steps", "300"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 240
        body = None
        while time.time() < deadline and proc.poll() is None:
            try:
                body = _get(f"http://127.0.0.1:{port}/frame?rx=-20&ry=30&zoom=2", timeout=60)
                break
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.5)
        assert body is not None, proc.stderr.read() if proc.poll() is not None else "no answer"
        img = np.asarray(Image.open(io.BytesIO(body)))
        assert img.shape == (24, 24, 4) and (img[..., 3] > 0).any()
    finally:
        proc.kill()  # the PID this test started, never a pattern
        proc.communicate(timeout=30)
    assert proc.returncode is not None
