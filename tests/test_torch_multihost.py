"""Multi-process worlds (``parallel/multihost.py``) on the CPU: two real
processes in a gloo world, against single-process renders.

The fixture starts two ranks of ``cudaneuralrender_torch.examples.
multihost_drill`` (rendezvous through a ``file://`` under ``tmp_path``), four
logical shards each: one 8-shard global mesh. Bars:
  * ``band_owners`` equals the JAX package's over a table of cases;
  * the global dense frame's tiles, the gathered frame on both ranks, the
    band tiles and the failover tiles (host 1 declared failed, host 0
    adopting its bands), and the global staged frame's tiles, each equal to
    the single-process render bit for bit (``render_image``, or
    ``render_staged`` for the staged paths);
  * a schedule taught to rank 0 alone reaches rank 1 (both render on the
    fast path, no overflow);
  * the cross-process train step's loss is the same on both ranks and
    within rtol 1e-5 of the single-process sharded step's and the unsharded
    step's, its gradients (the first Adam moments) within |d| <= 1e-4 |g|
    per leaf; the same for the step fed by the staged sharded solve;
  * tiles with a gap raise; ``initialize`` in a world of one creates no
    process group.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import cudaneuralrender_torch as ct  # noqa: E402
from cudaneuralrender_torch.diff import train as t_train  # noqa: E402
from cudaneuralrender_torch.examples import multihost_drill as drill  # noqa: E402
from cudaneuralrender_torch.parallel import mesh as t_mesh  # noqa: E402
from cudaneuralrender_torch.parallel import multihost  # noqa: E402
from cudaneuralrender_torch.parallel import sharding as t_sh  # noqa: E402
from cudaneuralrender_tpu.parallel import multihost as j_multihost  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "examples", "assets", "csg_demo.npz")
CFG = dict(width=32, height=32, max_steps=300)


def test_band_owners_match_jax():
    for n_bands, n_hosts, failed in ((4, 2, ()), (4, 2, (1,)), (6, 3, (2,)), (7, 3, (0,)),
                                     (8, 4, (1, 3)), (5, 5, (0, 1, 2, 3)), (3, 1, ())):
        assert multihost.band_owners(n_bands, n_hosts, failed) == j_multihost.band_owners(
            n_bands, n_hosts, failed)
    with pytest.raises(ValueError):
        multihost.band_owners(2, 1, failed_hosts=[0])


def test_tile_gaps_raise_and_a_world_of_one_has_no_group(tmp_path):
    img = np.arange(8 * 2 * 4, dtype=np.float32).reshape(8, 2, 4)
    multihost.write_band_tiles([(0, img[:3]), (5, img[5:])], str(tmp_path), "gap")
    with pytest.raises(ValueError, match="gap"):
        multihost.assemble_tiles(str(tmp_path), "gap")
    multihost.write_band_tiles([(3, img[3:5])], str(tmp_path), "gap")
    np.testing.assert_array_equal(multihost.assemble_tiles(str(tmp_path), "gap"), img)
    multihost.initialize("localhost:1", num_processes=1, process_id=0)
    assert not multihost.distributed() and multihost.process_count() == 1
    assert multihost.local_tiles(torch.as_tensor(img))[0][0] == 0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both ranks' outputs (each rank's run bounded by its own timeout)."""
    base = tmp_path_factory.mktemp("world")
    out = str(base / "out")
    env = dict(os.environ, CNR_SCHEDULE_MEMO="", OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cudaneuralrender_torch.examples.multihost_drill",
         "--init", f"file://{base}/rendezvous", "--world", "2", "--rank", str(rank),
         "--out", out, "--model", NPZ, "--device", "cpu", "--shards", "4",
         "-W", str(CFG["width"]), "-H", str(CFG["height"]), "--steps", str(CFG["max_steps"])],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
        logs.append(log)
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    return out


@pytest.fixture(scope="module")
def single():
    """Single-process renders of the drill's frame."""
    ct.reset_schedule_memo()
    params = ct.load(NPZ, device="cpu")
    cfg = ct.RenderConfig(**CFG)
    cam = ct.Camera(**drill.CAMERA)
    dense = ct.render_image(params, cam, cfg).numpy()
    staged = ct.render_staged(params, cam, cfg.replace(march_impl="staged")).numpy()
    ct.reset_schedule_memo()
    return params, dense, staged


@pytest.mark.parametrize("stem", ["gspmd", "bands", "failover", "gspmd_staged"])
def test_tiles_assemble_to_the_single_process_image(world, single, stem):
    _, dense, staged = single
    want = dense if stem == "gspmd" else staged
    np.testing.assert_array_equal(multihost.assemble_tiles(world, stem), want)


def test_gather_image_on_every_rank(world, single):
    g0, g1 = (np.load(os.path.join(world, f"gather_p{r}.npy")) for r in (0, 1))
    np.testing.assert_array_equal(g0, g1)
    np.testing.assert_array_equal(g0, single[1])


def test_memo_broadcast_reaches_every_rank(world):
    for rank in (0, 1):
        assert np.load(os.path.join(world, f"memo_fast_p{rank}.npy"))[0] == 1


def _mu(path):
    with np.load(path) as f:
        return [f[f"arr_{i}"] for i in range(len(f.files))]


@pytest.mark.parametrize("solve", ["dense", "staged_solve"])
def test_cross_process_train_step_matches_single_process(world, single, solve):
    params, _, _ = single
    suffix = "" if solve == "dense" else "_solve"
    losses = [float(np.load(os.path.join(world, f"loss{suffix}_p{r}.npy"))) for r in (0, 1)]
    assert losses[0] == losses[1]
    cfg = ct.RenderConfig(**CFG)
    cam = ct.Camera(**drill.CAMERA)
    target = drill.train_target(params, cfg)
    s0 = t_train.init_train_state(params)
    mesh = t_mesh.make_mesh((8,), ("data",), ["cpu"] * 8)
    if solve == "dense":
        sharded, loss = t_sh.pixel_train_step_sharded(s0, cam, target, cfg, mesh)
        ref, ref_loss = t_train.pixel_train_step(s0, cam, target, cfg)
    else:
        staged = cfg.replace(march_impl="staged")
        t_star, hit = t_sh.solve_surface_sharded(params, cam, staged, mesh)
        sharded, loss = t_sh.pixel_train_step_sharded(s0, cam, target, staged, mesh,
                                                      t_star=t_star, hit=hit)
        ref, ref_loss = t_train._pixel_grad_step_from_t(s0, cam, target, t_star, hit, cfg, 1e-3)
    np.testing.assert_allclose(losses[0], float(loss), rtol=1e-5)
    np.testing.assert_allclose(losses[0], float(ref_loss), rtol=1e-5)
    got = _mu(os.path.join(world, f"mu{suffix}.npz"))
    for want_state in (sharded, ref):
        want = [m.numpy() for m in t_train._flat(want_state.opt_state.mu)]
        assert sum(float(np.linalg.norm(a)) for a in want) > 0
        for a, b in zip(want, got):
            assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(a)
