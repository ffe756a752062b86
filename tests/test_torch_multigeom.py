"""Multi-geometry batches of the PyTorch package against the JAX package's,
on the CPU.

Geometries: csg_demo and two copies with seeded N(0, 0.01) noise on every
weight and bias (numpy, carried into both packages), and a 3->16x2->1 net
for the architecture check.
  * ``stack_params`` / ``unstack_params`` exact against the JAX package's;
    mismatched architectures raise ``ValueError("...mismatched...")``;
  * ``render_batch`` and ``render_batch_cameras`` (24x24, max_steps 200,
    the dense march) equal to each geometry's own ``render_image`` bit for
    bit, and to the JAX package's at the full-precision bar of
    tests/test_render.py:60-82 (hit masks agree on >= 99.9%, common-hit
    rgba within 1e-4);
  * ``render_batch_staged`` (48x48) equal to each geometry's
    ``render_staged`` bit for bit, ``devices=[cpu]`` giving the same frames,
    its ``stats_out`` with the JAX package's keys and values close to its;
  * ``contact_sheet`` exact against the JAX package's.
"""
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import cudaneuralrender_torch as ct  # noqa: E402
import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch.render import multigeom as mg_t  # noqa: E402
from cudaneuralrender_tpu.render import multigeom as mg_j  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H5 = os.path.join(REPO, "examples", "assets", "csg_demo.h5")
# The port's coarse phase (utils/config.py, set from the H100's chain
# errors), given to both packages: the JAX package's default is the TPU's.
LADDER = dict(coarse_precision=ct.RenderConfig.coarse_precision,
              coarse_eps=ct.RenderConfig.coarse_eps)
DENSE = dict(width=24, height=24, max_steps=200)
STAGED = dict(width=48, height=48, max_steps=300, march_impl="staged", **LADDER)


def _noisy(layers, seed):
    rng = np.random.default_rng(seed)
    return [(w + rng.normal(0.0, 0.01, w.shape).astype(np.float32),
             b + rng.normal(0.0, 0.01, b.shape).astype(np.float32)) for w, b in layers]


@pytest.fixture(scope="module")
def geoms():
    base = [(np.asarray(w, np.float32), np.asarray(b, np.float32))
            for w, b in ct.mlp.to_numpy_params(ct.load(H5, device="cpu"))]
    layer_sets = [base, _noisy(base, 1), _noisy(base, 2)]
    jax_nets = [_jax_params(ls) for ls in layer_sets]
    torch_nets = [ct.from_numpy_params(ls, device="cpu") for ls in layer_sets]
    return jax_nets, torch_nets


def _jax_params(layers):
    import jax.numpy as jnp

    from cudaneuralrender_tpu.models.mlp import DenseParams

    return [DenseParams(w=jnp.asarray(w), b=jnp.asarray(b)) for w, b in layers]


def test_stack_and_unstack_match_jax(geoms):
    jax_nets, torch_nets = geoms
    sj, st = mg_j.stack_params(jax_nets), mg_t.stack_params(torch_nets)
    assert st[0].w.shape == (3, 3, 32)
    for lj, lt in zip(sj, st):
        np.testing.assert_array_equal(lt.w.numpy(), np.asarray(lj.w))
        np.testing.assert_array_equal(lt.b.numpy(), np.asarray(lj.b))
    for g in range(3):
        one_j, one_t = mg_j.unstack_params(sj, g), mg_t.unstack_params(st, g)
        for lj, lt, orig in zip(one_j, one_t, torch_nets[g]):
            np.testing.assert_array_equal(lt.w.numpy(), np.asarray(lj.w))
            np.testing.assert_array_equal(lt.w.numpy(), orig.w.numpy())
            np.testing.assert_array_equal(lt.b.numpy(), orig.b.numpy())


def test_mismatched_architectures_rejected(geoms):
    _, torch_nets = geoms
    other = ct.init_mlp(torch.Generator().manual_seed(0), sizes=(3, 16, 16, 1), device="cpu")
    with pytest.raises(ValueError, match="mismatched"):
        mg_t.stack_params([torch_nets[0], other])


def _full_bar(a, b):
    hit_a, hit_b = a[..., 3] > 0, b[..., 3] > 0
    assert (hit_a == hit_b).mean() >= 0.999
    both = hit_a & hit_b
    assert both.sum() > 30
    np.testing.assert_allclose(b[both], a[both], rtol=0, atol=1e-4)


def test_render_batch_matches_individual_and_jax(geoms):
    jax_nets, torch_nets = geoms
    cam_t, cam_j = ct.Camera(rotation_y=30.0, rotation_x=-20.0), \
        cj.Camera(rotation_y=30.0, rotation_x=-20.0)
    batch = mg_t.render_batch(mg_t.stack_params(torch_nets), cam_t, ct.RenderConfig(**DENSE))
    assert batch.shape == (3, 24, 24, 4)
    want = np.asarray(mg_j.render_batch(mg_j.stack_params(jax_nets), cam_j,
                                        cj.RenderConfig(**DENSE)))
    for g in range(3):
        single = ct.render_image(torch_nets[g], cam_t, ct.RenderConfig(**DENSE))
        np.testing.assert_array_equal(batch[g].numpy(), single.numpy())
        _full_bar(want[g], batch[g].numpy())


def test_render_batch_cameras_matches_individual_and_jax(geoms):
    import jax

    jax_nets, torch_nets = geoms
    yaws = (0.0, 90.0, 200.0)
    cams_t = [ct.Camera(rotation_x=-20.0, rotation_y=y) for y in yaws]
    stacked_cam = ct.Camera(rotation_x=np.full(3, -20.0), rotation_y=np.array(yaws),
                            translation=np.tile([0.0, 0.0, -2.0], (3, 1)))
    st = mg_t.stack_params(torch_nets)
    batch = mg_t.render_batch_cameras(st, cams_t, ct.RenderConfig(**DENSE))
    np.testing.assert_array_equal(
        mg_t.render_batch_cameras(st, stacked_cam, ct.RenderConfig(**DENSE)).numpy(),
        batch.numpy())
    cams_j = jax.tree_util.tree_map(lambda *xs: np.stack(xs),
                                    *[cj.Camera(rotation_x=-20.0, rotation_y=y) for y in yaws])
    want = np.asarray(mg_j.render_batch_cameras(mg_j.stack_params(jax_nets), cams_j,
                                                cj.RenderConfig(**DENSE)))
    for g in range(3):
        single = ct.render_image(torch_nets[g], cams_t[g], ct.RenderConfig(**DENSE))
        np.testing.assert_array_equal(batch[g].numpy(), single.numpy())
        _full_bar(want[g], batch[g].numpy())
    with pytest.raises(ValueError, match="cameras for 3 geometries"):
        mg_t.render_batch_cameras(st, cams_t[:2], ct.RenderConfig(**DENSE))


def test_render_batch_staged_matches_staged_and_jax_stats(geoms):
    jax_nets, torch_nets = geoms
    cam_t, cam_j = ct.Camera(rotation_y=30.0, rotation_x=-20.0), \
        cj.Camera(rotation_y=30.0, rotation_x=-20.0)
    cfg = ct.RenderConfig(**STAGED)
    ct.reset_schedule_memo()
    stats_t = []
    out = mg_t.render_batch_staged(torch_nets, cam_t, cfg, stats_out=stats_t)
    ct.reset_schedule_memo()
    placed = mg_t.render_batch_staged(torch_nets, cam_t, cfg, devices=[torch.device("cpu")])
    assert len(out) == len(placed) == 3
    for g in range(3):
        ct.reset_schedule_memo()
        single = ct.render_staged(torch_nets[g], cam_t, cfg)
        np.testing.assert_array_equal(out[g].numpy(), single.numpy())
        np.testing.assert_array_equal(placed[g].numpy(), out[g].numpy())
        assert (out[g][..., 3] > 0).float().mean() > 0.05
    cj.reset_schedule_memo()
    stats_j = []
    mg_j.render_batch_staged(jax_nets, cam_j, cj.RenderConfig(**STAGED), stats_out=stats_j)
    for sj, st in zip(stats_j, stats_t):
        assert set(st) == set(sj)
        assert st["fast_path"] == sj["fast_path"] and st["rays"] == sj["rays"]
        assert st["refine_caps"] == sj["refine_caps"]
        assert abs(st["hits"] - sj["hits"]) <= 0.01 * sj["hits"]
        assert len(st["rung_actives"]) == len(sj["rung_actives"])


def test_contact_sheet_matches_jax():
    rng = np.random.default_rng(3)
    images = rng.uniform(size=(5, 6, 7, 4)).astype(np.float32)
    for cols in (0, 2, 5):
        want = np.asarray(mg_j.contact_sheet(images, cols=cols))
        got = mg_t.contact_sheet(torch.from_numpy(images), cols=cols).numpy()
        np.testing.assert_array_equal(got, want)
