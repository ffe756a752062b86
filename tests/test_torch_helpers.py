"""The small helpers of ROADMAP queue 1's item 9 against the JAX package's,
on the CPU: ``models/checkpoint.save_keras_h5`` and
``ops/compaction.capacity_bucket`` / ``gather_state``.

  * ``save_keras_h5`` writes JAX's layout (groups dense, dense_1, ..., each
    an inner group of its name with ``kernel:0`` and ``bias:0``, the
    ``layer_names`` root attribute); both packages' loaders read back the
    source weights bit for bit, and the port reads a file JAX wrote the
    same. Skipped where h5py is absent; there the writer raises an
    ImportError that names h5py.
  * ``capacity_bucket`` and ``gather_state`` on the cases of
    tests/test_compaction.py:10-48: powers of two over a minimum, the
    compaction of seeded masks (numpy seed 0) gathered and scattered back,
    equal to JAX's ``gather_state`` on tuples and NamedTuples.
"""
import builtins
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import cudaneuralrender_torch as ct  # noqa: E402
import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch.models import checkpoint as ckpt_t  # noqa: E402
from cudaneuralrender_torch.ops import compaction as comp_t  # noqa: E402
from cudaneuralrender_torch.ops import march as march_t  # noqa: E402
from cudaneuralrender_tpu.models import checkpoint as ckpt_j  # noqa: E402
from cudaneuralrender_tpu.ops import compaction as comp_j  # noqa: E402
from cudaneuralrender_tpu.ops import march as march_j  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "examples", "assets", "csg_demo.npz")


def _h5py():
    return pytest.importorskip("h5py")


@pytest.mark.parametrize("net", ["csg_demo", "random_4_inputs"])
def test_save_keras_h5_round_trips_through_both_loaders(tmp_path, net):
    h5py = _h5py()
    if net == "csg_demo":
        src = ct.load(NPZ, device="cpu")
    else:
        src = ct.init_mlp(torch.Generator().manual_seed(1), sizes=(4, 16, 16, 1), device="cpu")
        rng = np.random.default_rng(1)
        for layer in src:
            layer.b.data.copy_(torch.from_numpy(
                rng.standard_normal(layer.b.shape).astype(np.float32)))
    path = str(tmp_path / "w.h5")
    ckpt_t.save_keras_h5(path, src)
    names = [f"dense_{i}" if i else "dense" for i in range(len(src))]
    with h5py.File(path, "r") as f:
        assert [n.decode() for n in f.attrs["layer_names"]] == names
        for name in names:
            assert sorted(f[name][name].keys()) == ["bias:0", "kernel:0"]
    back_t = ct.load(path, device="cpu")
    back_j = cj.load(path)
    for ls, lt, lj in zip(src, back_t, back_j):
        np.testing.assert_array_equal(lt.w.numpy(), ls.w.numpy())
        np.testing.assert_array_equal(lt.b.numpy(), ls.b.numpy())
        np.testing.assert_array_equal(np.asarray(lj.w), ls.w.numpy())
        np.testing.assert_array_equal(np.asarray(lj.b), ls.b.numpy())
    # and a file the JAX package wrote reads back the same here
    jpath = str(tmp_path / "j.h5")
    ckpt_j.save_keras_h5(jpath, back_j)
    for lt, lj in zip(ct.load(jpath, device="cpu"), back_t):
        np.testing.assert_array_equal(lt.w.numpy(), lj.w.numpy())
        np.testing.assert_array_equal(lt.b.numpy(), lj.b.numpy())


def test_save_keras_h5_names_h5py_where_it_is_absent(tmp_path, monkeypatch):
    real = builtins.__import__

    def no_h5py(name, *a, **k):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py"):
        ckpt_t.save_keras_h5(str(tmp_path / "w.h5"), ct.load(NPZ, device="cpu"))
    assert not (tmp_path / "w.h5").exists()


@pytest.mark.parametrize("count,minimum,want", [
    (0, 256, 256), (255, 256, 256), (256, 256, 256), (257, 256, 512), (1, 4, 4),
    (5000, 256, 8192), (3, 0, 4),
])
def test_capacity_bucket_matches_jax(count, minimum, want):
    assert comp_t.capacity_bucket(count, minimum=minimum) == want
    assert comp_j.capacity_bucket(count, minimum=minimum) == want


@pytest.mark.parametrize("n,p", [(500, 0.3), (64, 0.4), (8, 1.0)])
def test_gather_scatter_round_trip_matches_jax(n, p):
    rng = np.random.default_rng(0)
    mask_np = rng.random(n) < p
    t_np = rng.standard_normal(n).astype(np.float32)
    xyz_np = rng.standard_normal((n, 3)).astype(np.float32)
    cap = comp_t.capacity_bucket(int(mask_np.sum()), minimum=4)
    idx, valid = comp_t.compact_indices(torch.from_numpy(mask_np), cap)
    want_idx = np.nonzero(mask_np)[0]
    np.testing.assert_array_equal(idx.numpy()[:len(want_idx)], want_idx)
    assert int(valid.sum()) == len(want_idx)
    t, xyz = torch.from_numpy(t_np), torch.from_numpy(xyz_np)
    sub_t, sub_xyz = comp_t.gather_state((t, xyz), idx)
    j_t, j_xyz = comp_j.gather_state((jnp.asarray(t_np), jnp.asarray(xyz_np)),
                                     jnp.asarray(idx.numpy()))
    np.testing.assert_array_equal(sub_t.numpy(), np.asarray(j_t))
    np.testing.assert_array_equal(sub_xyz.numpy(), np.asarray(j_xyz))
    (new_t,) = comp_t.scatter_state((t,), (sub_t + 100.0,), idx, valid)
    np.testing.assert_allclose(new_t.numpy()[mask_np], t_np[mask_np] + 100.0, atol=1e-6)
    np.testing.assert_array_equal(new_t.numpy()[~mask_np], t_np[~mask_np])


def test_gather_state_keeps_named_tuples_and_nesting():
    rng = np.random.default_rng(0)
    n = 40
    t = rng.random(n).astype(np.float32)
    act = rng.random(n) < 0.5
    idx = np.array([3, 1, 39, 0, 7])
    st = march_t.MarchState(t=torch.from_numpy(t), budget=torch.from_numpy(t + 1.0),
                            active=torch.from_numpy(act), converged=torch.from_numpy(~act),
                            steps=torch.zeros(n, dtype=torch.int32))
    sj = march_j.MarchState(t=jnp.asarray(t), budget=jnp.asarray(t + 1.0), active=jnp.asarray(act),
                            converged=jnp.asarray(~act), steps=jnp.zeros(n, jnp.int32))
    got = comp_t.gather_state((st, (st.t, st.active)), torch.from_numpy(idx))
    want = comp_j.gather_state(sj, jnp.asarray(idx))
    assert isinstance(got[0], march_t.MarchState)
    for a, b in zip(got[0], want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert type(got[1]) is tuple
    np.testing.assert_array_equal(got[1][0].numpy(), t[idx])
    np.testing.assert_array_equal(got[1][1].numpy(), act[idx])
