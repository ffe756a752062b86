"""MLP and checkpoint parity between the PyTorch and JAX packages.

Weights: the shipped csg_demo net (9 dense layers, 3->32x8->1) and random
3-layer 32-wide nets from the JAX package's init_mlp with fixed keys;
points are drawn with numpy from a fixed seed and fed to both packages.
"""
import inspect
import os

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import cudaneuralrender_torch as ct  # noqa: E402
import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch.kernels import fused_mlp as fused_t  # noqa: E402
from cudaneuralrender_tpu.pallas import fused_mlp as fused_j  # noqa: E402

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples", "assets")
H5 = os.path.join(ASSETS, "csg_demo.h5")
NPZ = os.path.join(ASSETS, "csg_demo.npz")


def _nets():
    """(name, jax params, torch params) for each net under test: csg_demo
    and two random 3-layer 32-wide nets from the JAX package's init_mlp,
    carried across as numpy arrays."""
    out = [("csg_demo", cj.load(H5), ct.load(H5, device="cpu"))]
    for seed in (0, 1):
        pj = cj.init_mlp(jax.random.PRNGKey(seed), sizes=(3, 32, 32, 1))
        pt = ct.from_numpy_params([(np.asarray(l.w), np.asarray(l.b)) for l in pj], device="cpu")
        out.append((f"random3_{seed}", pj, pt))
    return out


@pytest.mark.parametrize("path", [H5, NPZ], ids=["h5", "npz"])
def test_loaders_read_identical_arrays(path):
    pj, pt = cj.load(path), ct.load(path, device="cpu")
    assert len(pj) == len(pt) == 9
    for lj, lt in zip(pj, pt):
        np.testing.assert_array_equal(np.asarray(lj.w), lt.w.detach().numpy())
        np.testing.assert_array_equal(np.asarray(lj.b), lt.b.detach().numpy())
    assert ct.mlp.layer_sizes(pt) == cj.mlp.layer_sizes(pj) == (3,) + (32,) * 8 + (1,)
    assert ct.mlp.num_params(pt) == cj.mlp.num_params(pj)


def test_from_numpy_params_roundtrip(tmp_path):
    pj = cj.load(H5)
    pt = ct.from_numpy_params([(l.w, l.b) for l in pj], device="cpu")
    back = ct.mlp.to_numpy_params(pt)
    for lj, (w, b) in zip(pj, back):
        np.testing.assert_array_equal(np.asarray(lj.w), w)
        np.testing.assert_array_equal(np.asarray(lj.b), b)
    # the npz format round-trips across packages
    ct.save_pytree(str(tmp_path / "t.npz"), pt)
    for lj, lr in zip(pj, cj.load_pytree(str(tmp_path / "t.npz"))):
        np.testing.assert_array_equal(np.asarray(lj.w), np.asarray(lr.w))


@pytest.mark.parametrize("net", range(3), ids=["csg_demo", "random3_0", "random3_1"])
def test_apply_scalar_matches_jax(net):
    """4096 seeded points; atol 1e-5: float32 with another summation order
    across up to 9 layers."""
    _name, pj, pt = _nets()[net]
    pts = np.random.default_rng(7).uniform(-1.2, 1.2, (4096, 3)).astype(np.float32)
    want = np.asarray(cj.mlp.apply_scalar(pj, jax.numpy.asarray(pts)))
    got = ct.mlp.apply_scalar(pt, torch.from_numpy(pts)).numpy()
    assert got.shape == (4096,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("net", range(3), ids=["csg_demo", "random3_0", "random3_1"])
def test_mlp_chain_plain_on_packed_params_equals_apply_scalar(net):
    _name, pj, pt = _nets()[net]
    w, b, n_in, h = fused_t.pack_params(pt)
    wj, bj, n_in_j, h_j = fused_j.pack_params(pj)
    assert (n_in, h) == (n_in_j, h_j) == (3, 32)
    np.testing.assert_array_equal(w.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(b.numpy(), np.asarray(bj))
    pts = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, (1000, 3)).astype(np.float32))
    x = torch.zeros((1000, h))
    x[:, :3] = pts
    chain = fused_t.mlp_chain_plain(w, b, x, w.shape[0])[:, 0]
    np.testing.assert_allclose(chain.numpy(), ct.mlp.apply_scalar(pt, pts).numpy(),
                               rtol=0, atol=1e-5)


def test_packed_params_reuses_stack_until_a_parameter_changes():
    pt = ct.load(NPZ, device="cpu")
    first = fused_t.packed_params(pt)
    assert all(a is b for a, b in zip(first, fused_t.packed_params(pt)))
    with torch.no_grad():
        pt[0].b.add_(1.0)  # an in-place write must rebuild the stack
    again = fused_t.packed_params(pt)
    assert again[1] is not first[1]
    fresh = fused_t.pack_params(pt)
    assert torch.equal(again[0], fresh[0]) and torch.equal(again[1], fresh[1])


def test_init_mlp_uses_generator():
    a = ct.init_mlp(torch.Generator().manual_seed(3), sizes=(3, 32, 32, 1), device="cpu")
    b = ct.init_mlp(torch.Generator().manual_seed(3), sizes=(3, 32, 32, 1), device="cpu")
    assert ct.mlp.layer_sizes(a) == (3, 32, 32, 1)
    for la, lb in zip(a, b):
        assert torch.equal(la.w, lb.w)
    assert not any(p.requires_grad for p in a.parameters())


@pytest.mark.parametrize("fn", [ct.load, ct.load_keras_h5, ct.load_pytree, ct.init_mlp,
                                ct.from_numpy_params],
                         ids=["load", "load_keras_h5", "load_pytree", "init_mlp",
                              "from_numpy_params"])
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_without_a_card_raises():
    """With no card, a call that does not name the CPU raises: it never
    quietly returns a CPU model or renders on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ct.load(NPZ)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ct.init_mlp(torch.Generator().manual_seed(0), sizes=(3, 8, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):  # a model-free scene
        ct.render_image(None, ct.Camera(), ct.RenderConfig(width=8, height=8, scene="sphere"))
    img = ct.render_image(None, ct.Camera(), ct.RenderConfig(width=8, height=8, scene="sphere"),
                          device="cpu")
    assert img.shape == (8, 8, 4)
