"""JAX's gradient at ReLU ties in every chain the port differentiates, on
the CPU.

The JAX package's MLP takes ``jnp.maximum(h, 0.0)``: a pre-activation of
exactly 0 gets the gradient 1/2 (``torch.relu``'s is 0). The port's
``mlp.relu_tie`` gives it, its backward ``kernels.elementwise
.relu_tie_backward`` (one kernel on the card, its plain version here):
  * the plain version equals ``g * heaviside(h, 1/2)`` bit for bit, NaN
    and signed zeros included, and the tie gradient's double backward
    holds the step constant (gradcheck in float64 away from ties);
  * a render's shading normals take it: ``init_mlp``'s zero-bias net
    (seed 3) at Camera() and 16x8, whose pixel (4, 8) meets the surface
    at the origin, where every pre-activation is exactly 0. The port's
    ``render_staged`` and dense ``render_image`` colour there is finite and
    within 1e-4 of JAX's, as is the rest of the image; with ``torch.relu``
    it is NaN.
The card's kernel against this plain version: tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import cudaneuralrender_torch as ct  # noqa: E402
import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch.kernels import elementwise  # noqa: E402
from cudaneuralrender_torch.models import mlp  # noqa: E402

TIE_PIXEL = (4, 8)  # (row, column) of the 16x8 image: the ray through the origin


def test_relu_tie_backward_plain_is_the_step_product():
    rng = np.random.default_rng(0)
    h = rng.standard_normal(1000).astype(np.float32)
    h[::7] = 0.0
    h[1::7] = -0.0
    h[2::11] = np.nan
    g = rng.standard_normal(1000).astype(np.float32)
    g[3::13] = np.inf
    before = elementwise.RELU_TIE_LAUNCHES
    got = elementwise.relu_tie_backward(torch.from_numpy(g), torch.from_numpy(h)).numpy()
    step = np.where(h == 0.0, 0.5, np.where(h > 0.0, 1.0, 0.0)).astype(np.float32)
    with np.errstate(invalid="ignore"):  # inf * 0 is NaN on both sides
        np.testing.assert_array_equal(got, g * step)
    assert elementwise.RELU_TIE_LAUNCHES == before  # CPU tensors never reach the kernel


def test_relu_tie_gradients():
    h = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    w = torch.tensor(3.0, requires_grad=True)
    (g,) = torch.autograd.grad(mlp.relu_tie(h * w).sum(), h, create_graph=True)
    assert g.tolist() == [0.0, 1.5, 3.0]
    (gw,) = torch.autograd.grad(g.sum(), w)  # d/dw of w * step(h w): the step's sum
    assert float(gw) == 1.5
    x = torch.tensor([-1.3, -0.2, 0.4, 2.5], dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(mlp.relu_tie, (x,))
    assert torch.autograd.gradgradcheck(lambda v: mlp.relu_tie(v) * v, (x,))


@pytest.fixture(scope="module")
def zero_bias_net():
    net = ct.init_mlp(torch.Generator().manual_seed(3), device="cpu")
    layers = mlp.to_numpy_params(net)
    assert not any(b.any() for _, b in layers)
    return net, [cj.DenseParams(jnp.asarray(w), jnp.asarray(b)) for w, b in layers]


# The port's coarse phase (utils/config.py, set from the H100's chain
# errors), given to both packages: the JAX package's default is the TPU's.
LADDER = dict(coarse_precision=ct.RenderConfig.coarse_precision,
              coarse_eps=ct.RenderConfig.coarse_eps)


@pytest.mark.parametrize("fn", ["render_staged", "render_image"])
def test_zero_bias_tie_pixel_matches_jax(zero_bias_net, fn, monkeypatch):
    net, pj = zero_bias_net
    kw = dict(width=16, height=8, scene="neural_raw", rgba_packed=False, **LADDER,
              march_impl="staged" if fn == "render_staged" else "while")
    ct.reset_schedule_memo()
    cj.reset_schedule_memo()
    want = np.asarray(getattr(cj, fn)(pj, cj.Camera(), cj.RenderConfig(**kw)))
    got = getattr(ct, fn)(net, ct.Camera(), ct.RenderConfig(**kw)).numpy()
    assert np.isfinite(want[TIE_PIXEL]).all() and want[TIE_PIXEL][3] == 1.0
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    monkeypatch.setattr(mlp, "relu_tie", torch.relu)
    ct.reset_schedule_memo()
    relu = getattr(ct, fn)(net, ct.Camera(), ct.RenderConfig(**kw)).numpy()
    assert np.isnan(relu[TIE_PIXEL][:3]).all()
