"""The render normals' value and gradient (``kernels.fused_mlp``), on the CPU.

The card computes a render's shading normals with one value-and-gradient
kernel (``csrc/value_grad.cu``, ``fused_mlp.mlp_value_grad``; its card
tests are in tests/test_torch_cuda.py). Here:
  * its plain version ``mlp_value_grad_plain`` (the chain rule written out
    on the padded stack) against ``torch.autograd.grad`` of the plain chain
    and against ``jax.grad`` of the JAX package's net, on the same numpy
    inputs, at widths 32, 64 and 128 and 3 and 4 inputs;
  * the zero-bias net at the origin, every pre-activation a tie, gets JAX's
    factor 1/2 (``torch.relu``'s 0 would give a zero gradient);
  * the transposed stack the kernel's backward reads (``packed_mma_t``);
  * ``_ValueGrad``'s backward is the saved gradient times the incoming one,
    with no second derivative;
  * ``renderer.shade_fn`` on the CPU gives the normals it gave before the
    kernel (the plain chain of ``scene_fn(for_grad=True)``), bit for bit;
  * tetrahedron normals, differentiable normals and CPU points take the
    plain chain, counted under ``trace``'s ``normals.autograd_lanes``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import cudaneuralrender_torch as ct  # noqa: E402
import cudaneuralrender_tpu as cj  # noqa: E402
from cudaneuralrender_torch.kernels import fused_mlp  # noqa: E402
from cudaneuralrender_torch.models import mlp  # noqa: E402
from cudaneuralrender_torch.ops import shading  # noqa: E402
from cudaneuralrender_torch.render import renderer, schedule  # noqa: E402
from cudaneuralrender_torch.utils import trace  # noqa: E402
from cudaneuralrender_tpu.render import renderer as jax_renderer  # noqa: E402

FRAME = 37.0
ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples", "assets")


def random_net(hidden: int, n_in: int, seed: int):
    """A 9-layer net ``hidden`` wide with seeded weights and biases (numpy),
    as (w, b) pairs for both packages."""
    rng = np.random.default_rng(seed)
    sizes = (n_in,) + (hidden,) * 8 + (1,)
    return [(rng.normal(0, (2.0 / a) ** 0.5, (a, b)).astype(np.float32),
             rng.normal(0, 0.1, b).astype(np.float32)) for a, b in zip(sizes[:-1], sizes[1:])]


def jax_value_grad(layers, pts: np.ndarray, n_in: int):
    """The JAX package's SDF and its jax.grad at pts [N, 3]."""
    params = [cj.DenseParams(jnp.asarray(w), jnp.asarray(b)) for w, b in layers]
    f = jax_renderer.neural_sdf_fn(params, FRAME, n_in)
    grad = jax.grad(lambda p: f(p).sum())(jnp.asarray(pts))
    return np.asarray(f(jnp.asarray(pts))), np.asarray(grad)


def autograd_value_grad(net, pts: torch.Tensor, n_in: int):
    """The plain chain under autograd (``renderer.neural_sdf_fn``)."""
    p = pts.clone().requires_grad_(True)
    value = renderer.neural_sdf_fn(net, FRAME, n_in)(p)
    (grad,) = torch.autograd.grad(value.sum(), p)
    return value.detach(), grad


@pytest.mark.parametrize("hidden,n_in", [(32, 3), (64, 3), (128, 3), (32, 4), (64, 4),
                                         (128, 4)])
def test_plain_value_grad_matches_autograd_and_jax(hidden, n_in):
    layers = random_net(hidden, n_in, seed=hidden + n_in)
    pts = np.random.default_rng(1).uniform(-1, 1, (300, 3)).astype(np.float32)
    net = mlp.from_numpy_params(layers, device="cpu")
    w, b, _, h = fused_mlp.pack_params(net)
    assert h == hidden
    value, grad = fused_mlp.mlp_value_grad(w, b, torch.from_numpy(pts), n_in, FRAME)
    assert value.shape == (300,) and grad.shape == (300, 3)
    want_v, want_g = autograd_value_grad(net, torch.from_numpy(pts), n_in)
    np.testing.assert_allclose(value.numpy(), want_v.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), want_g.numpy(), rtol=1e-5, atol=1e-6)
    jax_v, jax_g = jax_value_grad(layers, pts, n_in)
    np.testing.assert_allclose(value.numpy(), jax_v, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), jax_g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sizes", [(3, 1), (3, 32, 1), (4, 32, 32, 1)])
def test_plain_value_grad_shallow_nets(sizes):
    net = ct.init_mlp(torch.Generator().manual_seed(4), sizes=sizes, device="cpu")
    with torch.no_grad():
        for layer in net:
            layer.b.normal_(0, 0.1, generator=torch.Generator().manual_seed(5))
    pts = torch.rand(64, 3, generator=torch.Generator().manual_seed(6)) * 2 - 1
    w, b, n_in, _ = fused_mlp.pack_params(net)
    value, grad = fused_mlp.mlp_value_grad(w, b, pts, n_in, FRAME)
    want_v, want_g = autograd_value_grad(net, pts, n_in)
    np.testing.assert_allclose(value.numpy(), want_v.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), want_g.numpy(), rtol=1e-6, atol=1e-7)


def test_zero_bias_net_at_the_origin_takes_the_tie_factor():
    """Every pre-activation of ``init_mlp``'s zero-bias net (seed 3) at the
    origin is exactly 0: the gradient is the product of the weights with
    every factor 1/2, as JAX's jnp.maximum gives it."""
    net = ct.init_mlp(torch.Generator().manual_seed(3), device="cpu")
    layers = mlp.to_numpy_params(net)
    assert not any(b.any() for _, b in layers)
    w, b, _, _ = fused_mlp.pack_params(net)
    origin = torch.zeros(4, 3)
    value, grad = fused_mlp.mlp_value_grad(w, b, origin)
    jax_v, jax_g = jax_value_grad(layers, origin.numpy(), 3)
    chain = layers[-1][0][:, 0].astype(np.float64)
    for wl, _ in layers[-2::-1]:
        chain = wl.astype(np.float64) @ (0.5 * chain)
    assert np.all(value.numpy() == 0.0)
    assert np.abs(chain).max() > 0
    np.testing.assert_allclose(grad.numpy(), np.broadcast_to(chain, (4, 3)), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), jax_g, rtol=1e-5, atol=1e-8)


def test_packed_mma_t_is_the_transposed_stack():
    """Entry [l, kk, j, 4g + t, e] of ``packed_mma_t`` is W_l[8j + g, 8kk +
    2t + e]: ``pack_mma``'s "tf32" order of each layer transposed."""
    net = ct.init_mlp(torch.Generator().manual_seed(2), sizes=(3, 32, 32, 1), device="cpu")
    w, _, _, h = fused_mlp.pack_params(net)
    packed = fused_mlp.packed_mma_t(net)
    assert packed.shape == (3, h // 8, h // 8, 32, 2)
    rng = np.random.default_rng(0)
    for _ in range(200):
        l, kk, j, g, t, e = (int(rng.integers(n)) for n in (3, h // 8, h // 8, 8, 4, 2))
        assert packed[l, kk, j, 4 * g + t, e] == w[l, 8 * j + g, 8 * kk + 2 * t + e]
    assert fused_mlp.packed_mma_t(net) is packed  # cached per parameter state


def test_value_grad_function_backward_is_the_saved_gradient():
    """``_ValueGrad`` returns the value; autograd's gradient through it is
    the saved gradient times the incoming one; a second derivative raises
    rather than reading zero."""
    net = ct.load(os.path.join(ASSETS, "csg_demo.npz"), device="cpu")
    w, b, _, _ = fused_mlp.pack_params(net)
    pts = torch.rand(50, 3, generator=torch.Generator().manual_seed(8)) - 0.5

    def value_grad(p):
        return fused_mlp.mlp_value_grad(w, b, p)

    want_v, want_g = value_grad(pts)
    p = pts.clone().requires_grad_(True)
    value = fused_mlp._ValueGrad.apply(p, value_grad)
    assert torch.equal(value, want_v)
    weight = torch.linspace(-1, 2, 50)
    (g,) = torch.autograd.grad((value * weight).sum(), p, create_graph=True)
    assert torch.equal(g, weight[:, None] * want_g)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g.sum(), p)


@pytest.fixture(scope="module")
def nets():
    return {3: ct.load(os.path.join(ASSETS, "csg_demo.npz"), device="cpu"),
            4: ct.load(os.path.join(ASSETS, "anim_demo.npz"), device="cpu")}


@pytest.mark.parametrize("scene,n_in", [("neural_raw", 3), ("many_sphere", 3),
                                        ("many_cylinder_cut", 3), ("neural_tanh", 3),
                                        ("many_sphere", 4)])
def test_shade_fn_on_the_cpu_is_the_plain_chain(nets, scene, n_in):
    """On the CPU ``shade_fn``'s normals are the plain chain's under
    autograd, as before the kernel, bit for bit."""
    cfg = ct.RenderConfig(scene=scene, num_inputs=n_in)
    pts = (torch.rand(500, 3, generator=torch.Generator().manual_seed(9)) * 2 - 1) * 0.6
    before = fused_mlp.MLP_VALUE_GRAD_LAUNCHES
    got = shading.autodiff_normals(renderer.shade_fn(nets[n_in], cfg, FRAME), pts)
    want = shading.autodiff_normals(
        renderer.scene_fn(nets[n_in], cfg, FRAME, for_grad=True, surface_local=True), pts)
    assert torch.equal(got, want)
    assert fused_mlp.MLP_VALUE_GRAD_LAUNCHES == before
    assert not fused_mlp.value_grad_served(nets[n_in], n_in)  # CPU parameters


@pytest.mark.parametrize("mode,differentiable,per_lane", [("autodiff", False, 1),
                                                          ("autodiff", True, 1),
                                                          ("tetrahedron", False, 4)])
def test_normals_count_their_lanes_through_the_plain_chain(nets, mode, differentiable,
                                                           per_lane):
    """Each shading evaluation counts its points under
    ``normals.autograd_lanes`` (the tetrahedron's four taps a lane), none
    under ``kernel_lanes``: CPU points, the tetrahedron's (no gradient)
    and differentiable normals never reach the kernel."""
    net = nets[3]
    cfg = ct.RenderConfig()
    n = 128
    pts = (torch.rand(n, 3, generator=torch.Generator().manual_seed(10)) * 2 - 1) * 0.6
    dirs = torch.nn.functional.normalize(torch.randn(n, 3, generator=torch.Generator()
                                                     .manual_seed(11)), dim=1)
    trace.enable()
    try:
        trace.reset()
        if differentiable:
            net.requires_grad_(True)
        colors = shading.shade(renderer.shade_fn(net, cfg, 0.0), pts, dirs, normal_mode=mode,
                               differentiable=differentiable)
        counters = trace.snapshot()["counters"]
    finally:
        net.requires_grad_(False)
        trace.reset()
        trace.disable()
    assert torch.isfinite(colors).all()
    assert counters == {"normals.kernel_lanes": 0, "normals.autograd_lanes": per_lane * n}


def test_staged_frame_counts_its_shaded_lanes(nets):
    """A staged frame on the CPU counts its shaded region's lanes under
    ``frame/shade/normals.autograd_lanes``: the first refine bucket, shaded
    in place."""
    cfg = ct.RenderConfig(width=32, height=24, scene="neural_raw", march_impl="staged")
    ct.reset_schedule_memo()
    trace.enable()
    try:
        trace.reset()
        ct.render_staged(nets[3], ct.Camera(), cfg)
        counters = trace.snapshot()["counters"]
    finally:
        trace.reset()
        trace.disable()
    within = schedule.conv_within(cfg)
    region = within if within is not None and within < cfg.num_rays else cfg.num_rays
    shade = {k.split("frame/shade/")[-1]: v for k, v in counters.items() if "frame/shade/" in k}
    assert shade == {"normals.kernel_lanes": 0, "normals.autograd_lanes": region}


def test_card_bar_catches_planted_faults(nets, monkeypatch):
    """chip_smoke's bar for the kernel (``value_grad_agreement``,
    ``value_grad_faults``), run here with the plain version in the kernel's
    place: it passes the plain version, and fails a gradient 1e-4 off
    everywhere, one off at a point whose ReLUs sit away from their kinks,
    and a value 1e-4 off."""
    import chip_smoke

    net = nets[3]
    pts = (torch.rand(2000, 3, generator=torch.Generator().manual_seed(12)) * 2 - 1) * 0.6
    assert chip_smoke.value_grad_faults(chip_smoke.value_grad_agreement(net, pts)) == []
    real = chip_smoke.kernel_value_grad
    far = int(chip_smoke.kink_distance(net, pts).argmax())
    plants = {"gradient": lambda v, g: (v, g * (1 + 1e-4)),
              "one point": lambda v, g: (v, g.index_put((torch.tensor([far]),), -g[far])),
              "value": lambda v, g: (v + 1e-4 * (v.abs() + 1), g)}
    for name, plant in plants.items():
        monkeypatch.setattr(chip_smoke, "kernel_value_grad",
                            lambda *a, plant=plant: plant(*real(*a)))
        assert chip_smoke.value_grad_faults(chip_smoke.value_grad_agreement(net, pts)), name
