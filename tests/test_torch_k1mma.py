"""The march kernel's FP32 chain on the tensor cores (K1), modelled on the
CPU.

A ray per thread the march kernel runs its FP32 chain (precisions
"default" and "highest") as 3xTF32 MMA over a warp's 32 rays at every
width (csrc/chain.cuh ``chain_tf32_regs`` at 32 and 64, the activations in
registers, each k-chunk's truncated sum corrected by a residual MMA and a
fourth product at 32; ``chain_tf32_smem`` from 128, each chunk's sum
rounded to even), which no CPU runs. ``fused_mlp.mlp_chain_3xtf32_mma``
models its summation order at each width; these tests hold that model, on
seeded random 3 -> H x 3 -> 1
nets (tests/test_torch_mma.py's ``random_stack``) and on csg_demo (the
shipped net at 32, widened to H by ``chip_smoke.widen`` above, 9 layers),
points uniform in [-1.2, 1.2]^3:

  * within 1e-5 of the plain FP32 chain at widths 32-1024 (FP32-grade
    sums in two orders, 3xTF32's dropped small * small term; the JAX
    package's bar for its fused forward, tests/test_pallas.py:308);
  * as close to float64 as the FP32 chain in the order it runs on the card
    (mean |error| within 1.25x, max within 2x: test_torch_wide.py's
    float64-witness bar). That order is each output summed from zero in
    input order with fused multiply-adds, bias last: K1's FFMA chain until
    now, and its cuBLAS plain version, bit for bit at the row counts the
    plain versions use (chip_smoke.row_sweep). The CPU's BLAS sums more
    accurately (blocked partial sums; mean |error| 2.7e-8 at 1024 wide),
    and its figures are printed beside;
  * within 1e-5 of the JAX package's ``mlp_forward_pallas`` in interpret
    mode at HIGHEST (its default) at 32, 64, 128 and 256;
  * without the round to even of each chunk's truncated sum, biased low
    against float64 (the reason the wide kernel rounds it);
  * at width 32 without the fourth product a_small * b_small
    (``fused_mlp.tf32_passes``), further from float64 on the shipped net
    (the reason the kernel keeps it there: on the card the march's float64
    witness came to the edge of its bar without it, PERF.md).

tests/test_torch_wide.py marches with the model against the JAX megakernel.
The design variants ``benchmarks/k1_variants.py`` builds on the card are
checked to edit the tree's csrc/ (each replaced text there once).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import cudaneuralrender_torch as ct
from cudaneuralrender_torch.benchmarks import k1_variants
from cudaneuralrender_torch.kernels import build
from cudaneuralrender_torch.kernels import fused_mlp as fused_t
from cudaneuralrender_tpu.pallas import fused_mlp as fused_j
from test_torch_mma import points, random_stack

torch.set_num_threads(2)

WIDTHS = (32, 64, 128, 256, 512, 1024)
ATOL = 1e-5
CSG = chip_smoke.ASSET
# Points a width: the model sums each MMA's products one by one in torch
# (T x H^2 values a layer and pass).
N_POINTS = {32: 4096, 64: 2048, 128: 1024, 256: 512, 512: 128, 1024: 32}


def _stack(net: str, h: int):
    """(weights, biases) of a net packed to width h."""
    if net == "random":
        return random_stack(h, 3, seed=5 * h)
    with np.load(CSG) as data:
        layers = [(data[f"w{i}"], data[f"b{i}"]) for i in range(len(data.files) // 2)]
    if h > 32:
        layers = chip_smoke.widen(layers, h // 32, seed=h)
    params = ct.from_numpy_params(layers, device="cpu")
    weights, biases, _, width = fused_t.pack_params(params)
    assert width == h
    return weights, biases


def _padded(pts: np.ndarray, h: int) -> torch.Tensor:
    x = torch.zeros((pts.shape[0], h))
    x[:, :pts.shape[1]] = torch.from_numpy(pts)
    return x


def _fp32_in_order(weights, biases, x):
    """The FP32 chain as the card sums it: each output from zero in input
    order, one rounding per fused multiply-add (exact in float64), the bias
    last, ReLU on every layer but the last. Returns the head."""
    for l in range(weights.shape[0]):
        acc = torch.zeros((x.shape[0], weights.shape[2]))
        for i in range(weights.shape[1]):
            acc = (acc.double() + x[:, i:i + 1].double() * weights[l, i].double()).float()
        y = acc + biases[l]
        x = y if l + 1 == weights.shape[0] else torch.relu(y)
    return x[:, 0]


def _float64(weights, biases, x):
    y = x.double()
    for l in range(weights.shape[0]):
        y = y @ weights[l].double() + biases[l].double()
        if l + 1 < weights.shape[0]:
            y = torch.relu(y)
    return y[:, 0]


_CACHE = {}


def _heads(net: str, h: int):
    """The model's, the plain FP32 chain's and float64's heads on
    N_POINTS[h] seeded points, and the inputs, computed once per net and
    width."""
    if (net, h) not in _CACHE:
        weights, biases = _stack(net, h)
        x = _padded(points(N_POINTS[h], 3, seed=h + 11), h)
        _CACHE[net, h] = (fused_t.mlp_chain_3xtf32_mma(weights, biases, x),
                          fused_t.mlp_chain_plain(weights, biases, x, weights.shape[0])[:, 0],
                          _float64(weights, biases, x), (weights, biases, x))
    return _CACHE[net, h]


@pytest.mark.parametrize("net", ["random", "csg_demo"])
@pytest.mark.parametrize("h", WIDTHS)
def test_3xtf32_model_matches_plain(h, net):
    model, plain, _, _ = _heads(net, h)
    assert model.shape == (N_POINTS[h],)
    np.testing.assert_allclose(model.numpy(), plain.numpy(), rtol=0, atol=ATOL)
    assert plain.abs().max() > 0.05  # the head carries a signal


@pytest.mark.parametrize("h", WIDTHS)
def test_3xtf32_model_as_close_to_float64_as_fp32(h):
    """csg_demo widened: the model's SDF against float64, beside the FP32
    chain's in the card's order (and the CPU BLAS's, printed)."""
    model, plain, exact, inputs = _heads("csg_demo", h)
    card = _fp32_in_order(*inputs)
    err_m, err_c, err_b = ((v.double() - exact).abs() for v in (model, card, plain))
    print(f"width {h}: |SDF - float64| model mean {err_m.mean():.3g} max {err_m.max():.3g}, "
          f"FP32 chain in the card's order mean {err_c.mean():.3g} max {err_c.max():.3g}, "
          f"CPU BLAS mean {err_b.mean():.3g} max {err_b.max():.3g}")
    assert err_m.mean() <= 1.25 * err_c.mean() and err_m.max() <= 2.0 * err_c.max()


def test_round_to_even_removes_the_truncation_bias(monkeypatch):
    """Why each k-chunk's sum is rounded to even (csrc/mma.cuh
    ``round_to_even``): csg_demo widened to 128, the model with each
    chunk's truncated sum kept as it is sits low against float64 on
    average (every ReLU layer's sums a little low), and rounding it to even
    takes that drift away; the signed mean errors and the FP32 chain's
    (the card's order) are printed."""
    _, _, exact, inputs = _heads("csg_demo", 128)
    rounded = fused_t.mlp_chain_3xtf32_mma(*inputs).double() - exact
    monkeypatch.setattr(fused_t, "round_truncated_to_even", lambda d: d)
    truncated = fused_t.mlp_chain_3xtf32_mma(*inputs).double() - exact
    card = _fp32_in_order(*inputs).double() - exact
    print(f"width 128, SDF - float64 signed mean / mean |.|: truncated chunk sums "
          f"{truncated.mean():.3g} / {truncated.abs().mean():.3g}, rounded to even "
          f"{rounded.mean():.3g} / {rounded.abs().mean():.3g}, FP32 chain in the card's order "
          f"{card.mean():.3g} / {card.abs().mean():.3g}")
    assert truncated.mean() < -1e-7 and truncated.abs().mean() > 2 * card.abs().mean()
    assert rounded.mean().abs() < 0.25 * truncated.mean().abs()


def test_fourth_pass_at_32_brings_the_sdf_to_fp32(monkeypatch):
    """The shipped csg_demo at 32: with the kernel's fourth tf32 product
    per weight the model's mean |SDF - float64| is within 5% of the FFMA
    chain's; with three it lies over 10% further (a 32-wide layer sums too
    few products for the dropped a_small * b_small terms to vanish in the
    sum's own rounding; on the card that took the march's float64 witness
    to the edge of its bar, PERF.md)."""
    assert (fused_t.tf32_passes(32), fused_t.tf32_passes(64)) == (4, 3)
    _, _, exact, inputs = _heads("csg_demo", 32)
    card = (_fp32_in_order(*inputs).double() - exact).abs().mean()
    four = (fused_t.mlp_chain_3xtf32_mma(*inputs).double() - exact).abs().mean()
    monkeypatch.setattr(fused_t, "tf32_passes", lambda h: 3)
    three = (fused_t.mlp_chain_3xtf32_mma(*inputs).double() - exact).abs().mean()
    print(f"width 32, mean |SDF - float64|: 3 passes {three:.3g}, 4 passes {four:.3g}, FP32 chain "
          f"in the card's order {card:.3g}")
    assert four <= 1.05 * card and three > 1.1 * card


@pytest.mark.parametrize("h", WIDTHS[:4])
def test_3xtf32_model_matches_jax_pallas(h):
    """The same inputs through JAX's fused forward, Pallas in interpret
    mode, at its default precision HIGHEST."""
    weights, biases = random_stack(h, 3, seed=h + 3)
    pts = points(256, 3, seed=h + 4)
    want = np.asarray(fused_j.mlp_forward_pallas(
        jnp.asarray(weights.numpy()), jnp.asarray(biases.numpy()), jnp.asarray(pts),
        tile=256, interpret=True))
    got = fused_t.mlp_chain_3xtf32_mma(weights, biases, _padded(pts, h))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_tf32_rna_rounds_to_nearest_ties_away():
    """cvt.rna.tf32.f32: 10 mantissa bits, ties away from zero, on both
    signs; tf32 values are kept."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    half = np.float32(2.0 ** -11)
    v = torch.tensor([one + half, one + half - np.float32(2.0 ** -23), -(one + half),
                      one + ulp, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, one, -(one + ulp), one + ulp, 3.0, 0.0])
    assert torch.equal(fused_t.tf32_rna(v), want)
    x = torch.from_numpy(points(4096, 3, seed=0)).flatten()
    r = fused_t.tf32_rna(x)
    assert torch.equal(fused_t.tf32_rna(r), r)
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("name", sorted(k1_variants.VARIANTS))
def test_k1_variants_edit_the_tree(name):
    """Each design variant that ``benchmarks/k1_variants.py`` builds on the
    card undoes one choice of the tree's csrc/: the text it replaces is
    there, once."""
    path, old, new = k1_variants.VARIANTS[name]
    with open(os.path.join(build.CSRC_DIR, path)) as f:
        text = f.read()
    assert text.count(old) == 1 and new not in text
