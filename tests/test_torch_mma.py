"""The tensor-core kernels' data layout and arithmetic, modelled on the CPU.

The redesigned fused forward (K3, 3xTF32) and three-pass chain (K2h, bf16)
run on mma.sync (csrc/mma.cuh), which no CPU runs. These tests hold what can
be held here:

  * a numpy model of the m16n8k8 tf32 and m16n8k16 bf16 fragment layouts
    (which lane holds which element of A, B and C, from the PTX ISA), through
    which ``fused_mlp.pack_mma`` must unpack to the padded stack exactly, and
    the accumulator-to-A hand-offs the kernels rely on;
  * the port's model of the 3xTF32 chain, ``mlp_chain_3xtf32_mma`` (tf32
    rounding as cvt.rna rounds, each k-chunk's MMAs from zero, aligning and
    truncating, each chunk's sum added to one FP32 accumulator), within
    1e-5 of the plain version and of the JAX package's
    ``mlp_forward_pallas`` in interpret mode (widths 32-256; 512 and 1024
    against the plain version only, for interpret mode's time); and a
    numpy emulation of the three-pass chain as the kernel sums it (products
    exact, each k-chunk's MMAs rounding once to FP32, one FP32
    accumulator), within 1e-5 of its plain version;
  * the port's own model of the three-pass sum, ``mlp_chain_3pass_mma``
    (the numpy one's order, with the tensor cores' alignment and truncation
    inside each MMA; chip_smoke.py holds the kernel against it on the
    card), within 1e-5 of the plain chain on these nets, and on csg_demo's
    9 layers past 1e-5 from the summation order alone.

The nets are seeded random 3 -> H -> H -> H -> 1 MLPs (weights scaled by
1/sqrt(fan-in), so activations stay of unit size), points uniform in
[-1.2, 1.2]^3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudaneuralrender_torch.kernels import fused_mlp as fused_t
from cudaneuralrender_tpu.pallas import fused_mlp as fused_j

torch.set_num_threads(2)

WIDTHS = (32, 64, 128, 256, 512, 1024)
# The emulations sum in the tensor cores' order, the plain versions in
# BLAS's: FP32 sums of H terms in two orders, and 3xTF32 drops the
# small * small term (2^-22 relative); the JAX package's bar for its fused
# forward (tests/test_pallas.py:308).
ATOL = 1e-5


def lane_gt(lane):
    """(group g, thread in group t) of a lane: lane = 4 g + t."""
    return lane // 4, lane % 4


def tf32_a(lane, reg):
    """(row, k) of A register reg (0-3) of m16n8k8 tf32."""
    g, t = lane_gt(lane)
    return g + 8 * (reg & 1), t + 4 * (reg >> 1)


def tf32_b(lane, reg):
    """(k, n) of B register reg (0-1) of m16n8k8 tf32."""
    g, t = lane_gt(lane)
    return t + 4 * reg, g


def bf16_a(lane, reg, half):
    """(row, k) of the half (0 low, 1 high) of A register reg of m16n8k16."""
    g, t = lane_gt(lane)
    return g + 8 * (reg & 1), 2 * t + half + 8 * (reg >> 1)


def bf16_b(lane, reg, half):
    """(k, n) of the half of B register reg (0-1) of m16n8k16 bf16."""
    g, t = lane_gt(lane)
    return 2 * t + half + 8 * reg, g


def c_frag(lane, reg):
    """(row, n) of accumulator register reg (0-3) of both shapes."""
    g, t = lane_gt(lane)
    return g + 8 * (reg >> 1), 2 * t + (reg & 1)


def tf32_row(k):
    """The kernels' permutation of a tf32 k-chunk: the MMA's k = t and
    t + 4 are the chunk's rows 2t and 2t + 1 (csrc/mma.cuh)."""
    return 2 * (k % 4) + k // 4


def unpack(packed: np.ndarray, kind: str, h: int):
    """The stack [L, H, H] (or the two halves) that ``packed`` holds,
    element by element through the fragment model."""
    n_layers = packed.shape[0]
    if kind == "tf32":
        w = np.full((n_layers, h, h), np.nan, np.float32)
        for lane in range(32):
            for reg in range(2):
                k, n = tf32_b(lane, reg)
                for kk in range(h // 8):
                    w[:, 8 * kk + tf32_row(k), n::8] = packed[:, kk, :, lane, reg]
        return w
    halves = []
    for base in (0, 4):  # hi, then lo
        w = np.full((n_layers, h, h), np.nan, np.float32)
        for lane in range(32):
            for reg in range(2):
                for half in range(2):
                    k, n = bf16_b(lane, reg, half)
                    for kk in range(h // 16):
                        w[:, 16 * kk + k, n::8] = packed[:, kk, :, lane, base + 2 * reg + half]
        halves.append(w)
    return halves


def random_stack(h: int, n_in: int, seed: int, n_hidden: int = 3):
    """A seeded 3 (or 4) -> h x n_hidden -> 1 MLP packed to width h:
    weights [L, h, h], biases [L, h] float32 tensors."""
    rng = np.random.default_rng(seed)
    sizes = [n_in] + [h] * n_hidden + [1]
    weights = np.zeros((len(sizes) - 1, h, h), np.float32)
    biases = np.zeros((len(sizes) - 1, h), np.float32)
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        weights[i, :a, :b] = rng.normal(size=(a, b)) / np.sqrt(a)
        biases[i, :b] = rng.normal(size=b) * 0.1
    return torch.from_numpy(weights), torch.from_numpy(biases)


def points(n: int, n_in: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1.2, 1.2, (n, n_in)).astype(np.float32)


@pytest.mark.parametrize("n_in", [3, 4])
@pytest.mark.parametrize("h", WIDTHS)
@pytest.mark.parametrize("kind", ["tf32", "bf16"])
def test_pack_mma_unpacks_to_stack(kind, h, n_in):
    weights, _ = random_stack(h, n_in, seed=h + n_in, n_hidden=1)
    packed = fused_t.pack_mma(weights, kind)
    if kind == "tf32":
        assert packed.dtype == torch.float32
        np.testing.assert_array_equal(unpack(packed.numpy(), kind, h), weights.numpy())
    else:
        assert packed.dtype == torch.bfloat16
        hi, lo = fused_t.split_hi_lo(weights)
        got = unpack(packed.float().numpy(), kind, h)
        np.testing.assert_array_equal(got[0], hi.float().numpy())
        np.testing.assert_array_equal(got[1], lo.float().numpy())
        # padded inputs stay zero in the first layer, read as one k-chunk of 16
        assert not got[0][0, n_in:16].any() and not got[1][0, n_in:16].any()


def test_fragment_model_covers_each_element_once():
    """Every element of A, B and C sits in exactly one (lane, register)."""
    def count(cells, shape):
        seen = np.zeros(shape, int)
        for cell in cells:
            seen[cell] += 1
        return seen

    lanes = range(32)
    assert (count([tf32_a(l, r) for l in lanes for r in range(4)], (16, 8)) == 1).all()
    assert (count([tf32_b(l, r) for l in lanes for r in range(2)], (8, 8)) == 1).all()
    assert (count([bf16_a(l, r, s) for l in lanes for r in range(4) for s in range(2)],
                  (16, 16)) == 1).all()
    assert (count([bf16_b(l, r, s) for l in lanes for r in range(2) for s in range(2)],
                  (16, 8)) == 1).all()
    assert (count([c_frag(l, r) for l in lanes for r in range(4)], (16, 8)) == 1).all()
    assert sorted({tf32_row(k) for k in range(8)}) == list(range(8))


def test_bf16_accumulator_feeds_a_in_place():
    """K2h's hand-off (csrc/chain.cuh chain_3pass_regs): A register r,
    half s of k-chunk kk is accumulator register 2 (r & 1) + s of n-tile
    2 kk + (r >> 1), in the same lane."""
    for lane in range(32):
        for kk in range(4):
            for r in range(4):
                for s in range(2):
                    row, k = bf16_a(lane, r, s)
                    j, reg = 2 * kk + (r >> 1), 2 * (r & 1) + s
                    c_row, c_n = c_frag(lane, reg)
                    assert (row, 16 * kk + k) == (c_row, 8 * j + c_n)


def test_tf32_permuted_a_is_accumulator_pairs():
    """K3 reads a row's a0 / a2 (and a1 / a3) as one 64-bit pair: under the
    permutation, A register r of k-chunk kk is the accumulator element
    (r & 1) * 2 + (r >> 1) of n-tile kk, in the same lane."""
    for lane in range(32):
        for r in range(4):
            row, k = tf32_a(lane, r)
            c_row, c_n = c_frag(lane, 2 * (r & 1) + (r >> 1))
            assert (row, tf32_row(k)) == (c_row, c_n)


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def mma_sum(acc: np.ndarray, terms, chunk: int) -> np.ndarray:
    """acc + sum of a @ b over (a, b) in ``terms`` as the kernels sum it
    (csrc/mma.cuh): per k-chunk of ``chunk``, one MMA per term in order,
    the first from zero, each adding its exact products to its input with
    one rounding to FP32 (the tensor core's own rounding modelled as that
    one, round to nearest; the card truncates, which
    ``fused_mlp.mlp_chain_3pass_mma`` models), then one rounded FP32 add
    into the accumulator. acc [N, O] float32, a [N, K], b [K, O]."""
    terms = [(a.astype(np.float64), b.astype(np.float64)) for a, b in terms]
    for k0 in range(0, terms[0][0].shape[1], chunk):
        s = slice(k0, k0 + chunk)
        part = np.zeros(acc.shape, np.float32)
        for a, b in terms:
            part = (part.astype(np.float64) + a[:, s] @ b[s]).astype(np.float32)
        acc = (acc + part).astype(np.float32)
    return acc


def forward_3xtf32(weights: torch.Tensor, biases: torch.Tensor, x: np.ndarray) -> np.ndarray:
    """3xTF32 as the tensor-core chains sum it, on points x [N, n_in]:
    ``fused_mlp.mlp_chain_3xtf32_mma`` (K1's chain from width 128: per
    k-chunk of 8, a_small * b_big, a_big * b_small, a_big * b_big, each
    chunk's sum added to one FP32 accumulator) on the zero-padded inputs."""
    xp = torch.zeros((x.shape[0], weights.shape[2]))
    xp[:, :x.shape[1]] = torch.from_numpy(x)
    return fused_t.mlp_chain_3xtf32_mma(weights, biases, xp).numpy()


def chain_3pass_one_acc(weights: torch.Tensor, biases: torch.Tensor, x: np.ndarray) -> np.ndarray:
    """K2h as the kernel sums it (csrc/chain.cuh chain_3pass_regs /
    chain_3pass_smem): per layer x_lo * w_hi, x_hi * w_lo, x_hi * w_hi per
    k-chunk of 16, each chunk's sum added to one FP32 accumulator, then
    bias, ReLU; the inputs as one k-chunk padded to 16. x [N, H]
    zero-padded. Returns the head."""
    w_hi, w_lo = (t.float().numpy() for t in fused_t.split_hi_lo(weights))
    b = biases.numpy()
    n_layers = w_hi.shape[0]
    act = x
    for l in range(n_layers):
        xt = torch.from_numpy(np.ascontiguousarray(act))
        x_hi = xt.to(torch.bfloat16).float()
        x_lo = (xt - x_hi).to(torch.bfloat16).float().numpy()
        x_hi = x_hi.numpy()
        k = 16 if l == 0 else act.shape[1]
        acc = mma_sum(np.zeros((act.shape[0], w_hi.shape[2]), np.float32),
                      ((x_lo[:, :k], w_hi[l, :k]), (x_hi[:, :k], w_lo[l, :k]),
                       (x_hi[:, :k], w_hi[l, :k])), 16)
        act = (acc + b[l]).astype(np.float32)
        if l + 1 < n_layers:
            act = np.maximum(act, 0)
    return act[:, 0]


def _n_points(h: int) -> int:
    return 2048 if h <= 128 else 256


@pytest.mark.parametrize("h", WIDTHS)
def test_3xtf32_emulation_matches_plain(h):
    weights, biases = random_stack(h, 3, seed=h)
    x = points(_n_points(h), 3, seed=h)
    want = fused_t.mlp_forward_plain(weights, biases, torch.from_numpy(x)).numpy()
    got = forward_3xtf32(weights, biases, x)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.abs(want).max() > 0.1  # the head carries a signal


@pytest.mark.parametrize("h", WIDTHS[:4])
def test_3xtf32_emulation_matches_jax_pallas(h):
    """The same inputs through JAX's fused forward, Pallas in interpret mode,
    at its default precision HIGHEST."""
    weights, biases = random_stack(h, 3, seed=h)
    x = points(512, 3, seed=h + 1)
    want = np.asarray(fused_j.mlp_forward_pallas(
        jnp.asarray(weights.numpy()), jnp.asarray(biases.numpy()), jnp.asarray(x),
        tile=512, interpret=True))
    np.testing.assert_allclose(forward_3xtf32(weights, biases, x), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_in", [3, 4])
@pytest.mark.parametrize("h", WIDTHS)
def test_three_pass_one_accumulator_matches_plain(h, n_in):
    weights, biases = random_stack(h, n_in, seed=2 * h + n_in)
    n = _n_points(h)
    x = np.zeros((n, h), np.float32)
    x[:, :n_in] = points(n, n_in, seed=h)
    xt = torch.from_numpy(x)
    w_hi, w_lo = fused_t.split_hi_lo(weights)
    want = fused_t.mlp_chain_3pass_plain(w_hi, w_lo, biases, xt, weights.shape[0])[:, 0]
    np.testing.assert_allclose(chain_3pass_one_acc(weights, biases, x), want.numpy(), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("n_in", [3, 4])
@pytest.mark.parametrize("h", WIDTHS[:4])
def test_port_three_pass_model_matches_plain(h, n_in):
    """fused_mlp.mlp_chain_3pass_mma, which chip_smoke.py holds the kernel
    against on the card, within 1e-5 of the plain chain (widths 32-256: the
    model sums in float64, T x 17 x H values an MMA)."""
    weights, biases = random_stack(h, n_in, seed=3 * h + n_in)
    n = _n_points(h) // 2
    x = np.zeros((n, h), np.float32)
    x[:, :n_in] = points(n, n_in, seed=h + 7)
    xt = torch.from_numpy(x)
    w_hi, w_lo = fused_t.split_hi_lo(weights)
    want = fused_t.mlp_chain_3pass_plain(w_hi, w_lo, biases, xt, weights.shape[0])[:, 0]
    got = fused_t.mlp_chain_3pass_mma(weights, biases, xt)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


def test_three_pass_model_on_csg_demo_moves_past_1e5():
    """csg_demo's 9 layers (3 -> 32 x 8 -> 1) on 4096 seeded points: the
    kernel's modelled sum differs from the plain chain by more than 1e-5 at
    some points, from the summation order alone, and stays within
    chip_smoke.K2H_SDF_ATOL, the bar the card holds the kernel to."""
    import chip_smoke
    from cudaneuralrender_torch import load

    params = load(chip_smoke.ASSET, device="cpu")
    weights, biases, n_in, h = fused_t.packed_params(params)
    assert (weights.shape[0], h) == (9, 32)
    x = torch.zeros((4096, h))
    x[:, :n_in] = torch.from_numpy(points(4096, n_in, seed=0))
    w_hi, w_lo = fused_t.split_hi_lo(weights)
    want = fused_t.mlp_chain_3pass_plain(w_hi, w_lo, biases, x, weights.shape[0])[:, 0]
    err = (fused_t.mlp_chain_3pass_mma(weights, biases, x) - want).abs().max().item()
    assert 1e-5 < err <= chip_smoke.K2H_SDF_ATOL


def test_packed_mma_is_cached_per_parameter_state():
    from cudaneuralrender_torch import from_numpy_params

    rng = np.random.default_rng(0)
    params = from_numpy_params([(rng.normal(size=(3, 32)).astype(np.float32),
                                 np.zeros(32, np.float32)),
                                (rng.normal(size=(32, 1)).astype(np.float32),
                                 np.zeros(1, np.float32))], device="cpu")
    first = fused_t.packed_mma(params, "bf16")
    assert fused_t.packed_mma(params, "bf16") is first
    with torch.no_grad():
        params[0].w.mul_(2.0)
    again = fused_t.packed_mma(params, "bf16")
    assert again is not first
    hi, _ = fused_t.split_hi_lo(fused_t.packed_params(params)[0])
    np.testing.assert_array_equal(unpack(again.float().numpy(), "bf16", 32)[0],
                                  hi.float().numpy())
    with pytest.raises(ValueError):
        fused_t.pack_mma(fused_t.packed_params(params)[0], "fp8")
