"""The kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (they build csrc/*.cu) and skip
elsewhere. Run them on the card with:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

Rays at 64x64 from chip_smoke.CAMERA for the staged renderer's three kinds
of call, at the bar chip_smoke.py holds the kernel to (its constants; the
mode ``megakernel.ray_lanes`` picks: the coarse call a ray per thread, at
32 and 64 the refine calls a ray per warp): csg_demo under neural_raw and
under every scene the kernel composes (chip_smoke.SCENES, the 4-input
anim_demo under many_sphere included), each scene's launches counted under
its name; csg_demo widened to 64, 128, 256 and 512 (chip_smoke.widen) under
neural_raw, each width's launches counted, and to 1024 on the bounded calls
(chip_smoke.BOUNDED_VARIANTS). A ray per thread the FP32 chain runs as
3xTF32 on the tensor cores at every width and is held to the bar of a chain
summed in their order (chip_smoke.tc_agreement), its SDF within
chip_smoke.K1_MMA_SDF_ATOL of the plain chain's, with the share equal to a
model of its order (fused_mlp.mlp_chain_3xtf32_mma) printed; at 32 and 64
on every call of every scene and of anim_demo (256x256 rays, where the
bar's shares are read), on lane counts that end
inside a warp (the march replayed with the kernel's own chain, bit for
bit) and on a bucket with no active lane; on the 4-input anim_demo widened
too, and from a cold start (K5). At 128 a ray per thread marches a
block's group of 64 rays at once (csrc/hidden128_group.cuh): every scene
and anim_demo on both chains at that bar, ragged lane counts around the
group (1, 63, 127, 129, 1000, 4095) run to dry and bounded (16 and 24
steps), K5 on both chains, and a seeded 1080p bundle equal bit for bit to
the per-warp chains' recorded outputs (tests/fixtures/w128_bundle.npz).
The fused forward (K3, 3xTF32 on the tensor cores) against its plain
version at every width, on 65536 seeded points, at chip_smoke.K3_ATOL, and
on ragged batches and shallow nets. The three-pass chain (K2h, bf16 MMA over
a warp's rays) inside the march kernel at widths 32-512 against its plain
version, for the HIGH phase's calls (chip_smoke.HIGH_VARIANTS), at 1024 on
the cold coarse call, on the 4-input anim_demo, and its SDF within
chip_smoke.K2H_SDF_ATOL of the plain chain's (the tensor cores sum in their
own order), and near a model of that order
(fused_mlp.mlp_chain_3pass_mma); the plain chains' summation order against the kernel's at 512
and 1024 (chip_smoke.row_sweep: FP32 bit for bit, three-pass within
K2H_SDF_ATOL); the cold-start kernel (K5) against its plain version at
"default" and "high". The step-cost
experiment kernels X1-X3 against their plain versions at chip_smoke.X_RTOL
of each output's own magnitude (chip_smoke.x_scale), every instantiation,
and at the float64 witness bars; X2's lanes beyond X_RTOL accounted for as
chip_smoke.x2_check accounts for them, and partial last warps.
The march kernel's ray-split mode (a ray per warp, the FFMA chain summed
in input order) at widths 32, 64 and 128 (at 128 a warp in each CTA of a
4-CTA cluster, csrc/hidden128_split.cu) against the plain version, bit for
bit (chip_smoke.split_equal): every scene and the 4-input anim_demo on the
three kinds of call, a bucket with no active lane, lane counts that are not
a multiple of a block, and its launches counted; at 128 also terminal-rung
bundles in which lanes stop at max_steps (neural_raw, many_sphere and
many_cylinder_cut's window 5) and the cluster's shared memory by depth. The ReLU tie backward
(``relu_tie_backward``, csrc/elementwise.cu) against its plain version bit
for bit (ties, NaN, ragged tails, unaligned views), inside a CUDA graph,
and in a render's normals at the zero-bias net's tie pixel.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples", "assets")
NPZ = os.path.join(ASSETS, "csg_demo.npz")
# label -> (scene, frame, asset, num_inputs)
CASES = {"neural_raw": ("neural_raw", 0.0, NPZ, 3)}
CASES.update({entry[len("compose_"):]: (scene, frame, asset, n_in)
              for entry, scene, frame, asset, n_in, _ in chip_smoke.SCENES})
VARIANTS = [v[0] for v in chip_smoke.VARIANTS]


@pytest.fixture(scope="module", params=list(CASES))
def agreement(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import camera as camera_lib

    scene, frame, asset, n_in = CASES[request.param]
    dev = torch.device("cuda", 0)
    params = cnr.load(asset, device=dev)
    cfg = cnr.RenderConfig(width=64, height=64, scene=scene, num_inputs=n_in)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**chip_smoke.CAMERA), dev)
    origin, dirs = camera_lib.generate_rays(c2w, 64, 64, cfg.focal)
    before = megakernel.KERNEL_LAUNCHES, megakernel.SCENE_LAUNCHES[scene]
    result = chip_smoke.compare_kernel_with_plain(params, cfg, origin, dirs, frame)
    torch.cuda.synchronize()
    after = megakernel.KERNEL_LAUNCHES, megakernel.SCENE_LAUNCHES[scene]
    return result, (after[0] - before[0], after[1] - before[1])


@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_matches_plain(agreement, variant):
    result, _ = agreement
    chip_smoke.check_agreement({variant: result[variant]})


def test_kernel_launch_counted(agreement):
    """Each call launches once, counted in total and under its scene."""
    _, launches = agreement
    assert launches == (len(VARIANTS), len(VARIANTS))


WIDE = [h for h in chip_smoke.WIDE if not chip_smoke.SIZES[h].bounded]
WIDEST = max(chip_smoke.SIZES)


@pytest.fixture(scope="module", params=sorted(WIDE))
def wide_agreement(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import camera as camera_lib

    hidden = request.param
    dev = torch.device("cuda", 0)
    params = chip_smoke.wide_params(cnr, _copies(hidden), dev)
    cfg = cnr.RenderConfig(width=64, height=64)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**chip_smoke.CAMERA), dev)
    origin, dirs = camera_lib.generate_rays(c2w, 64, 64, cfg.focal)
    before = megakernel.WIDTH_LAUNCHES[hidden]
    result = chip_smoke.compare_kernel_with_plain(params, cfg, origin, dirs)
    torch.cuda.synchronize()
    return result, megakernel.WIDTH_LAUNCHES[hidden] - before


@pytest.mark.parametrize("variant", VARIANTS)
def test_wide_kernel_matches_plain(wide_agreement, variant):
    result, _ = wide_agreement
    chip_smoke.check_agreement({variant: result[variant]})


def test_wide_kernel_launch_counted(wide_agreement):
    _, launches = wide_agreement
    assert launches == len(VARIANTS)


def _copies(hidden):
    """How many times chip_smoke.widen widens csg_demo for a width."""
    return hidden // 32


def test_widest_kernel_matches_plain():
    """Width 1024 on the bounded calls, 64x64 rays, launches counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import camera as camera_lib

    dev = torch.device("cuda", 0)
    params = chip_smoke.wide_params(cnr, _copies(WIDEST), dev)
    cfg = cnr.RenderConfig(width=64, height=64)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**chip_smoke.CAMERA), dev)
    origin, dirs = camera_lib.generate_rays(c2w, 64, 64, cfg.focal)
    before = megakernel.WIDTH_LAUNCHES[WIDEST]
    result = chip_smoke.compare_kernel_with_plain(params, cfg, origin, dirs,
                                                  variants=chip_smoke.BOUNDED_VARIANTS)
    torch.cuda.synchronize()
    assert megakernel.WIDTH_LAUNCHES[WIDEST] - before == len(chip_smoke.BOUNDED_VARIANTS)
    assert all(a["tc_order"] for a in result.values())
    chip_smoke.check_agreement(result)


@pytest.mark.parametrize("hidden", [32] + sorted(WIDE) + [WIDEST])
def test_fp32_tensor_core_sdf(hidden):
    """The kernel's FP32 SDF at every width (3xTF32), read off one step, on
    4096 seeded points: within K1_MMA_SDF_ATOL of the plain chain's
    (chip_smoke.tc_sdf_errors raises otherwise) and of the model of its
    summation order, the share equal to the model bit for bit printed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr

    params = chip_smoke.wide_params(cnr, _copies(hidden), torch.device("cuda", 0))
    r = chip_smoke.tc_sdf_errors(params, hidden, "", n_points=4096)
    print(f"width {hidden}: kernel = model on {r['model_equal']:.4f} of the points, "
          f"= plain chain on {r['plain_equal']:.4f}")
    assert r["kernel_model"] <= chip_smoke.K1_MMA_SDF_ATOL


def test_fp32_tensor_core_four_inputs_matches_plain():
    """The FP32 chain on the tensor cores with the frame as a 4th input:
    anim_demo widened to 128 (chip_smoke.widen) at frame 37 under
    many_sphere, the staged renderer's three kinds of call at 64x64, each
    a ray per thread (``ray_lanes`` sends the terminal rung at 128 a ray
    per warp, held bit for bit by test_split_kernel_matches_thread)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.ops import camera as camera_lib

    dev = torch.device("cuda", 0)
    layers = cnr.mlp.to_numpy_params(cnr.load(os.path.join(ASSETS, "anim_demo.npz"),
                                              device="cpu"))
    params = cnr.from_numpy_params(chip_smoke.widen(layers, 4, seed=37), device=dev)
    cfg = cnr.RenderConfig(width=64, height=64, scene="many_sphere", num_inputs=4)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**chip_smoke.CAMERA), dev)
    origin, dirs = camera_lib.generate_rays(c2w, 64, 64, cfg.focal)
    with chip_smoke.thread_per_ray():
        result = chip_smoke.compare_kernel_with_plain(params, cfg, origin, dirs, 37.0)
    assert all(a["tc_order"] for a in result.values())
    chip_smoke.check_agreement(result)


@pytest.mark.parametrize("hidden", [32] + sorted(WIDE) + [WIDEST])
def test_forward_kernel_matches_plain(hidden):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import fused_mlp

    dev = torch.device("cuda", 0)
    params = chip_smoke.wide_params(cnr, _copies(hidden), dev)
    weights, biases, _, h = fused_mlp.packed_params(params)
    assert h == hidden
    pts = torch.as_tensor(np.random.default_rng(0).uniform(-1.2, 1.2, (65536, 3))
                          .astype(np.float32), device=dev)
    before = fused_mlp.MLP_LAUNCHES
    got = fused_mlp.mlp_forward(weights, biases, pts, fused_mlp.packed_mma(params, "tf32"))
    torch.cuda.synchronize()
    assert fused_mlp.MLP_LAUNCHES == before + 1
    want = fused_mlp.mlp_forward_plain(weights, biases, pts)
    assert (got - want).abs().max().item() <= chip_smoke.K3_ATOL


@pytest.mark.parametrize("n", [1, 1000, 4097])
@pytest.mark.parametrize("hidden,sizes", [(32, (3, 20, 1)), (32, (4, 1)), (128, (3, 100, 90, 1)),
                                          (1024, (3, 1000, 1))])
def test_forward_kernel_ragged(hidden, sizes, n):
    """K3 on batches that end inside a tile and on 1- to 3-layer nets (the
    head as the first layer, no hidden layer), 3 and 4 inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import fused_mlp

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(n)
    layers = [((rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32),
               (rng.normal(size=b) * 0.1).astype(np.float32)) for a, b in zip(sizes, sizes[1:])]
    params = cnr.from_numpy_params(layers, device=dev)
    weights, biases, n_in, h = fused_mlp.packed_params(params)
    assert h == hidden
    pts = torch.as_tensor(rng.uniform(-1.2, 1.2, (n, n_in)).astype(np.float32), device=dev)
    got = fused_mlp.mlp_forward(weights, biases, pts, fused_mlp.packed_mma(params, "tf32"))
    want = fused_mlp.mlp_forward_plain(weights, biases, pts)
    assert got.shape == (n,)
    assert (got - want).abs().max().item() <= chip_smoke.K3_ATOL


HIGH_VARIANTS = [v[0] for v in chip_smoke.HIGH_VARIANTS]


@pytest.fixture(scope="module", params=[32] + sorted(WIDE))
def high_agreement(request):
    """The three-pass chain (K2h) inside the march kernel against its plain
    version, csg_demo (widened) rays at 64x64, the HIGH phase's calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import camera as camera_lib

    hidden = request.param
    dev = torch.device("cuda", 0)
    params = chip_smoke.wide_params(cnr, _copies(hidden), dev)
    cfg = cnr.RenderConfig(width=64, height=64)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**chip_smoke.CAMERA), dev)
    origin, dirs = camera_lib.generate_rays(c2w, 64, 64, cfg.focal)
    before = megakernel.THREE_PASS_LAUNCHES[hidden]
    result = chip_smoke.compare_high_with_plain(params, cfg, origin, dirs)
    torch.cuda.synchronize()
    return params, result, megakernel.THREE_PASS_LAUNCHES[hidden] - before


@pytest.mark.parametrize("variant", HIGH_VARIANTS)
def test_three_pass_kernel_matches_plain(high_agreement, variant):
    _, result, _ = high_agreement
    chip_smoke.check_agreement({variant: result[variant]})


def test_three_pass_kernel_launch_counted(high_agreement):
    _, _, launches = high_agreement
    assert launches == len(HIGH_VARIANTS)


def test_three_pass_sdf_matches_plain_chain(high_agreement):
    """The kernel's three-pass SDF, read off one step, within
    K2H_SDF_ATOL of the plain chain's on 4096 seeded points: the tensor
    cores sum the three passes in one accumulator in their own order, so
    the two are no longer equal bit for bit."""
    from cudaneuralrender_torch.kernels import fused_mlp

    params, _, _ = high_agreement
    dev = params.device
    pts = torch.as_tensor(np.random.default_rng(1).uniform(-1.2, 1.2, (4096, 3))
                          .astype(np.float32), device=dev)
    weights, biases, n_in, h = fused_mlp.packed_params(params)
    w_hi, w_lo = fused_mlp.packed_hi_lo(params)
    x = torch.zeros((4096, h), dtype=torch.float32, device=dev)
    x[:, :n_in] = pts
    want = fused_mlp.mlp_chain_3pass_plain(w_hi, w_lo, biases, x, weights.shape[0])[:, 0]
    got = chip_smoke.kernel_sdf(params, pts, "high")
    assert (got - want).abs().max().item() <= chip_smoke.K2H_SDF_ATOL


# The kernel against the model of its own summation order
# (fused_mlp.mlp_chain_3pass_mma): both sum the same exact bfloat16 products
# per k-chunk, so where the model is right they agree bit for bit; where an
# MMA rounds otherwise, the chain carries a one-ulp difference to the head
# (more often the more MMAs a point takes, so the share is held at 32 and
# 64 and printed at every width by chip_smoke.py phase 10). A fault of the
# split or the hand-off would leave almost no point equal.
K2H_MODEL_MIN_EQUAL = 0.5


@pytest.mark.parametrize("hidden", [32, 64])
def test_three_pass_sdf_matches_summation_model(hidden):
    """The kernel's three-pass SDF (csg_demo, widened to 64) against
    fused_mlp.mlp_chain_3pass_mma on 4096 seeded points: equal bit for bit
    on at least K2H_MODEL_MIN_EQUAL of them, on more than the plain chain
    is, and within K2H_SDF_ATOL everywhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import fused_mlp

    dev = torch.device("cuda", 0)
    params = chip_smoke.wide_params(cnr, _copies(hidden), dev)
    pts = torch.as_tensor(np.random.default_rng(2).uniform(-1.2, 1.2, (4096, 3))
                          .astype(np.float32), device=dev)
    weights, biases, n_in, h = fused_mlp.packed_params(params)
    w_hi, w_lo = fused_mlp.packed_hi_lo(params)
    x = torch.zeros((4096, h), dtype=torch.float32, device=dev)
    x[:, :n_in] = pts
    model = fused_mlp.mlp_chain_3pass_mma(weights, biases, x)
    plain = fused_mlp.mlp_chain_3pass_plain(w_hi, w_lo, biases, x, weights.shape[0])[:, 0]
    got = chip_smoke.kernel_sdf(params, pts, "high")
    equal = (got == model).float().mean().item()
    assert equal >= K2H_MODEL_MIN_EQUAL
    assert equal > (got == plain).float().mean().item()
    assert (got - model).abs().max().item() <= chip_smoke.K2H_SDF_ATOL


def test_widest_three_pass_kernel_matches_plain():
    """K2h at width 1024: the cold coarse call at the HIGH phase's eps,
    32x32 rays, and the kernel's SDF within K2H_SDF_ATOL of the plain
    chain's on 1024 seeded points (the tensor cores' summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import fused_mlp, megakernel
    from cudaneuralrender_torch.ops import camera as camera_lib
    from cudaneuralrender_torch.ops import march

    dev = torch.device("cuda", 0)
    params = chip_smoke.wide_params(cnr, _copies(WIDEST), dev)
    cfg = cnr.RenderConfig(width=32, height=32)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**chip_smoke.CAMERA), dev)
    origin, dirs = camera_lib.generate_rays(c2w, 32, 32, cfg.focal)
    cold = march.init_state(origin, dirs, cfg.bound_center, cfg.bound_radius)
    kw = dict(march_eps=chip_smoke.HIGH_EPS, precision="high", relax_omega=1.6,
              return_resolve=True)
    before = megakernel.THREE_PASS_LAUNCHES[WIDEST]
    k = megakernel.march_state(params, origin, dirs, cold, cfg, **kw)
    torch.cuda.synchronize()
    assert megakernel.THREE_PASS_LAUNCHES[WIDEST] == before + 1
    p = megakernel.march_state_plain(params, origin, dirs, cold, cfg, **kw)
    chip_smoke.check_agreement({"coarse": chip_smoke.tc_agreement(
        params, (origin, dirs, cold, cfg, 0.0, kw), k, p)})
    pts = torch.as_tensor(np.random.default_rng(1).uniform(-1.2, 1.2, (1024, 3))
                          .astype(np.float32), device=dev)
    weights, biases, n_in, h = fused_mlp.packed_params(params)
    w_hi, w_lo = fused_mlp.packed_hi_lo(params)
    x = torch.zeros((1024, h), dtype=torch.float32, device=dev)
    x[:, :n_in] = pts
    want = fused_mlp.mlp_chain_3pass_plain(w_hi, w_lo, biases, x, weights.shape[0])[:, 0]
    got = chip_smoke.kernel_sdf(params, pts, "high")
    assert (got - want).abs().max().item() <= chip_smoke.K2H_SDF_ATOL


@pytest.mark.parametrize("hidden", [512, WIDEST])
def test_plain_chains_sum_in_kernel_order(hidden):
    """The row counts the plain versions use sum the FP32 chain in the
    kernel's order, and the three-pass chain within K2H_SDF_ATOL of the
    tensor cores' (chip_smoke.row_sweep raises otherwise), at 512 and 1024."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr

    params = chip_smoke.wide_params(cnr, _copies(hidden), torch.device("cuda", 0))
    chip_smoke.row_sweep(params, "", n_points=1 << 16)


def _x_rays(n=4096):
    """n rays of chip_smoke.CAMERA through a 64x64 image in the JAX layout:
    dirs [3, n], t0 [1, n] = 0.8, origin [3, 1]."""
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.ops import camera as camera_lib

    dev = torch.device("cuda", 0)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**chip_smoke.CAMERA), dev)
    origin, dirs = camera_lib.generate_rays(c2w, 64, 64, 1.0)
    return (dirs[:n].t().contiguous(), torch.full((1, n), 0.8, device=dev),
            origin.reshape(3, 1).contiguous())


@pytest.mark.parametrize("lanes", [4096, 4001])
@pytest.mark.parametrize("hidden", [32, 128])
def test_x1_kernel_matches_plain(hidden, lanes):
    """X1 on the tensor cores against its plain version (X_RTOL), beside the
    model of its order, and at the float64 witness bars; 4001 lanes end in
    a partial warp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cudaneuralrender_torch.benchmarks import exp_blockdiag as x1

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(hidden)
    x = torch.as_tensor(rng.normal(size=(hidden, lanes)).astype(np.float32), device=dev)
    w = torch.as_tensor((rng.normal(size=(hidden, hidden)) * (1.2 / hidden ** 0.5))
                        .astype(np.float32), device=dev)
    b = torch.as_tensor((rng.normal(size=hidden) * 0.1).astype(np.float32), device=dev)
    before = x1.LAUNCHES[hidden]
    got = x1.chain(x, w, b, reps=18)
    torch.cuda.synchronize()
    assert x1.LAUNCHES[hidden] == before + 1
    want = x1.chain_plain(x, w, b, 18)
    exact = chip_smoke.x1_float64(x, w, b, 18)
    check = chip_smoke.compare_outputs(got, want, chip_smoke.x1_scale(exact))
    check["model_max_abs_err"] = (got - x1.chain_model(x, w, b, 18)).abs().max().item()
    check["witness"] = chip_smoke.x_witness(got, want, exact)
    print(check)
    chip_smoke.check_outputs("x1", check)


@pytest.mark.parametrize("n", [4096, 4001])
@pytest.mark.parametrize("chain", ["fp32", "three_pass", "bf16_input"])
@pytest.mark.parametrize("variant", ["chain_only", "march_state", "march_relax"])
def test_x2_kernel_matches_plain(variant, chain, n):
    """X2 on the tensor cores (K1's tf32 chain, K2h's bf16 chain) against
    its plain version as phase 11 holds it (``chip_smoke.x2_check``: X_RTOL,
    the lanes beyond it accounted for as ``undecided_bar`` holds them, every
    lane replayed on both sides, the kernel's on its own chain), beside the
    model of its order, and at the float64 witness bars on 4096 seeded
    points; 4001 lanes end in a partial warp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.benchmarks import demo_stack
    from cudaneuralrender_torch.benchmarks import exp_stepcost as x2

    dev = torch.device("cuda", 0)
    weights, biases = demo_stack(dev)
    params = cnr.load(NPZ, device=dev)
    three_pass = chain == "three_pass"
    kw = dict(steps=16, three_pass=three_pass,
              act_dtype=torch.bfloat16 if chain == "bf16_input" else torch.float32)
    key = variant + ("_3pass" if three_pass else "")
    rays = _x_rays(n)
    before = x2.LAUNCHES[key]
    got = x2.step_cost(variant, weights, biases, *rays, **kw)
    torch.cuda.synchronize()
    assert x2.LAUNCHES[key] == before + 1
    want = x2.step_cost_plain(variant, weights, biases, *rays, **kw)
    check = chip_smoke.x2_check(
        variant, chip_smoke.x2_chains(weights, biases, params, three_pass),
        lambda p: chip_smoke.sdf_float64(params, p), rays, got, want, steps=kw["steps"],
        act_dtype=kw["act_dtype"],
        sdf_atol=chip_smoke.K2H_SDF_ATOL if three_pass else chip_smoke.K1_MMA_SDF_ATOL)
    check["model_max_abs_err"] = (
        got - x2.step_cost_model(variant, weights, biases, *rays, **kw)).abs().max().item()
    gen = torch.Generator(dev).manual_seed(2)
    pts = torch.rand((4096, 3), generator=gen, device=dev) * 2.4 - 1.2
    check["witness"] = chip_smoke.x2_witness(weights, biases, params, pts, three_pass)
    print(check)
    chip_smoke.check_outputs("x2", check)


@pytest.mark.parametrize("n", [4096, 4001])
@pytest.mark.parametrize("variant", ["v0", "v1", "v2", "v3", "v5", "v5p"])
def test_x3_kernel_matches_plain(variant, n):
    """X3 on the tensor cores against its plain version (X_RTOL), beside the
    model of its order, and at the float64 witness bars on 4096 seeded
    points; 4001 lanes end in a partial warp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cudaneuralrender_torch.benchmarks import exp_stepcost2 as x3

    dev = torch.device("cuda", 0)
    weights, biases, dirs, t0, origin = x3.setup(dev, n=n)
    if variant in ("v3", "v5", "v5p"):
        t0 = torch.zeros_like(t0)  # t then carries the SDF at full precision
    before = x3.LAUNCHES[variant]
    got = x3.ablation(variant, weights, biases, dirs, t0, origin, steps=2)
    torch.cuda.synchronize()
    assert x3.LAUNCHES[variant] == before + 1
    want = x3.ablation_plain(variant, weights, biases, dirs, t0, origin, steps=2)
    check = chip_smoke.compare_outputs(got, want, chip_smoke.x_scale(variant, 2))
    check["model_max_abs_err"] = (got - x3.ablation_model(
        variant, weights, biases, dirs, t0, origin, steps=2)).abs().max().item()
    gen = torch.Generator(dev).manual_seed(2)
    pts = torch.rand((4096, 3), generator=gen, device=dev) * 2.4 - 1.2
    rays = chip_smoke.x3_witness_rays(pts)
    check["witness"] = chip_smoke.x_witness(
        x3.ablation(variant, weights, biases, *rays, steps=1),
        x3.ablation_plain(variant, weights, biases, *rays, steps=1),
        chip_smoke.x3_float64(variant, weights, biases, pts))
    print(check)
    chip_smoke.check_outputs("x3", check)


def test_three_pass_four_inputs_matches_plain():
    """K2h with the frame as a 4th input (anim_demo, frame 37, under
    many_sphere) against its plain version on the HIGH phase's calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.ops import camera as camera_lib
    from cudaneuralrender_torch.ops import march

    dev = torch.device("cuda", 0)
    params = cnr.load(os.path.join(ASSETS, "anim_demo.npz"), device=dev)
    cfg = cnr.RenderConfig(width=64, height=64, scene="many_sphere", num_inputs=4)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**chip_smoke.CAMERA), dev)
    origin, dirs = camera_lib.generate_rays(c2w, 64, 64, cfg.focal)
    from cudaneuralrender_torch.kernels import megakernel

    cold = march.init_state(origin, dirs, cfg.bound_center, cfg.bound_radius)
    kw = dict(march_eps=chip_smoke.HIGH_EPS, precision="high", relax_omega=1.6,
              return_resolve=True)
    k = megakernel.march_state(params, origin, dirs, cold, cfg, 37.0, **kw)
    p = megakernel.march_state_plain(params, origin, dirs, cold, cfg, 37.0, **kw)
    chip_smoke.check_agreement({"coarse": chip_smoke.tc_agreement(
        params, (origin, dirs, cold, cfg, 37.0, kw), k, p)})


@pytest.mark.parametrize("precision", ["default", "high"])
def test_raygen_kernel_matches_plain(precision):
    """K5 against its plain version: csg_demo at 64x64 in 16x16 block order
    plus 8 pad lanes, the coarse call's eps and relaxation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import camera as camera_lib
    from cudaneuralrender_torch.render import renderer

    dev = torch.device("cuda", 0)
    params = cnr.load(NPZ, device=dev)
    cfg = cnr.RenderConfig(width=64, height=64)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**chip_smoke.CAMERA), dev)
    pos = torch.cat([renderer._block_order(64, 64, 16, 16, dev),
                     torch.full((8,), -1, dtype=torch.int32, device=dev)])
    eps = chip_smoke.COARSE_FP32["coarse_eps"] if precision == "default" else cfg.coarse_eps
    kw = dict(march_eps=eps, precision=precision, relax_omega=cfg.relax_omega,
              return_resolve=True, cyl_window=cfg.cyl_window_coarse)
    before = megakernel.RAYGEN_LAUNCHES
    k = megakernel.march_raygen(params, c2w, pos, cfg, **kw)
    torch.cuda.synchronize()
    assert megakernel.RAYGEN_LAUNCHES == before + 1
    p = megakernel.march_raygen_plain(params, c2w, pos, cfg, **kw)
    # K5 marches a ray per thread, as a frame's coarse call does
    call = (*megakernel.raygen_state(c2w, pos, cfg), cfg, 0.0, dict(kw, coarse=True))
    a = chip_smoke.call_agreement(params, call, k, p)
    assert a["tc_order"]  # the FP32 chain too: 3xTF32 a ray per thread
    chip_smoke.check_agreement({"raygen": a})
    pad = pos < 0
    assert not k[0].active[pad].any() and not k[0].converged[pad].any()


@pytest.mark.parametrize("precision", ["default", "high"])
def test_raygen_fp32_tensor_core_matches_plain(precision):
    """K5 at 128 (a block's group of rays at once): csg_demo widened to 128
    at 64x64 in 16x16 block order plus 8 pad lanes (a partial last warp
    and group), the coarse call's eps and relaxation, with the FP32 chain
    on the tensor cores (COARSE_FP32) and the three-pass chain (the default
    coarse call), at the tensor-core bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import camera as camera_lib
    from cudaneuralrender_torch.render import renderer

    dev = torch.device("cuda", 0)
    params = chip_smoke.wide_params(cnr, 4, dev)
    fields = chip_smoke.COARSE_FP32 if precision == "default" else {}
    cfg = cnr.RenderConfig(width=64, height=64, **fields)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**chip_smoke.CAMERA), dev)
    pos = torch.cat([renderer._block_order(64, 64, 16, 16, dev),
                     torch.full((8,), -1, dtype=torch.int32, device=dev)])
    kw = dict(march_eps=cfg.coarse_eps, precision=cfg.coarse_precision,
              relax_omega=cfg.relax_omega, return_resolve=True, cyl_window=cfg.cyl_window_coarse)
    k = megakernel.march_raygen(params, c2w, pos, cfg, **kw)
    p = megakernel.march_raygen_plain(params, c2w, pos, cfg, **kw)
    a = chip_smoke.call_agreement(
        params, (*megakernel.raygen_state(c2w, pos, cfg), cfg, 0.0, dict(kw, coarse=True)), k, p)
    assert a["tc_order"]
    chip_smoke.check_agreement({"raygen": a})
    pad = pos < 0
    assert not k[0].active[pad].any() and not k[0].converged[pad].any()


# The two modes of the FP32 chain at 32 and 64 on the staged renderer's
# three kinds of call at 64x64 (chip_smoke.variant_calls): csg_demo at 32
# and widened to 64 (chip_smoke.widen) under every scene, anim_demo (4
# inputs, frame 37) at both widths too. A ray per warp (csrc/march.cuh
# march_split_kernel) against the plain version bit for bit
# (chip_smoke.split_equal); a ray per thread (3xTF32 on the tensor cores)
# against it at the tensor-core bar (chip_smoke.tc_agreement). A ray per
# warp at 128 too (csrc/hidden128_split.cu), on csg_demo and anim_demo
# widened to 128.
SPLIT_CASES = [(label, hidden) for label in CASES for hidden in (32, 64)]
SPLIT_WARP_CASES = SPLIT_CASES + [(label, 128) for label in CASES]


def _split_params(asset, hidden, dev):
    import cudaneuralrender_torch as cnr

    layers = cnr.mlp.to_numpy_params(cnr.load(asset, device="cpu"))
    k = hidden // 32
    return cnr.from_numpy_params(chip_smoke.widen(layers, k, seed=k) if k > 1 else layers,
                                 device=dev)


@pytest.fixture(scope="module", params=SPLIT_WARP_CASES,
                ids=[f"{c}_h{h}" for c, h in SPLIT_WARP_CASES])
def split_calls(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.ops import camera as camera_lib

    label, hidden = request.param
    scene, frame, asset, n_in = CASES[label]
    dev = torch.device("cuda", 0)
    params = _split_params(asset, hidden, dev)
    cfg = cnr.RenderConfig(width=64, height=64, scene=scene, num_inputs=n_in)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**chip_smoke.CAMERA), dev)
    origin, dirs = camera_lib.generate_rays(c2w, 64, 64, cfg.focal)
    return params, {name: call for name, call, _ in
                    chip_smoke.variant_calls(params, cfg, origin, dirs, frame)}


@pytest.mark.parametrize("variant", VARIANTS)
def test_split_kernel_matches_thread(split_calls, variant):
    """A ray per warp equals the plain version bit for bit (the plain
    chain's order; a ray per thread now sums on the tensor cores)."""
    params, calls = split_calls
    call = calls[variant]
    assert bool(call[2].active.any())
    (_, lane_steps), _ = chip_smoke.split_equal(params, call)
    torch.cuda.synchronize()
    assert int(lane_steps.max()) > int(call[2].steps)  # the rays marched


def _thread_call(params, call):
    """``call`` through the kernel a ray per thread and through the plain
    version: (kernel output, plain output), (state, lane steps) each."""
    from cudaneuralrender_torch.kernels import megakernel

    origin, dirs, state, cfg, frame, kw = call
    kw = dict(kw, return_resolve=True)
    k = megakernel.march_state(params, origin, dirs, state, cfg, frame, _ray_lanes=1, **kw)
    return k, megakernel.march_state_plain(params, origin, dirs, state, cfg, frame, **kw)


# The tensor-core bar's shares (chip_smoke.TC_STRAGGLERS: 1e-4 of the
# lanes) are read on calls of 65536 lanes and more (chip_smoke.py phase 3's
# 256x256 rays and up): on 64x64 rays one straggler is 2.4e-4 of the lanes.
# So a ray per thread is held to it on the three kinds of call at 256x256.
THREAD_SIDE = 256


# A ray per thread at 128 marches a block's group of rays at once
# (csrc/hidden128_group.cuh): every scene and window instantiation there,
# and anim_demo widened to 128 (4 inputs), at the same bar.
THREAD_CASES = SPLIT_WARP_CASES


@pytest.fixture(scope="module", params=THREAD_CASES, ids=[f"{c}_h{h}" for c, h in THREAD_CASES])
def thread_calls(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.ops import camera as camera_lib

    label, hidden = request.param
    scene, frame, asset, n_in = CASES[label]
    dev = torch.device("cuda", 0)
    params = _split_params(asset, hidden, dev)
    cfg = cnr.RenderConfig(width=THREAD_SIDE, height=THREAD_SIDE, scene=scene, num_inputs=n_in)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**chip_smoke.CAMERA), dev)
    origin, dirs = camera_lib.generate_rays(c2w, THREAD_SIDE, THREAD_SIDE, cfg.focal)
    return params, {name: (call, p) for name, call, p in
                    chip_smoke.variant_calls(params, cfg, origin, dirs, frame)}


@pytest.mark.parametrize("variant", VARIANTS)
def test_thread_kernel_matches_plain(thread_calls, variant):
    """A ray per thread (3xTF32 on the tensor cores) against the plain
    version at the tensor-core bar, replays and undecided lanes included,
    on 256x256 rays."""
    from cudaneuralrender_torch.kernels import megakernel

    params, calls = thread_calls
    call, p = calls[variant]
    origin, dirs, state, cfg, frame, kw = call
    k = megakernel.march_state(params, origin, dirs, state, cfg, frame, _ray_lanes=1, **kw)
    a = chip_smoke.tc_agreement(params, call, k, p)
    chip_smoke.check_agreement({variant: a})


@pytest.mark.parametrize("label", list(CASES))
def test_three_pass_group_kernel_matches_plain(label):
    """The three-pass chain at 128 (a block's group of rays at once) under
    every scene and window instantiation and on the 4-input anim_demo
    widened to 128: the HIGH phase's calls at THREAD_SIDE (where the bar's
    shares are read) against the plain version at the kernel bar
    (chip_smoke.compare_high_with_plain), each launch counted under the
    width's three-pass launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import camera as camera_lib

    scene, _, asset, n_in = CASES[label]
    dev = torch.device("cuda", 0)
    params = _split_params(asset, 128, dev)
    cfg = cnr.RenderConfig(width=THREAD_SIDE, height=THREAD_SIDE, scene=scene, num_inputs=n_in)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**chip_smoke.CAMERA), dev)
    origin, dirs = camera_lib.generate_rays(c2w, THREAD_SIDE, THREAD_SIDE, cfg.focal)
    before = megakernel.THREE_PASS_LAUNCHES[128]
    result = chip_smoke.compare_high_with_plain(params, cfg, origin, dirs)
    torch.cuda.synchronize()
    assert megakernel.THREE_PASS_LAUNCHES[128] - before == len(HIGH_VARIANTS)
    chip_smoke.check_agreement(result)


W128_BUNDLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                           "w128_bundle.npz")


def test_group_kernel_equals_recorded_bundle():
    """The 128-wide march a ray per thread equals, bit for bit (t, budget,
    the flags, each lane's steps), the outputs that the per-warp chains
    (march.cuh march_kernel on chain_tf32_smem / chain_3pass_smem) gave on
    the card for a seeded bundle of a 1080p pose's rays (tests/w128_bundle.py:
    the coarse calls of both chains, the refine rungs of 16 and 24 steps,
    the cold start K5 at both precisions), the later calls starting from
    the recorded outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    import w128_bundle

    rec = np.load(W128_BUNDLE)
    dev = torch.device("cuda", 0)
    params = chip_smoke.wide_params(cnr, 4, dev)
    assert w128_bundle.fingerprint(params) == float(rec["fingerprint"])
    cfg = cnr.RenderConfig(width=w128_bundle.WIDTH, height=w128_bundle.HEIGHT,
                           march_impl="staged")
    inputs = [torch.as_tensor(rec[k], device=dev) for k in ("c2w", "origin", "dirs", "pos")]
    out = w128_bundle.run_calls(cnr, params, cfg, *inputs, recorded=rec)
    torch.cuda.synchronize()
    assert sorted(out) == sorted(w128_bundle.CALLS)
    for name, values in out.items():
        for key, got in zip(w128_bundle.OUTPUTS, values):
            want = torch.as_tensor(rec[f"{name}.{key}"], device=dev)
            assert torch.equal(got, want), (name, key, int((got != want).sum()))


def _replay_equal(params, call, k):
    """The plain march of ``call`` with the kernel's own chain read off the
    card (chip_smoke.kernel_chain) lands on the kernel's output ``k`` bit
    for bit, and that chain stays within K1_MMA_SDF_ATOL of the plain one at
    every point it visits."""
    from cudaneuralrender_torch.kernels import megakernel

    origin, dirs, state, cfg, frame, kw = call
    plain = megakernel._chain_plain(params, "highest")
    worst = [0.0]

    def compare(x, d):
        worst[0] = max(worst[0], (plain(x)[:, 0] - d).abs().max().item())

    r, rs = megakernel.march_state_plain(
        params, origin, dirs, state, cfg, frame,
        chain=chip_smoke.kernel_chain(params, "highest", frame, compare),
        **dict(kw, return_resolve=True))
    ko, ks = k
    for x, y in ((r.t, ko.t), (r.budget, ko.budget), (r.active, ko.active),
                 (r.converged, ko.converged), (rs, ks), (r.steps, ko.steps)):
        assert torch.equal(x, y)
    assert worst[0] <= chip_smoke.K1_MMA_SDF_ATOL

def _terminal_call(hidden):
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.ops import camera as camera_lib

    dev = torch.device("cuda", 0)
    params = _split_params(NPZ, hidden, dev)
    cfg = cnr.RenderConfig(width=64, height=64)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**chip_smoke.CAMERA), dev)
    origin, dirs = camera_lib.generate_rays(c2w, 64, 64, cfg.focal)
    (_, call, _), = chip_smoke.variant_calls(params, cfg, origin, dirs)[-1:]
    return params, call


@pytest.mark.parametrize("hidden", [32, 64, 128])
def test_split_kernel_no_active_lane(hidden):
    """A bucket with no active lane: a ray per warp writes the entry state
    back (resolve step = the entry step), as the plain version does, bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params, (origin, dirs, state, cfg, frame, kw) = _terminal_call(hidden)
    idle = state._replace(active=torch.zeros_like(state.active))
    (out, lane_steps), _ = chip_smoke.split_equal(params, (origin, dirs, idle, cfg, frame, kw))
    assert torch.equal(out.t, idle.t) and torch.equal(out.budget, idle.budget)
    assert not bool(out.active.any())
    assert bool((lane_steps == int(idle.steps)).all())


@pytest.mark.parametrize("hidden", [32, 64, 128])
def test_thread_kernel_no_active_lane(hidden):
    """A bucket with no active lane a ray per thread: the entry state back,
    the plain version's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params, (origin, dirs, state, cfg, frame, kw) = _terminal_call(hidden)
    idle = state._replace(active=torch.zeros_like(state.active))
    (out, lane_steps), (p, p_steps) = _thread_call(params, (origin, dirs, idle, cfg, frame, kw))
    assert torch.equal(out.t, idle.t) and torch.equal(out.budget, idle.budget)
    assert torch.equal(out.t, p.t) and torch.equal(out.budget, p.budget)
    assert not bool(out.active.any()) and torch.equal(out.converged, idle.converged)
    assert bool((lane_steps == int(idle.steps)).all()) and torch.equal(lane_steps, p_steps)


@pytest.mark.parametrize("hidden", [32, 64, 128])
@pytest.mark.parametrize("n", [1, 17, 1000, 4095])
def test_split_kernel_ragged_n(hidden, n):
    """Lane counts that are not a multiple of a block's 16 rays (at 128 of
    a cluster's 8): the terminal call's first n lanes (sorted, the actives
    first)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params, (origin, dirs, state, cfg, frame, kw) = _terminal_call(hidden)
    order = torch.argsort((~state.active).to(torch.int8), stable=True)[:n]
    part = state._replace(**{f: getattr(state, f)[order]
                             for f in ("t", "budget", "active", "converged")})
    assert bool(part.active[0])
    chip_smoke.split_equal(params, (origin, dirs[order].contiguous(), part, cfg, frame, kw))


@pytest.mark.parametrize("hidden", [32, 64, 128])
@pytest.mark.parametrize("n", [1, 17, 63, 127, 129, 1000, 4095])
@pytest.mark.parametrize("num_steps", [None, 16, 24])
def test_thread_kernel_ragged_n(hidden, n, num_steps):
    """Lane counts that end inside a warp or a 128-wide group (and n = 1) a
    ray per thread: the terminal call's first n lanes (sorted, the actives
    first), run to dry and as the bounded rungs of 16 and 24 steps, replayed
    by the plain march with the kernel's own chain bit for bit, that chain
    within K1_MMA_SDF_ATOL of the plain one on the way, and the replay of
    the lanes beyond the tensor-core bar (chip_smoke.replay_beyond) landing
    on the kernel's results. The lanes stop at different steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params, (origin, dirs, state, cfg, frame, kw) = _terminal_call(hidden)
    kw = dict(kw, num_steps=num_steps)
    order = torch.argsort((~state.active).to(torch.int8), stable=True)[:n]
    part = state._replace(**{f: getattr(state, f)[order]
                             for f in ("t", "budget", "active", "converged")})
    assert bool(part.active[0])
    call = (origin, dirs[order].contiguous(), part, cfg, frame, kw)
    k, p = _thread_call(params, call)
    _replay_equal(params, call, k)
    beyond = chip_smoke.replay_beyond(params, call, k, p)
    assert beyond["replay_equal"] and beyond["chain_max_diff"] <= chip_smoke.K1_MMA_SDF_ATOL


@pytest.mark.parametrize("hidden", [32, 64, 128])
def test_split_kernel_launch_counted(hidden):
    """A launch that ray_lanes sends to the ray-split mode counts once in
    total, under its width and under SPLIT_LAUNCHES; ``_ray_lanes=1`` does
    not count there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cudaneuralrender_torch.kernels import megakernel

    params, (origin, dirs, state, cfg, frame, kw) = _terminal_call(hidden)
    assert megakernel.ray_lanes(hidden, "highest", kw.get("num_steps")) == 32
    before = (megakernel.KERNEL_LAUNCHES, megakernel.WIDTH_LAUNCHES[hidden],
              megakernel.SPLIT_LAUNCHES[hidden])
    megakernel.march_state(params, origin, dirs, state, cfg, frame, **kw)
    megakernel.march_state(params, origin, dirs, state, cfg, frame, _ray_lanes=1, **kw)
    torch.cuda.synchronize()
    after = (megakernel.KERNEL_LAUNCHES, megakernel.WIDTH_LAUNCHES[hidden],
             megakernel.SPLIT_LAUNCHES[hidden])
    assert tuple(a - b for a, b in zip(after, before)) == (2, 2, 1)


# The 128-wide ray-split mode on terminal-rung bundles in which lanes stop
# at max_steps: the terminal call of a scene at 64x64, its config's
# max_steps cut to MAX_STEPS_PAST steps past the call's start, so the
# deepest lanes end there still active. label -> (scene, frame, cyl_window).
MAX_STEPS_CASES = {"neural_raw": ("neural_raw", 0.0, 3),
                   "many_sphere": ("many_sphere", 90.0, 3),
                   "many_cylinder_cut_w5": ("many_cylinder_cut", 0.0, 5)}
MAX_STEPS_PAST = 24


@pytest.mark.parametrize("label", list(MAX_STEPS_CASES))
def test_split_cluster_kernel_stops_at_max_steps(label):
    """A ray per warp at 128 equals the plain version bit for bit (t,
    budget, the flags, the lane steps, the step counter) on a terminal-rung
    bundle whose deepest lanes stop at max_steps, and marches none past it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.ops import camera as camera_lib

    scene, frame, window = MAX_STEPS_CASES[label]
    dev = torch.device("cuda", 0)
    params = _split_params(NPZ, 128, dev)
    cfg = cnr.RenderConfig(width=64, height=64, scene=scene, cyl_window=window)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**chip_smoke.CAMERA), dev)
    origin, dirs = camera_lib.generate_rays(c2w, 64, 64, cfg.focal)
    (_, (origin, dirs, state, cfg, frame, kw), _), = chip_smoke.variant_calls(
        params, cfg, origin, dirs, frame)[-1:]
    assert kw["num_steps"] is None
    limit = int(state.steps) + MAX_STEPS_PAST
    cut = cfg.replace(max_steps=limit)
    (out, lane_steps), _ = chip_smoke.split_equal(params, (origin, dirs, state, cut, frame, kw))
    torch.cuda.synchronize()
    stopped = out.active & (lane_steps == limit)
    assert bool(stopped.any()) and int(lane_steps.max()) == limit == int(out.steps)


def test_split_cluster_smem_by_depth():
    """The 128-wide split mode's shared memory a CTA: within the card's
    227 KB up to SPLIT_MAX_LAYERS (13) layers, beyond it at 14, as
    ``ray_lanes`` assumes; 9 layers under 150 KB."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cudaneuralrender_torch.kernels import build, megakernel

    lib = build.load_library()
    top = megakernel.SPLIT_MAX_LAYERS[128]
    limit = 227 * 1024  # a block's shared memory on the H100
    assert lib.cnr_smem_bytes(3, 128, top) <= limit < lib.cnr_smem_bytes(3, 128, top + 1)
    assert lib.cnr_smem_bytes(3, 128, 9) < 150 * 1024
    assert lib.cnr_smem_bytes(3, 256, 9) == -1


# Training (cudaneuralrender_torch/diff) on the card: noisy csg_demo at
# 256x256, the staged mixed config, the solve on the march kernel.
TRAIN_SIDE = 256


def _train_setup():
    """(cnr, diff, train, noisy start on the card, config, target)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch import diff
    from cudaneuralrender_torch.diff import train

    dev = torch.device("cuda", 0)
    params = cnr.load(NPZ, device=dev)
    cfg = cnr.RenderConfig(width=TRAIN_SIDE, height=TRAIN_SIDE, march_impl="staged")
    target = chip_smoke._train_target(cnr, params, cfg)
    gen = torch.Generator().manual_seed(chip_smoke.TRAIN_SEED)
    start = cnr.MLP([(l.w + 0.01 * torch.randn(l.w.shape, generator=gen).to(dev),
                      l.b + 0.01 * torch.randn(l.b.shape, generator=gen).to(dev))
                     for l in params])
    return cnr, diff, train, start, cfg, target


def test_pixel_grad_card_matches_cpu():
    """One ``pixel_loss`` gradient (the compact bucket) on the card and on
    the CPU from the same solve: |d| <= TRAIN_GRAD_RTOL |g_cpu|."""
    cnr, diff, train, start, cfg, target = _train_setup()
    from cudaneuralrender_torch.ops import compaction

    cam = cnr.Camera(rotation_y=20.0)
    params = train._trainable(start)
    with torch.no_grad():
        t_star, hit = diff.solve_surface(params, cam, cfg)
    cap = compaction.capacity_pow2_of(int(hit.sum()), cfg.num_rays, minimum=cfg.compact_min)
    grads = {}
    for dev, p in (("cuda", params),
                   ("cpu", train._trainable(cnr.from_numpy_params(
                       cnr.mlp.to_numpy_params(params), device="cpu")))):
        loss = diff.pixel_loss(p, cam, cfg, target.to(dev), t_star=t_star.to(dev),
                               hit=hit.to(dev), compact_cap=cap)
        grads[dev] = [g.cpu() for g in train._grads(loss, p)]
    delta = torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(grads["cuda"], grads["cpu"])))
    norm = torch.sqrt(sum((b ** 2).sum() for b in grads["cpu"]))
    assert 0 < norm and delta <= chip_smoke.TRAIN_GRAD_RTOL * norm


def test_train_steps_on_card():
    """3 steps of ``pixel_train_step_fast``, one stats dict shared: the
    pipelined steps on the fast path through the packed grad step, the
    march kernel launched by the solve; ``train_loop_fast`` over the same
    cameras equals them (chip_smoke.TRAIN_LOOP_RTOL)."""
    cnr, diff, train, start, cfg, target = _train_setup()
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.render import schedule

    assert schedule.conv_within(cfg) is not None
    cams = [cnr.Camera(rotation_y=20.0 + 2 * i) for i in range(3)]
    s0 = train.init_train_state(start, chip_smoke.TRAIN_LR)
    state, stats, losses, packed = s0, {}, [], []
    real = train._pixel_grad_step_packed
    train._pixel_grad_step_packed = lambda *a: packed.append(a[8]) or real(*a)
    before = megakernel.KERNEL_LAUNCHES
    try:
        for cam in cams:
            state, loss = train.pixel_train_step_fast(state, cam, target, cfg,
                                                      chip_smoke.TRAIN_LR, stats_out=stats)
            losses.append(float(loss))
    finally:
        train._pixel_grad_step_packed = real
    assert megakernel.KERNEL_LAUNCHES > before
    assert stats["fast_path"] and len(packed) >= 2 and packed[-1] >= stats["hits"]
    assert np.isfinite(losses).all()
    loop, loop_losses = train.train_loop_fast(s0, cams, target, cfg, chip_smoke.TRAIN_LR)
    chip_smoke._leaves_close([torch.tensor(loop_losses)], [torch.tensor(losses)],
                             chip_smoke.TRAIN_LOOP_RTOL, 0.0)
    chip_smoke._leaves_close(train._state_leaves(loop), train._state_leaves(state),
                             chip_smoke.TRAIN_LOOP_RTOL, chip_smoke.TRAIN_LOOP_ATOL)


def test_solve_follows_training_step_on_card():
    """After a step the solve marches the new weights: equal, bit for bit,
    to a solve of the same weights loaded fresh."""
    cnr, diff, train, start, cfg, target = _train_setup()
    cam = cnr.Camera(rotation_y=20.0)
    state = train.init_train_state(start, 1e-2)
    diff.solve_surface(state.params, cam, cfg)
    state, _ = train.pixel_train_step_fast(state, cam, target, cfg, 1e-2)
    a = diff.solve_surface(state.params, cam, cfg)
    b = diff.solve_surface(cnr.from_numpy_params(cnr.mlp.to_numpy_params(state.params),
                                                 device=state.params.device), cam, cfg)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_adam_card_matches_torch_optim():
    """The out-of-place Adam on the card against ``torch.optim.Adam`` with
    ``capturable=True``, which forms its bias corrections in float32 on
    the device as optax does: 5 steps, params and moments within rtol 1e-6,
    atol 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.diff import train

    dev = torch.device("cuda", 0)
    params = train._trainable(cnr.init_mlp(torch.Generator().manual_seed(3), (3, 16, 16, 1),
                                           device=dev))
    gen = torch.Generator().manual_seed(5)
    grads = [[torch.randn(t.shape, generator=gen).to(dev) * 10.0 ** -k
              for t in train._flat(params)] for k in range(5)]
    ref = [torch.nn.Parameter(t.detach().clone()) for t in train._flat(params)]
    ref_opt = torch.optim.Adam(ref, lr=1e-3, capturable=True)
    opt = train.make_optimizer(1e-3)
    state = opt.init(params)
    for g in grads:
        params, state = opt.update(g, state, params)
        for q, x in zip(ref, g):
            q.grad = x.clone()
        ref_opt.step()
    got = [train._flat(params), train._flat(state.mu), train._flat(state.nu)]
    want = [ref, [ref_opt.state[q]["exp_avg"] for q in ref],
            [ref_opt.state[q]["exp_avg_sq"] for q in ref]]
    for got_l, want_l in zip(got, want):
        for a, b in zip(got_l, want_l):
            torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-6, atol=1e-9)


def test_sdf_fit_on_card():
    """``sdf_train_step`` with the eikonal term at batch 8192 on the card:
    the gradient equals the CPU's (|d| <= TRAIN_GRAD_RTOL |g|), and 20
    steps reduce the loss."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.diff import losses, train
    from cudaneuralrender_torch.examples.train_sdf import sample

    dev = torch.device("cuda", 0)
    net = cnr.init_mlp(torch.Generator().manual_seed(0), device=dev)
    pts, d = sample(torch.Generator(device=dev).manual_seed(0), chip_smoke.SDF_FIT_BATCH)
    grads = {}
    for where, p in (("cuda", train._trainable(net)),
                     ("cpu", train._trainable(cnr.from_numpy_params(
                         cnr.mlp.to_numpy_params(net), device="cpu")))):
        x, y = pts.to(where), d.to(where)
        loss = (losses.sdf_distillation_loss(p, x, y)
                + chip_smoke.SDF_FIT_EIKONAL * losses.eikonal_loss(p, x))
        grads[where] = [g.cpu() for g in torch.autograd.grad(loss, train._flat(p))]
    delta = torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(grads["cuda"], grads["cpu"])))
    norm = torch.sqrt(sum((b ** 2).sum() for b in grads["cpu"]))
    assert delta <= chip_smoke.TRAIN_GRAD_RTOL * norm
    _, history = train.fit_sdf(net, sample, steps=20, batch=chip_smoke.SDF_FIT_BATCH, lr=2e-3)
    assert np.isfinite(history).all() and min(history[1:]) < history[0]


# The render package on the card: a staged frame that never waits for the
# host, fused chunks as CUDA graphs, the frame number read from device
# memory, warm starts.
SEQ_SIDE = 128


def _seq_setup(scene="many_sphere", n=6):
    import cudaneuralrender_torch as cnr

    dev = torch.device("cuda", 0)
    params = cnr.load(NPZ, device=dev)
    cfg = cnr.RenderConfig(width=SEQ_SIDE, height=SEQ_SIDE, march_impl="staged", scene=scene)
    cams = [cnr.Camera(rotation_x=chip_smoke.CAMERA["rotation_x"],
                       rotation_y=chip_smoke.CAMERA["rotation_y"] + i) for i in range(n)]
    return cnr, params, cfg, cams, [float(9 * i) for i in range(n)]


def test_staged_frame_makes_no_host_sync():
    """From ray build to stats a staged frame makes no synchronising CUDA
    call (torch.cuda.set_sync_debug_mode("error") raises on one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cudaneuralrender_torch.render import renderer

    cnr, params, cfg, cams, frames = _seq_setup()
    renderer._render_scheduled(params, cams[0], cfg, None, frames[1])  # constants, library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for cam, fr in zip(cams[:2], frames[:2]):
            renderer._render_scheduled(params, cam, cfg, None, fr)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_chunked_sequence_equals_per_frame_on_card():
    """``render_sequence(chunk=4)`` over 6 frames of many_sphere whose frame
    numbers vary (the tail chunk padded): images and stats equal
    ``chunk=1`` bit for bit, twice, from one capture (2 chunks a call, 4
    replays)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cudaneuralrender_torch.render import renderer, schedule

    cnr, params, cfg, cams, frames = _seq_setup()
    renderer.reset_graphs()
    cnr.reset_schedule_memo()
    cnr.render_sequence(params, cams, cfg, frames=frames)  # teaches the memo its caps
    assert not renderer.frame_reads_host(schedule.memo_lookup(params, cfg))
    ref_stats = []
    ref = cnr.render_sequence(params, cams, cfg, frames=frames, stats_out=ref_stats)
    before = renderer.graph_stats()
    for _ in range(2):
        stats = []
        out = cnr.render_sequence(params, cams, cfg, frames=frames, stats_out=stats, chunk=4)
        assert stats == ref_stats
        assert len(out) == len(ref) and all(torch.equal(a, b) for a, b in zip(out, ref))
    after = renderer.graph_stats()
    assert after["captures"] - before["captures"] == 1
    assert after["replays"] - before["replays"] == 4
    nodes = after["graphs"][0]["march_nodes"]  # the same calls in each of the 4 frames
    assert nodes > 0 and nodes % 4 == 0
    renderer.reset_graphs()
    cnr.reset_schedule_memo()


@pytest.mark.parametrize("frame", [0.0, 90.0])
def test_frame_from_device_kernel_matches_plain(frame):
    """The march kernel reads the frame from device memory: at two frames of
    many_sphere, a [] tensor frame gives the float frame's results bit for
    bit, and the kernel meets its plain version's bar on the staged
    renderer's three kinds of call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import camera as camera_lib
    from cudaneuralrender_torch.ops import march

    dev = torch.device("cuda", 0)
    params = cnr.load(NPZ, device=dev)
    cfg = cnr.RenderConfig(width=64, height=64, scene="many_sphere", **chip_smoke.COARSE_FP32)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**chip_smoke.CAMERA), dev)
    origin, dirs = camera_lib.generate_rays(c2w, 64, 64, cfg.focal)
    state = march.init_state(origin, dirs, cfg.bound_center, cfg.bound_radius)
    frame_t = torch.full((), frame, dtype=torch.float32, device=dev)
    a = megakernel.march_state(params, origin, dirs, state, cfg, frame, coarse=True,
                               march_eps=cfg.coarse_eps, return_resolve=True)
    b = megakernel.march_state(params, origin, dirs, state, cfg, frame_t, coarse=True,
                               march_eps=cfg.coarse_eps, return_resolve=True)
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    assert torch.equal(a[1], b[1])
    result = chip_smoke.compare_kernel_with_plain(params, cfg, origin, dirs, frame_t)
    chip_smoke.check_agreement(result)


def test_warm_frame_calls_match_plain():
    """A warm sequence of 3 frames (the third extrapolated): frame 0 equal
    to the cold frame 0, later frames at chip_smoke's warm bars, and every
    march call of the third frame against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cnr, params, cfg, cams, frames = _seq_setup("neural_raw", 3)
    cnr.reset_schedule_memo()
    cold = cnr.render_sequence(params, cams, cfg, frames=frames)
    cold = cnr.render_sequence(params, cams, cfg, frames=frames)
    calls = chip_smoke.record_calls(lambda: cnr.render_sequence(
        params, cams, cfg, frames=frames, warm_start=True))
    warm = cnr.render_sequence(params, cams, cfg, frames=frames, warm_start=True)
    assert torch.equal(warm[0], cold[0])
    for c, w in zip(cold[1:], warm[1:]):
        assert ((c[..., 3] > 0) == (w[..., 3] > 0)).float().mean() >= chip_smoke.WARM_MIN_HIT_AGREE
        assert (c == w).all(dim=-1).float().mean() >= chip_smoke.WARM_MIN_EQUAL
    groups = chip_smoke._frame_groups(calls)
    assert len(groups) == 3
    chip_smoke.check_agreement(chip_smoke.compare_recorded_calls(params, groups[-1]))
    cnr.reset_schedule_memo()


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_staged_frame_on_card(n_shards):
    """A 256x256 staged frame over logical shards of the card
    (parallel/sharding.py), after one frame that teaches the memo, against
    the single-device frame: the fast path, every shard's
    march on the kernel, the image equal bit for bit (chip_smoke's phase 14
    bar: the shards' rungs march each ray as the frame's do), and shard 0's
    march calls against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.parallel import mesh as mesh_lib
    from cudaneuralrender_torch.parallel import sharding

    dev = torch.device("cuda", 0)
    params = cnr.load(NPZ, device=dev)
    cfg = cnr.RenderConfig(width=256, height=256, march_impl="staged")
    cam = cnr.Camera(**chip_smoke.CAMERA)
    cnr.reset_schedule_memo()
    ref = cnr.render_staged(params, cam, cfg)
    cnr.reset_schedule_memo()
    mesh = mesh_lib.make_mesh((n_shards,), ("data",), [dev] * n_shards)
    # The first frame teaches the memo what an overflowing rung needs (the
    # persistent store may be off); the second runs on the fast path.
    sharding.render_image_sharded_staged(params, cam, cfg, mesh)
    before = megakernel.KERNEL_LAUNCHES
    stats = {}
    img = sharding.render_image_sharded_staged(params, cam, cfg, mesh, stats_out=stats)
    torch.cuda.synchronize()
    assert megakernel.KERNEL_LAUNCHES - before >= n_shards
    assert stats["fast_path"] and len(stats["shard_near"]) == n_shards
    assert torch.equal(img, ref)
    groups = chip_smoke._frame_groups(chip_smoke.record_calls(
        lambda: sharding.render_image_sharded_staged(params, cam, cfg, mesh)))
    assert len(groups) == n_shards
    chip_smoke.check_agreement(chip_smoke.compare_recorded_calls(params, groups[0]))
    cnr.reset_schedule_memo()


def test_sharded_train_step_on_card():
    """solve_surface_sharded feeding pixel_train_step_sharded on 4 logical
    shards of the card (64x64, csg_demo with phase 12's noise) against the
    unsharded step on the same solve: loss within rtol 1e-5, the gradient
    (the first Adam moments, a tenth of it) within chip_smoke.TRAIN_GRAD_RTOL
    of its norm; the sharded solve equal to diff.solve_surface's hit mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch import diff
    from cudaneuralrender_torch.diff import train
    from cudaneuralrender_torch.parallel import mesh as mesh_lib
    from cudaneuralrender_torch.parallel import sharding

    dev = torch.device("cuda", 0)
    params = cnr.load(NPZ, device=dev)
    cfg = cnr.RenderConfig(width=64, height=64, march_impl="staged")
    target = chip_smoke._train_target(cnr, params, cfg)
    gen = torch.Generator().manual_seed(chip_smoke.TRAIN_SEED)
    start = cnr.MLP([(l.w + chip_smoke.TRAIN_NOISE * torch.randn(l.w.shape, generator=gen).to(dev),
                      l.b + chip_smoke.TRAIN_NOISE * torch.randn(l.b.shape, generator=gen).to(dev))
                     for l in params])
    s0 = train.init_train_state(start, chip_smoke.TRAIN_LR)
    cam = cnr.Camera(rotation_y=20.0)
    mesh = mesh_lib.make_mesh((4,), ("data",), [dev] * 4)
    t_star, hit = sharding.solve_surface_sharded(s0.params, cam, cfg, mesh)
    _, hit1 = diff.solve_surface(s0.params, cam, cfg)
    assert (hit == hit1).float().mean() >= 0.99
    state, loss = sharding.pixel_train_step_sharded(s0, cam, target, cfg, mesh,
                                                    chip_smoke.TRAIN_LR, t_star=t_star, hit=hit)
    ref, ref_loss = train._pixel_grad_step_from_t(s0, cam, target, t_star, hit, cfg,
                                                  chip_smoke.TRAIN_LR)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    mu = torch.cat([m.reshape(-1) for m in train._flat(state.opt_state.mu)])
    mu_ref = torch.cat([m.reshape(-1) for m in train._flat(ref.opt_state.mu)])
    assert float((mu - mu_ref).norm()) <= chip_smoke.TRAIN_GRAD_RTOL * float(mu_ref.norm())


def test_zero_bias_net_step_on_card():
    """``mlp.relu_tie`` on the card: gradient 1/2 at an exact tie (and its
    double backward, as differentiable shading takes it), then the dry
    run's zero-bias net (``init_mlp``, seed 3) at Camera() and 16x8, whose
    pixel (4, 8) meets the surface at the origin: the 4-shard train step on
    the CPU's dense solve, its loss finite and within rtol 1e-5 of the same
    step on the CPU, its
    gradient (the first Adam moments) within chip_smoke.TRAIN_GRAD_RTOL of
    the CPU's norm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.diff import implicit, train
    from cudaneuralrender_torch.models import mlp
    from cudaneuralrender_torch.parallel import mesh as mesh_lib
    from cudaneuralrender_torch.parallel import sharding

    dev = torch.device("cuda", 0)
    h = torch.tensor([-1.0, 0.0, 2.0], device=dev, requires_grad=True)
    w = torch.tensor(3.0, device=dev, requires_grad=True)
    (g,) = torch.autograd.grad(mlp.relu_tie(h * w).sum(), h, create_graph=True)
    assert g.tolist() == [0.0, 1.5, 3.0]
    (gw,) = torch.autograd.grad(g.sum(), w)  # d/dw of w * step(h w): the step's sum
    assert float(gw) == 1.5
    cfg = cnr.RenderConfig(width=16, height=8, scene="neural_raw", max_steps=16)
    net = mlp.init_mlp(torch.Generator().manual_seed(3), device="cpu")
    origin, dirs, _ = implicit._rays(net, cnr.Camera(), cfg)
    t_star, hit = implicit._solve_t_dense(net, cfg, 0.0, origin, dirs)
    out = {}
    for d in ("cpu", dev):
        mesh = mesh_lib.make_mesh((4,), ("data",), [torch.device(d)] * 4)
        s0 = train.init_train_state(mlp.MLP([(l.w.to(d), l.b.to(d)) for l in net]))
        state, loss = sharding.pixel_train_step_sharded(
            s0, cnr.Camera(), torch.zeros((8, 16, 4), device=d), cfg, mesh,
            t_star=t_star.to(d), hit=hit.to(d))
        out[str(d)] = (float(loss), torch.cat([m.reshape(-1).cpu()
                                               for m in train._flat(state.opt_state.mu)]))
    (cpu_loss, cpu_mu), (card_loss, card_mu) = out["cpu"], out[str(dev)]
    assert np.isfinite(card_loss)
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-5)
    assert float((card_mu - cpu_mu).norm()) <= chip_smoke.TRAIN_GRAD_RTOL * float(cpu_mu.norm())


@pytest.mark.parametrize("n,offset", [(0, 0), (3, 0), (4099, 0), (1 << 20, 0), (4099, 1),
                                      (1 << 20, 3)])
def test_relu_tie_backward_matches_plain(n, offset):
    """``relu_tie_backward`` (csrc/elementwise.cu) against its plain version
    bit for bit: seeded values with exact ties of both signs, NaN and inf,
    lengths with a ragged tail, and views that start off a 16-byte boundary
    (the kernel's scalar path); each launch counted; wrong types and
    non-contiguous tensors refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cudaneuralrender_torch.kernels import elementwise

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(n + offset)
    h = rng.standard_normal(n + offset).astype(np.float32)
    h[::5] = 0.0
    h[1::7] = -0.0
    h[2::11] = np.nan
    g = rng.standard_normal(n + offset).astype(np.float32)
    g[3::13] = np.inf
    g_t = torch.from_numpy(g).to(dev)[offset:]
    h_t = torch.from_numpy(h).to(dev)[offset:]
    before = elementwise.RELU_TIE_LAUNCHES
    got = elementwise.relu_tie_backward(g_t, h_t)
    torch.cuda.synchronize()
    assert elementwise.RELU_TIE_LAUNCHES == before + (n > 0)  # nothing to launch at 0
    want = elementwise.relu_tie_backward_plain(g_t, h_t)
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan], want[~nan])
    assert torch.equal(got[~nan].signbit(), want[~nan].signbit())
    with pytest.raises(ValueError):
        elementwise.relu_tie_backward(g_t.double(), h_t.double())
    if n > 8:
        with pytest.raises(ValueError):
            elementwise.relu_tie_backward(g_t[::2], h_t[::2])


def test_relu_tie_backward_in_a_cuda_graph():
    """The kernel launches on PyTorch's current stream, so a CUDA graph
    captures it: a replay on new inputs equals the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cudaneuralrender_torch.kernels import elementwise

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(5)
    g = torch.randn(65536, 32, generator=gen).to(dev)
    h = torch.randn(65536, 32, generator=gen).round().to(dev)  # many exact ties
    stream = torch.cuda.Stream(device=dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        elementwise.relu_tie_backward(g, h)
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = elementwise.relu_tie_backward(g, h)
    g.copy_(torch.randn(65536, 32, generator=gen).to(dev))
    h.copy_(torch.randn(65536, 32, generator=gen).round().to(dev))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, elementwise.relu_tie_backward_plain(g, h))


def test_zero_bias_tie_pixel_on_card():
    """A render's normals take JAX's tie gradient on the card: the zero-bias
    net (``init_mlp``, seed 3) at Camera() and 16x8, whose pixel (4, 8)
    meets the surface at the origin; the card's ``render_staged`` is finite
    there, its normals launched the value-and-gradient kernel (which keeps
    the tie's factor 1/2, csrc/value_grad.cu), and it is within 1e-4 of the
    CPU's frame."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import fused_mlp
    from cudaneuralrender_torch.models import mlp

    net = mlp.init_mlp(torch.Generator().manual_seed(3), device="cpu")
    cfg = cnr.RenderConfig(width=16, height=8, scene="neural_raw", march_impl="staged",
                           rgba_packed=False)
    want = cnr.render_staged(net, cnr.Camera(), cfg).numpy()
    card = mlp.MLP([(l.w.cuda(), l.b.cuda()) for l in net])
    cnr.reset_schedule_memo()
    before = fused_mlp.MLP_VALUE_GRAD_LAUNCHES
    got = cnr.render_staged(card, cnr.Camera(), cfg).cpu().numpy()
    assert fused_mlp.MLP_VALUE_GRAD_LAUNCHES > before
    assert np.isfinite(got).all() and got[4, 8, 3] == 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# The value-and-gradient kernel (csrc/value_grad.cu): each width it serves
# (csg_demo widened), the 4-input anim_demo and the zero-bias net.
VG_NETS = {"w32": (32, None), "w64": (64, None), "w128": (128, None),
           "anim_demo": (32, 37.0), "zero_bias": (32, 0.0)}


@pytest.fixture(scope="module")
def shade_region():
    """The points a 1080p csg_demo frame's normals hand the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr

    params = cnr.load(NPZ, device=torch.device("cuda", 0))
    cfg = cnr.RenderConfig(width=1920, height=1080, march_impl="staged")
    return chip_smoke.shade_region(cnr, params, chip_smoke.CAMERA, cfg)


@pytest.mark.parametrize("net", list(VG_NETS))
def test_value_grad_kernel_matches_plain(shade_region, net):
    """The kernel against its plain version (the chain under autograd) at a
    1080p csg_demo frame's shade region, at chip_smoke's VG_ bar: the value
    within 1e-5 of (|plain| + 1); the gradient within 1e-5 of its norm on
    >= 99.99% of the points and within 1e-3 on all but those at a ReLU's
    kink (float64), at most 1e-4 of them; the zero-bias net at the origin,
    where every pre-activation is a tie (factor 1/2); the launch counted."""
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import fused_mlp
    from cudaneuralrender_torch.models import mlp

    hidden, frame = VG_NETS[net]
    dev = shade_region.device
    pts, n_in = shade_region, 3
    if net == "anim_demo":
        params, n_in = cnr.load(os.path.join(ASSETS, "anim_demo.npz"), device=dev), 4
    elif net == "zero_bias":
        params = mlp.init_mlp(torch.Generator().manual_seed(3), device=dev)
        pts = torch.zeros(4096, 3, device=dev)
    else:
        params = chip_smoke.wide_params(cnr, hidden // 32, dev)
    before = fused_mlp.MLP_VALUE_GRAD_LAUNCHES
    r = chip_smoke.value_grad_agreement(params, pts, frame or 0.0, n_in)
    print(net, r)
    assert fused_mlp.MLP_VALUE_GRAD_LAUNCHES == before + 1
    assert not chip_smoke.value_grad_faults(r)


@pytest.mark.parametrize("n", [1, 31, 33, 4099])
def test_value_grad_kernel_ragged_n(n):
    """Point counts that end inside a warp, and shallow nets (1 and 2
    layers), against the plain version at the same bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(n)
    pts = (torch.rand(n, 3, generator=gen) * 2 - 1).to(dev)
    for sizes in ((3, 32, 32, 32, 1), (3, 32, 1), (3, 1)):
        net = cnr.init_mlp(torch.Generator().manual_seed(1), sizes=sizes, device=dev)
        with torch.no_grad():
            for layer in net:
                layer.b.copy_(torch.randn(layer.b.shape, generator=gen).to(dev) * 0.1)
        r = chip_smoke.value_grad_agreement(net, pts)
        assert not chip_smoke.value_grad_faults(r), (sizes, r)


def test_value_grad_kernel_on_main_path():
    """A staged 1080p frame's normals launch the kernel once (the autograd
    chain's ``relu_tie_backward`` not at all), and ``trace``'s counter
    under the shade span reads the shaded region's lanes through it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import elementwise, fused_mlp
    from cudaneuralrender_torch.utils import trace

    params = cnr.load(NPZ, device=torch.device("cuda", 0))
    cfg = cnr.RenderConfig(width=1920, height=1080, march_impl="staged")
    rnd = cnr.Renderer(params, cfg)
    cam = cnr.Camera(**chip_smoke.CAMERA)
    rnd.render(cam)
    vg, tie = fused_mlp.MLP_VALUE_GRAD_LAUNCHES, elementwise.RELU_TIE_LAUNCHES
    lanes, real = [], fused_mlp.mlp_value_grad

    def recording(weights, biases, pts, *args):
        lanes.append(pts.shape[0])
        return real(weights, biases, pts, *args)

    trace.enable()
    fused_mlp.mlp_value_grad = recording
    try:
        trace.reset()
        rnd.render(cam)
        counters = trace.snapshot()["counters"]
    finally:
        fused_mlp.mlp_value_grad = real
        trace.disable()
    assert fused_mlp.MLP_VALUE_GRAD_LAUNCHES == vg + 1
    assert elementwise.RELU_TIE_LAUNCHES == tie
    # the shaded region: the first refine bucket, shaded in place
    assert len(lanes) == 1 and lanes[0] <= cfg.num_rays
    shade = {k.split("frame/shade/")[-1]: v for k, v in counters.items() if "frame/shade/" in k}
    assert shade == {"normals.kernel_lanes": lanes[0], "normals.autograd_lanes": 0}


def test_value_grad_chunked_sequence_matches_autograd():
    """``render_sequence(chunk=8)`` over 8 frames through a CUDA graph with
    the normals on the kernel, against the same frames with the normals on
    the autograd chain: images equal on >= 99.9% of pixels, the kernel
    launched in the capture and replayed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.benchmarks import relu_ties
    from cudaneuralrender_torch.kernels import fused_mlp
    from cudaneuralrender_torch.render import renderer

    params = cnr.load(NPZ, device=torch.device("cuda", 0))
    cfg = cnr.RenderConfig(width=640, height=360, march_impl="staged")
    cams = [cnr.Camera(rotation_x=chip_smoke.CAMERA["rotation_x"],
                       rotation_y=chip_smoke.CAMERA["rotation_y"] + 3 * i) for i in range(8)]
    renderer.reset_graphs()
    cnr.reset_schedule_memo()
    cnr.render_sequence(params, cams, cfg)  # teaches the memo its caps
    before = renderer.graph_stats()
    launches = fused_mlp.MLP_VALUE_GRAD_LAUNCHES
    got = cnr.render_sequence(params, cams, cfg, chunk=8)
    got = cnr.render_sequence(params, cams, cfg, chunk=8)
    after = renderer.graph_stats()
    assert after["captures"] - before["captures"] == 1
    assert after["replays"] - before["replays"] == 2
    assert fused_mlp.MLP_VALUE_GRAD_LAUNCHES > launches  # in the capture's first frame
    with relu_ties.on_autograd():
        want = cnr.render_sequence(params, cams, cfg)
    renderer.reset_graphs()
    cnr.reset_schedule_memo()
    pixels, unequal = 0, 0
    for a, b in zip(got, want):
        differ = (torch.as_tensor(a) != torch.as_tensor(b)).reshape(cfg.num_rays, -1)
        pixels += cfg.num_rays
        unequal += int(differ.any(dim=-1).sum())
    assert len(got) == len(want) == len(cams)
    assert unequal <= 1e-3 * pixels, (unequal, pixels)


def test_value_grad_kernel_not_on_training_or_tetrahedron():
    """Differentiable normals (the training path) and tetrahedron normals
    launch no value-and-gradient kernel: the first differentiates the
    normals (parameters that need a gradient), the second takes no
    gradient; both run the plain chain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import fused_mlp
    from cudaneuralrender_torch.ops import shading
    from cudaneuralrender_torch.render import renderer

    dev = torch.device("cuda", 0)
    params = cnr.load(NPZ, device=dev)
    cfg = cnr.RenderConfig(width=64, height=64)
    gen = torch.Generator().manual_seed(2)
    pts = ((torch.rand(1000, 3, generator=gen) * 2 - 1) * 0.5).to(dev)
    dirs = torch.nn.functional.normalize(torch.randn(1000, 3, generator=gen), dim=1).to(dev)
    before = fused_mlp.MLP_VALUE_GRAD_LAUNCHES
    shading.shade(renderer.shade_fn(params, cfg, 0.0), pts, dirs, normal_mode="tetrahedron")
    params.requires_grad_(True)
    try:
        colors = shading.shade(renderer.shade_fn(params, cfg, 0.0), pts, dirs,
                               differentiable=True)
        colors.sum().backward()
    finally:
        params.requires_grad_(False)
    assert fused_mlp.MLP_VALUE_GRAD_LAUNCHES == before
    assert params[0].w.grad is not None and float(params[0].w.grad.abs().sum()) > 0
