"""The kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (they build csrc/*.cu) and skip
elsewhere. Run them on the card with:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

Rays at 64x64 from chip_smoke.CAMERA for the staged renderer's three kinds
of call, at the bar chip_smoke.py holds the kernel to (its constants):
csg_demo under neural_raw and under every scene the kernel composes
(chip_smoke.SCENES, the 4-input anim_demo under many_sphere included),
each scene's launches counted under its name; csg_demo widened to 64, 128
and 256 (chip_smoke.widen) under neural_raw, each width's launches counted.
The fused forward (K3) against its plain version at every width, on 65536
seeded points, at chip_smoke.K3_ATOL. The three-pass chain (K2h) inside the
march kernel at every width against its plain version, for the HIGH
phase's calls (chip_smoke.HIGH_VARIANTS), and its SDF bit for bit; the
cold-start kernel (K5) against its plain version at "default" and "high".
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


WIDE = {hidden: k for k, hidden, _, _ in chip_smoke.WIDE}


@pytest.fixture(scope="module", params=sorted(WIDE))
def wide_agreement(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import camera as camera_lib

    hidden = request.param
    dev = torch.device("cuda", 0)
    params = chip_smoke.wide_params(cnr, WIDE[hidden], dev)
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


@pytest.mark.parametrize("hidden", [32] + sorted(WIDE))
def test_forward_kernel_matches_plain(hidden):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import fused_mlp

    dev = torch.device("cuda", 0)
    params = chip_smoke.wide_params(cnr, WIDE.get(hidden, 1), dev)
    weights, biases, _, h = fused_mlp.packed_params(params)
    assert h == hidden
    pts = torch.as_tensor(np.random.default_rng(0).uniform(-1.2, 1.2, (65536, 3))
                          .astype(np.float32), device=dev)
    before = fused_mlp.MLP_LAUNCHES
    got = fused_mlp.mlp_forward(weights, biases, pts)
    torch.cuda.synchronize()
    assert fused_mlp.MLP_LAUNCHES == before + 1
    want = fused_mlp.mlp_forward_plain(weights, biases, pts)
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
    params = chip_smoke.wide_params(cnr, WIDE.get(hidden, 1), dev)
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
    """The kernel's three-pass SDF, read off one step, equals the plain
    chain's bit for bit on 4096 seeded points."""
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
    assert torch.equal(got, want), (got - want).abs().max().item()


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
    kw = dict(march_eps=cfg.coarse_eps, precision=precision, relax_omega=cfg.relax_omega,
              return_resolve=True, cyl_window=cfg.cyl_window_coarse)
    before = megakernel.RAYGEN_LAUNCHES
    k = megakernel.march_raygen(params, c2w, pos, cfg, **kw)
    torch.cuda.synchronize()
    assert megakernel.RAYGEN_LAUNCHES == before + 1
    p = megakernel.march_raygen_plain(params, c2w, pos, cfg, **kw)
    chip_smoke.check_agreement({"raygen": chip_smoke.agreement(k, p)})
    pad = pos < 0
    assert not k[0].active[pad].any() and not k[0].converged[pad].any()
