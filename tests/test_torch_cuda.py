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
seeded points, at chip_smoke.K3_ATOL.
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
