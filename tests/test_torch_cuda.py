"""The march kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU with nvcc (they build csrc/march.cu) and
skip elsewhere. Run them on the card with:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda

Rays at 64x64 from chip_smoke.CAMERA for the staged renderer's three kinds
of call, at the bar chip_smoke.py holds the kernel to (its constants):
csg_demo under neural_raw and under every scene the kernel composes
(chip_smoke.SCENES, the 4-input anim_demo under many_sphere included),
each scene's launches counted under its name.
"""
import os

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
