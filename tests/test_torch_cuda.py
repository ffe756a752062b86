"""The march kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU with nvcc (they build csrc/march.cu) and
skip elsewhere. Run them on the card with:

    python -m pytest tests/test_torch_cuda.py -m cuda

csg_demo rays at 64x64 for the staged renderer's three kinds of call, at
the bar chip_smoke.py holds the kernel to (its constants).
"""
import os

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda

NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "examples", "assets",
                   "csg_demo.npz")


@pytest.fixture(scope="module")
def agreement():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import cudaneuralrender_torch as cnr
    from cudaneuralrender_torch.kernels import megakernel
    from cudaneuralrender_torch.ops import camera as camera_lib

    dev = torch.device("cuda", 0)
    params = cnr.load(NPZ, device=dev)
    cfg = cnr.RenderConfig(width=64, height=64)
    c2w, _ = camera_lib.view_matrices(cnr.Camera(**chip_smoke.CAMERA), dev)
    origin, dirs = camera_lib.generate_rays(c2w, 64, 64, cfg.focal)
    before = megakernel.KERNEL_LAUNCHES
    result = chip_smoke.compare_kernel_with_plain(params, cfg, origin, dirs)
    torch.cuda.synchronize()
    return result, megakernel.KERNEL_LAUNCHES - before


@pytest.mark.parametrize("variant", [v[0] for v in chip_smoke.VARIANTS])
def test_kernel_matches_plain(agreement, variant):
    result, _ = agreement
    chip_smoke.check_agreement({variant: result[variant]})


def test_kernel_launch_counted(agreement):
    _, launches = agreement
    assert launches == len(chip_smoke.VARIANTS)
