"""The ``hash_grid`` model kind (``portbench/models/hash_grid.py``) beside the
dense chain's (``test_portbench_models.py``): a configuration that names it
finds it, the program and the plain reference get the same SDF, and an
evaluation counts the MLP's and the interpolation's work.

Run from the repository root: ``python -m pytest portbench/tests -q``.
"""
import json
import os

import numpy as np
import pytest
import torch

from portbench import spec
from portbench.metrics.gather_roofline import L2_BYTES_PER_S
from portbench.models import hash_grid

ROOT = spec.ROOT


def test_the_hash_grid_kind():
    """``hashgrid_sdf`` names ``hash_grid``: the program gets a
    ``HashGridSDF`` whose plain SDF is the plain reference's bit for bit, the
    reference starts with TF32 off, and an evaluation counts the MLP's and
    the interpolation's 12,928 FLOPs and 1,024 bytes of gathers (at L2's
    rate, stated in HBM bytes)."""
    import cudaneuralrender_torch as cnr

    with open(os.path.join(ROOT, "portbench", "configs", "hashgrid_sdf.json")) as f:
        cfg = json.load(f)
    assert spec.model(cfg) is hash_grid
    arrays = hash_grid.make(cfg, ROOT, 2**31 + 9)
    program = hash_grid.program(cnr, arrays, "cpu")
    net = hash_grid.reference_net(arrays, "cpu")
    assert isinstance(program, cnr.HashGridSDF) and net.emulate_tf32 is False
    pts = torch.from_numpy(np.random.default_rng(4).uniform(-1.2, 1.2, (2048, 3)).astype(np.float32))
    assert torch.equal(program(pts), net(pts))
    assert hash_grid.flops_per_eval(cfg) == 12928  # 1024 B gathered at L2's rate, in HBM bytes:
    assert hash_grid.bytes_per_eval(cfg) == pytest.approx(1024 * 3.35e12 / L2_BYTES_PER_S)
