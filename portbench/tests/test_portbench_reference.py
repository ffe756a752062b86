"""The yardstick on the CPU: the work count, the widening, the plain
reference against the frozen NumPy oracle, and the TF32 control (the
cells' reference nets through their model kinds, ``portbench/models/``).

Run from the repository root: ``python -m pytest portbench/tests -q``.
"""
import os

import numpy as np
import pytest
import torch

from portbench import check, spec, traffic, weights, work
from portbench.reference import oracle_np
from portbench.reference import render as ref

LAYERS = weights.load_npz(os.path.join(spec.ROOT, "examples/assets/csg_demo.npz"))
RENDER = dict(max_steps=6000, march_eps=1e-6, bound_radius=1.2, focal=2.0)


def reference_net(cell, seed, device):
    """The cell's reference net, through its configuration's model kind."""
    kind = spec.model(cell["config"])
    return kind.reference_net(kind.make(cell["config"], spec.ROOT, seed), device)


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_widen_keeps_the_sdf_to_float32_rounding(seed):
    wide = weights.widen(LAYERS, 4, seed)
    assert weights.layer_sizes(wide) == [3] + [128] * 8 + [1]
    pts = torch.from_numpy(np.random.default_rng(1).uniform(-1.2, 1.2, (4096, 3)).astype(np.float32))
    a = ref.Net(LAYERS, "cpu")(pts)
    b = ref.Net(wide, "cpu")(pts)
    exact = ref.Net([(w.astype(np.float64), b_.astype(np.float64)) for w, b_ in LAYERS], "cpu")
    scale = float(a.abs().max()) + 1.0
    assert float((a - b).abs().max()) <= 2e-6 * scale, float((a - b).abs().max())
    assert exact is not None


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12, -3.0 - 2**-10, 0.0])
    got = ref.round_tf32(x)
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0 - 2**-9, 0.0])
    assert torch.equal(got, want)


@pytest.mark.parametrize("scene, frame", [("neural_raw", 0.0), ("many_sphere", 37.0)])
def test_scene_sdf_matches_the_oracle(scene, frame):
    pts = np.random.default_rng(2).uniform(-1.2, 1.2, (2048, 3)).astype(np.float32)
    want = oracle_np.make_scene_eval(scene, [type("L", (), dict(w=w, b=b)) for w, b in LAYERS],
                                     frame)(pts)
    got = ref.scene_sdf(ref.Net(LAYERS, "cpu"), scene, frame, "cpu")(torch.from_numpy(pts))
    assert np.max(np.abs(got.numpy() - want)) <= 2e-6


@pytest.mark.parametrize("rx, ry", [(-20.0, 30.0), (15.0, 200.0)])
def test_reference_frame_agrees_with_the_oracle(rx, ry):
    """At 40x24: the same hits; the shading (exact gradient here, the
    oracle's 4-tap finite difference) within a few levels on most pixels."""
    w, h = 40, 24
    out = ref.render(ref.Net(LAYERS, "cpu"), dict(rotation_x=rx, rotation_y=ry),
                     scene="neural_raw", width=w, height=h, device="cpu", **RENDER)
    layers = [type("L", (), dict(w=a, b=b)) for a, b in LAYERS]
    rgba = oracle_np.render(layers, w, h, rotation_x=rx, rotation_y=ry).reshape(-1, 4)
    hit = rgba[:, 3] > 0
    assert np.array_equal(hit, out["alpha"].numpy() > 0)
    assert hit.sum() > 0.2 * hit.size
    grey = (np.clip(rgba[:, 0], 0, 1) * 255).astype(np.int16)
    gap = np.abs(grey[hit] - out["grey"].numpy()[hit].astype(np.int16))
    assert np.median(gap) <= 1 and np.mean(gap <= 8) >= 0.95


def test_reference_counts_its_evaluations():
    net = ref.Net(LAYERS, "cpu")
    out = ref.render(net, dict(rotation_x=0.0, rotation_y=0.0), scene="neural_raw",
                     width=16, height=16, device="cpu", **RENDER)
    evals = out["evals"].numpy()
    assert evals.max() <= RENDER["max_steps"] and evals[out["alpha"].numpy() > 0].min() >= 1
    rng = traffic.rng_for(3, "work")
    w = work.count_work(net, [dict(rotation_x=0.0, rotation_y=0.0)], scene="neural_raw",
                        width=16, height=16, render=RENDER, stride=1, rng=rng, device="cpu")
    assert w["march_evals"] == pytest.approx(float(evals.sum()))


@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_the_control_fails_the_cells_limit(cell):
    """The reference at TF32 (emulated on the CPU) in the program's place, at
    a small frame of the cell's own traffic, reads over the cell's limits
    on some number; the reference against itself reads 0."""
    c = spec.cell(cell)
    tr = dict(c["traffic"], width=160, height=90)
    poses = traffic.take(traffic.poses(tr, 11), 2)
    net = reference_net(c, 11, "cpu")
    kept = []
    for i, pose in enumerate(poses):
        low = check.reference_frame(net, pose.as_dict(), c["config"], tr, "cpu", "tf32")
        kept.append((i, torch.stack([low["grey"]] * 3 + [low["alpha"]], dim=-1), pose))
    readings = check.compare(net, kept, c["config"], tr, "cpu")["program"]
    limits = c["workload"]["limits"]
    assert any(readings[k] > v for k, v in limits.items()), readings
    same = check.reference_frame(net, poses[0].as_dict(), c["config"], tr, "cpu")
    served = torch.stack([same["grey"]] * 3 + [same["alpha"]], dim=-1)
    again = check.compare(net, [(0, served, poses[0])], c["config"], tr, "cpu")["program"]
    assert all(again[k] == 0 for k in limits)


@pytest.mark.parametrize("stand_in", [k for k in check.STAND_INS if k != "control"])
@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_each_planted_fault_fails_the_cells_limits(cell, stand_in):
    """Each fault planted in the reference put in the program's place, at a
    small frame of the cell's own traffic, reads over the cell's limits on
    some number, as ``calibrate`` reads it on the card."""
    c = spec.cell(cell)
    tr = dict(c["traffic"], width=160, height=90)
    poses = traffic.take(traffic.poses(tr, 11), 2)
    net = reference_net(c, 11, "cpu")
    kept = []
    for i, pose in enumerate(poses):
        out = check.reference_frame(net, pose.as_dict(), c["config"], tr, "cpu")
        kept.append((i, as_image(out), pose))
    readings = check.compare(net, kept, c["config"], tr, "cpu", stand_ins=(stand_in,))
    assert readings["program"]["shade_gap_pct"] == 0
    assert any(readings[stand_in][k] > v for k, v in c["workload"]["limits"].items()), \
        readings[stand_in]


def as_image(out):
    return torch.stack([out["grey"]] * 3 + [out["alpha"]], dim=-1)


@pytest.mark.cuda
def test_the_control_fails_on_the_card_at_the_cells_size():
    """On the card at 1920x1080: the TF32 control reads over every cell's
    limit on some number (the full readings come from ``calibrate``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for w in spec.benchmark()["workloads"]:
        c = spec.cell(w["name"])
        pose = next(traffic.poses(c["traffic"], 5))
        net = reference_net(c, 5, "cuda")
        low = check.reference_frame(net, pose.as_dict(), c["config"], c["traffic"], "cuda",
                                    "tf32")
        kept = [(0, torch.stack([low["grey"]] * 3 + [low["alpha"]], dim=-1), pose)]
        readings = check.compare(net, kept, c["config"], c["traffic"], "cuda")["program"]
        assert any(readings[k] > v for k, v in c["workload"]["limits"].items()), readings
