"""Model kinds (``portbench/models/``): the dense chain's kind is the code it
replaced, a kind added as one file runs a cell through the harness with no
other edit, an unknown kind names the file it lacks, and ``march_roofline``
takes an evaluation's bytes where they bound the march.

Run from the repository root: ``python -m pytest portbench/tests -q``.
"""
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import spec, weights, work
from portbench.metrics import march_roofline
from portbench.models import dense_relu
from portbench.reference import render as ref

ROOT = spec.ROOT
CONFIGS = {c["name"]: c for c in spec.benchmark()["configs"]}


def config(name):
    with open(os.path.join(ROOT, CONFIGS[name]["file"])) as f:
        return json.load(f)


@pytest.mark.parametrize("name, flops", [("csg_demo", 14592), ("csg_demo_w128", 230400)])
def test_the_dense_kind_is_the_dense_chain(name, flops):
    """A configuration without ``model`` takes ``dense_relu``: its weights are
    the checked file widened from the seed, bit for bit, its reference net
    is ``reference.render.Net``, and it counts 2 * sum(fan_in * fan_out)
    FLOPs and no bytes an evaluation."""
    cfg = config(name)
    assert "model" not in cfg and spec.model(cfg) is dense_relu
    seed = 2**31 + 5
    got = dense_relu.make(cfg, ROOT, seed)
    want = weights.load_npz(os.path.join(ROOT, cfg["weights"]))
    if cfg["widen"] > 1:
        want = weights.widen(want, cfg["widen"], seed)
    assert len(got) == len(want) and weights.layer_sizes(got) == cfg["layer_sizes"]
    for (gw, gb), (ww, wb) in zip(got, want):
        assert gw.dtype == np.float32 and gw.tobytes() == ww.tobytes()
        assert gb.tobytes() == wb.tobytes()
    pts = torch.from_numpy(np.random.default_rng(3).uniform(-1.2, 1.2, (1024, 3)).astype(np.float32))
    net = dense_relu.reference_net(got, "cpu")
    assert net.emulate_tf32 is False
    assert torch.equal(net(pts), ref.Net(want, "cpu")(pts))
    assert dense_relu.flops_per_eval(cfg) == flops and dense_relu.bytes_per_eval(cfg) == 0


@pytest.mark.parametrize("kind", ["no_such_kind", "dense_relu.extra", "../weights", ""])
def test_an_unknown_kind_names_its_missing_file(kind):
    with pytest.raises(ValueError, match=re.escape(f"portbench/models/{kind}.py")):
        spec.model({"name": "x", "model": kind})


def _run(rays, march_evals, flops_per_eval, bytes_per_eval, march_s=0.02, frames=4):
    return dict(slice=dict(frames=frames, march_s=march_s),
                work=dict(rays=rays, march_evals=march_evals, hits=1000.0,
                          flops_per_eval=flops_per_eval, bytes_per_eval=bytes_per_eval))


def _before(run):
    """``march_roofline`` as it read before evaluations moved bytes."""
    sl, w = run["slice"], run["work"]
    bound_s = max(w["march_evals"] * w["flops_per_eval"] / work.PEAK_FLOPS,
                  w["rays"] * work.RAY_BYTES / work.PEAK_BYTES_PER_S)
    return 100.0 * bound_s / (sl["march_s"] / sl["frames"])


@pytest.mark.parametrize("rays, march_evals, flops_per_eval", [
    (2073600, 4.1e8, 14592), (2073600, 3.3e8, 230400), (2073600, 1e3, 14592), (64 * 48, 3e4, 14592)])
def test_march_roofline_reads_as_before_without_bytes(rays, march_evals, flops_per_eval):
    run = _run(rays, march_evals, flops_per_eval, 0)
    assert march_roofline.read(run, "march_roofline.turntable") == _before(run)


def test_march_roofline_takes_the_bytes_where_they_bound():
    run = _run(2073600, 4.1e8, 14592, 128 * 4)
    moved = 2073600 * work.RAY_BYTES + 4.1e8 * 128 * 4
    assert moved / work.PEAK_BYTES_PER_S > 4.1e8 * 14592 / work.PEAK_FLOPS
    want = 100.0 * (moved / work.PEAK_BYTES_PER_S) / (0.02 / 4)
    assert march_roofline.read(run, "march_roofline.turntable") == pytest.approx(want, rel=1e-12)
    assert march_roofline.read(run, "march_roofline.turntable") > _before(run)


#: A kind that a later configuration might bring, as one file: a dense chain
#: whose distance is halved and less 0.02, so its surface lies outside the
#: chain's. The program gets the last layer so scaled and shifted, the
#: reference scales and shifts the chain's output. Each evaluation also
#: moves 1 MiB, so bytes bound its march.
TOY_KIND = '''
import numpy as np

from portbench.models import dense_relu
from portbench.reference.render import Net

make = dense_relu.make


def program(cnr, layers, device):
    *hidden, (w, b) = layers
    half = np.float32(0.5)
    return cnr.from_numpy_params(hidden + [(w * half, b * half - np.float32(0.02))],
                                 device=device)


class HalfNet(Net):
    def __call__(self, x):
        return 0.5 * super().__call__(x) - 0.02


def reference_net(layers, device):
    return HalfNet(layers, device)


def flops_per_eval(config):
    return dense_relu.flops_per_eval(config) + 1


def bytes_per_eval(config):
    return 1 << 20
'''

#: One traced run of the toy cell on the CPU. A CPU run has no device trace,
#: so fixed device times stand in for the profiled slice (``work.Slice``);
#: the readers' run record is kept for the test.
TOY_RUN = '''
import json

from portbench import harness, spec, work

seen = {}
real_reader = spec.reader


def reader(name):
    read = real_reader(name)

    def keep(run, n):
        seen["work"] = run["work"]
        return read(run, n)
    return keep


class DeviceTimes(work.Slice):
    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.result = dict(frames=self.frames, wall_s=1.0, busy_s=0.9, n_ops=1, march_s=0.25,
                           device_s=0.5, idle_s=0.1, device_ops=[], idle_gaps=[])
        return False


spec.reader, work.Slice = reader, DeviceTimes
r = harness.run_cell("toy.turntable_1080p", 2**31 + 23, 0.0, True, device="cpu",
                     overrides=dict(width=32, height=18, batch=2, warm_batches=1))
print(json.dumps(dict(result=r, work=seen["work"])))
'''


def test_a_kind_added_as_one_file_runs_without_an_edit(tmp_path):
    """A copy of the benchmark gains the kind ``toy_scaled`` as one file under
    ``portbench/models/``, a configuration that names it, and a cell with
    its workload file; a traced run of that cell on the CPU is correct (its
    surface is not the chain's: both sides took the kind's),
    counts the kind's FLOPs and bytes, bounds its march by the bytes, and
    reads the program's own counters (``program.run``)."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "examples/assets").mkdir(parents=True)
    shutil.copy(os.path.join(ROOT, "examples/assets/csg_demo.npz"), tmp_path / "examples/assets")
    (tmp_path / "portbench/models/toy_scaled.py").write_text(TOY_KIND)
    cfg = dict(config("csg_demo"), name="toy", model="toy_scaled")
    (tmp_path / "portbench/configs/toy.json").write_text(json.dumps(cfg))
    cell = "toy.turntable_1080p"
    shutil.copy(os.path.join(ROOT, "portbench/workloads/csg_demo.turntable_1080p.json"),
                tmp_path / f"portbench/workloads/{cell}.json")
    bench = spec.benchmark()
    bench["configs"].append(dict(CONFIGS["csg_demo"], name="toy",
                                 file="portbench/configs/toy.json"))
    bench["workloads"].append(dict(name=cell, config="toy", traffic="turntable_1080p", chips=1,
                                   why="csg_demo halved and pushed out, a kind of its own"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}", TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", TOY_RUN], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    r, w = got["result"], got["work"]
    assert r["correct"] is True and r["attempted"] > 0, r["checks"]
    assert w["flops_per_eval"] == 14593 and w["bytes_per_eval"] == 1 << 20
    moved = w["rays"] * work.RAY_BYTES + w["march_evals"] * w["bytes_per_eval"]
    flops_s = w["march_evals"] * w["flops_per_eval"] / work.PEAK_FLOPS
    assert moved / work.PEAK_BYTES_PER_S > flops_s
    want = 100.0 * (moved / work.PEAK_BYTES_PER_S) / (0.25 / 2)
    assert r["metrics"]["march_roofline.turntable"]["value"] == pytest.approx(want, rel=1e-12)
    for name in ("lane_efficiency_pct.coarse", "host_ms_per_frame.enqueue"):
        assert r["metrics"][name]["value"] > 0, name
    assert "phase_ms_per_frame.coarse" not in r["metrics"]  # no device marks on the CPU
    assert "program_idle_gaps" in r["breakdown"]
