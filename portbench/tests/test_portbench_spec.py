"""BENCHMARK.json and the files it names: every piece resolves by name, the
file keeps to the benchmark's contract, a cell added as files runs without
an edit, and nothing imports JAX or the JAX package.

Run from the repository root: ``python -m pytest portbench/tests -q``.
"""
import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import spec, traffic

ROOT = spec.ROOT
BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def py_files(folder):
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported_top_levels(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(str(arg.value).split(".", 1)[0])
    return names


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(cell):
    c = spec.cell(cell)
    assert c["config"]["name"] == c["entry"]["config"]
    assert callable(spec.mix(c["traffic"]["delivery"]).Driver)
    assert callable(traffic.path_kind(c["traffic"]["path"]["kind"]).poses)
    assert c["workload"]["limits"], "a cell compares at least one number"
    assert any(m["name"] == "setup_s" for m in c["end_to_end"])
    assert len(c["end_to_end"]) >= 2 and c["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    cells = {w["name"]: w for w in BENCH["workloads"]}
    configs = {c["name"]: c for c in BENCH["configs"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in cells.values())
    pairs = set()
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(cells) if "workloads" in m else True
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and "\n" not in m["layer"]
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert spec.applies(moved, cell), f"{m['name']} in {cell} moves {m['moves']}"
        if "roofline" in m["name"]:
            assert m["name"].split(".", 1)[0].endswith("_roofline") and m["unit"] == "%"
    for cell in cells:  # every cell reports setup_s, another end-to-end metric, a per-layer one
        names = [m["name"] for m in BENCH["end_to_end"] if spec.applies(m, cell)]
        assert "setup_s" in names and len(names) >= 2
        assert any(spec.applies(m, cell) for m in BENCH["per_layer"])


def test_no_module_imports_jax_or_the_jax_package():
    folder = os.path.join(ROOT, "portbench")
    for path in py_files(folder):
        bad = imported_top_levels(path) & set(spec.FORBIDDEN_MODULES)
        assert not bad, f"{path} imports {bad}"
    ref = os.path.join(folder, "reference")
    for path in py_files(ref):
        names = imported_top_levels(path)
        assert "cudaneuralrender_torch" not in names and "portbench" not in names, path
    for path in py_files(os.path.join(folder, "models")):  # the program is handed to a kind
        assert "cudaneuralrender_torch" not in imported_top_levels(path), path


@pytest.mark.parametrize("modules, flagged", [
    (["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client"]),
    (["cudaneuralrender_tpu", "cudaneuralrender_tpu.ops.sdf"],
     ["cudaneuralrender_tpu", "cudaneuralrender_tpu.ops.sdf"]),
    (["cudaneuralrender_torch", "cudaneuralrender_torch.ops", "jaxtyping", "flaxen", "numpy"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(modules, flagged):
    assert spec.forbidden_loaded(modules) == flagged


#: A driver loop that a later cell might bring: one synchronised frame at a
#: time through ``render_staged``.
ONE_BY_ONE = """
import time

import torch


class Driver:
    def __init__(self, cnr, params, rcfg, stream, tr):
        self.cnr, self.params, self.rcfg, self.stream = cnr, params, rcfg, stream
        self.warm_frames = int(tr["warm_frames"])

    def run(self, *, seconds, keeper, trace, warm):
        frames, start = [], time.perf_counter()
        while (len(frames) < self.warm_frames) if warm else \\
                (time.perf_counter() < start + seconds):
            pose, st = next(self.stream), {}
            cam = self.cnr.Camera(rotation_x=pose.rotation_x, rotation_y=pose.rotation_y)
            image = self.cnr.render_staged(self.params, cam, self.rcfg, frame=pose.frame,
                                           stats_out=st)
            if keeper is not None:
                keeper.offer(len(frames), st["steps"], image, pose)
            frames.append(dict(pose=pose, stats=st, done=time.perf_counter()))
        return dict(start=start, end=frames[-1]["done"], frames=frames, slice=None)

    @staticmethod
    def to_bytes(image):
        return (torch.clamp(image, 0.0, 1.0) * 255.0).to(torch.uint8).cpu()
"""

#: A pose path that a later cell might bring: one pose, held.
HELD = """
from portbench.traffic import Pose


def poses(path, traffic, rng):
    while True:
        yield Pose(float(path["pitch_deg"]), float(path["yaw_deg"]), 0.0)
"""


def test_a_cell_added_as_files_runs_without_an_edit(tmp_path):
    """A copy of the benchmark gains a driver loop, a pose path, a traffic
    mix, a cell, an end-to-end metric and a per-layer metric as new files
    and entries only, and runs."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "examples/assets").mkdir(parents=True)
    shutil.copy(os.path.join(ROOT, "examples/assets/csg_demo.npz"), tmp_path / "examples/assets")
    bench = json.loads(json.dumps(BENCH))
    (tmp_path / "portbench/mixes/one_by_one.py").write_text(ONE_BY_ONE)
    (tmp_path / "portbench/paths/held.py").write_text(HELD)
    (tmp_path / "portbench/traffic/held_tiny.json").write_text(json.dumps(dict(
        delivery="one_by_one", scene="neural_raw", width=32, height=24, warm_frames=1,
        path=dict(kind="held", pitch_deg=10.0, yaw_deg=30.0))))
    (tmp_path / "portbench/workloads/csg_demo.held_tiny.json").write_text(json.dumps(
        {"check_frames": 2, "traffic_overrides": {}, "limits": {"mask_mismatch_pct": 100.0}}))
    (tmp_path / "portbench/metrics/frames_per_s.py").write_text(
        "def read(run, name):\n    w = run['window']\n"
        "    return len(w['frames']) / (w['end'] - w['start'])\n")
    (tmp_path / "portbench/metrics/frames_served.py").write_text(
        "def read(run, name):\n    return float(len(run['window']['frames']))\n")
    cell = "csg_demo.held_tiny"
    bench["workloads"].append(dict(name=cell, config="csg_demo", traffic="held_tiny",
                                   chips=1, why="a tiny held pose, a frame at a time"))
    bench["end_to_end"].append(dict(name="frames_per_s", unit="frames/s", better="higher",
                                    bound=0.25, source="host_clock", workloads=[cell]))
    bench["per_layer"].append(dict(name="frames_served", unit="frames", better="higher",
                                   source="host_clock", layer="entry",
                                   moves="frames_per_s", workloads=[cell]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json; from portbench import harness; "
            f"r = harness.run_cell({cell!r}, 2**31 + 17, 0.5, {{trace}}, device='cpu'); "
            "print(json.dumps(r))")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}", TMPDIR=str(tmp_path))
    for trace, key in ((False, "frames_per_s"), (True, "frames_served")):
        out = subprocess.run([sys.executable, "-c", code.replace("{trace}", str(trace))],
                             cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert key in result["metrics"] and result["attempted"] > 0
        assert list(result)[-1] == "checks"


@pytest.mark.parametrize("stand_ins", [(), ("control",)])
def test_a_traffic_file_passes_call_arguments_and_render_settings(monkeypatch, stand_ins):
    """A traffic's ``call`` reaches ``render_sequence`` as keyword arguments
    and its ``render`` overrides the configuration's render settings, on
    the program's side and on the reference's; the control stand-in renders
    the model kind's reference net with its matmuls at TF32 (emulated on
    the CPU), and only the control does."""
    import cudaneuralrender_torch as cnr

    from portbench import check, harness

    seen = []
    real = cnr.render_sequence

    def render_sequence(params, cams, rcfg, *args, **kw):
        seen.append((rcfg.max_steps, kw.get("chunk")))
        return real(params, cams, rcfg, *args, **kw)

    monkeypatch.setattr(cnr, "render_sequence", render_sequence)
    refs, tf32 = [], []
    real_ref = check.ref.render
    monkeypatch.setattr(check.ref, "render", lambda *a, **kw: refs.append(
        (kw["max_steps"], kw.get("precision", "float32"))) or real_ref(*a, **kw))
    real_tf32 = check.ref._Tf32Matmul.apply
    monkeypatch.setattr(check.ref._Tf32Matmul, "apply",
                        lambda *a: tf32.append(1) or real_tf32(*a))
    cell = BENCH["workloads"][0]["name"]
    result = harness.run_cell(cell, 2**32 + 3, 0.2, False, device="cpu", overrides=dict(
        width=32, height=18, batch=2, warm_batches=1, call={"chunk": 2},
        render={"max_steps": 5000}), stand_ins=stand_ins)
    assert result["attempted"] > 0
    assert seen and all(s == (5000, 2) for s in seen)
    assert refs and all(r[0] == 5000 for r in refs)
    control = "control" in stand_ins
    assert ("tf32" in {r[1] for r in refs}) == control and bool(tf32) == control
    assert ("control" in result["readings"]) == control


def test_a_traced_window_renders_its_slice_past_its_seconds(monkeypatch):
    """A traced pipelined window renders a batch's poses unprofiled
    ``MATCHED`` times, then to prime the profiler, then for the slice, and
    the next batch for the host's labels, however short its seconds."""
    from portbench import harness
    from portbench.mixes import pipelined

    rendered = []
    real = pipelined.Driver.render

    def render(self, poses, stats):
        rendered.append(tuple(p.rotation_y for p in poses))
        return real(self, poses, stats)

    monkeypatch.setattr(pipelined.Driver, "render", render)
    harness.run_cell(BENCH["workloads"][0]["name"], 2**32 + 9, 0.0, True, device="cpu",
                     overrides=dict(width=16, height=9, batch=2, warm_batches=1))
    window = rendered[1:]
    m = pipelined.MATCHED
    assert len(window) == m + 4
    assert len(set(window[1:m + 3])) == 1 and window[m + 3] != window[m + 2]
