"""Finding a cell's pieces by name.

``BENCHMARK.json`` names the cells, configurations, traffic mixes and
metrics; each piece is a file of its own under ``portbench/``:

  * ``configs/<config>.json``: the net, its weights, its sizes and the
    configuration's stated render settings; its ``model`` (absent:
    ``dense_relu``) names the model kind ``models/<model>.py``, which makes
    the weights, hands them to the program and to the plain reference, and
    counts an evaluation's work;
  * ``traffic/<traffic>.json``: the parameters of one traffic mix; its
    ``delivery`` names the driver loop ``mixes/<delivery>.py`` and its
    ``path.kind`` the pose path ``paths/<kind>.py``;
  * ``workloads/<cell>.json``: the cell's own parameters (overrides of its
    traffic's, the frames it checks) and the limits of its comparison;
  * ``metrics/<family>.py``: the reader of every metric named
    ``<family>`` or ``<family>.<variant>``.

Nothing here lists a piece: a cell added as files and entries runs as is.
"""
from __future__ import annotations

import importlib
import json
import os

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)

#: Top-level module names that no process of the benchmark may load.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cudaneuralrender_tpu")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(os.path.join(ROOT, "BENCHMARK.json"))


def applies(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str) -> dict:
    """Everything one cell needs: its entry, configuration, traffic (with
    the cell's overrides applied), workload file and metrics."""
    bench = benchmark()
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    configs = [c for c in bench["configs"] if c["name"] == entry["config"]]
    if not configs:
        raise KeyError(f"workload {name!r} names no configuration of BENCHMARK.json")
    config = _json(os.path.join(ROOT, configs[0]["file"]))
    traffic = _json(os.path.join(PKG, "traffic", entry["traffic"] + ".json"))
    workload = _json(os.path.join(PKG, "workloads", name + ".json"))
    traffic = {**traffic, **workload.get("traffic_overrides", {})}
    return dict(
        entry=entry, config=config, traffic=traffic, workload=workload,
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
    )


def reader(metric_name: str):
    """The ``read(run, name)`` function of a metric's family."""
    family = metric_name.split(".", 1)[0]
    return importlib.import_module(f"portbench.metrics.{family}").read


#: The model kind of a configuration that names none.
DEFAULT_MODEL = "dense_relu"


def model(config: dict):
    """The model kind module of a configuration (``portbench/models/``)."""
    kind = config.get("model", DEFAULT_MODEL)
    name = f"portbench.models.{kind}"
    if isinstance(kind, str) and kind.isidentifier():
        try:
            return importlib.import_module(name)
        except ModuleNotFoundError as err:
            if err.name != name:
                raise
    raise ValueError(f"{config.get('name')}: no model kind file portbench/models/{kind}.py")


def mix(delivery: str):
    """The driver loop module of a traffic's ``delivery``."""
    return importlib.import_module(f"portbench.mixes.{delivery}")


def forbidden_loaded(modules) -> list:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN_MODULES)
