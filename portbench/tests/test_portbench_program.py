"""The readers of the program's own spans and counters
(``portbench/program.py``, ``metrics/phase_ms_per_frame.py``,
``lane_efficiency_pct.py``, ``bucket_fill_pct.py``, ``host_ms_per_frame.py``)
on a synthetic run record, None where the run has no ``program`` part, and
``program.run`` on the CPU at 64x48 through the pipelined driver.

Run from the repository root: ``python -m pytest portbench/tests -q``.
"""
import pytest

from portbench import harness, program, spec, traffic, weights
from portbench.mixes import pipelined

NAMES = ("phase_ms_per_frame.coarse", "phase_ms_per_frame.refine",
         "phase_ms_per_frame.shade", "phase_ms_per_frame.restore",
         "lane_efficiency_pct.coarse", "lane_efficiency_pct.refine",
         "bucket_fill_pct.refine", "host_ms_per_frame.enqueue", "host_ms_per_frame.finish")


def _span(device_ms, host_ms=1.0):
    return dict(calls=4, host_ms=host_ms, device_ms=device_ms, device_calls=4)


def _record(device=True):
    dev = (lambda ms: ms) if device else (lambda ms: None)
    e = "sequence/enqueue/"
    spans = {
        e + "frame/coarse": _span(dev(20.0)), e + "frame/refine": _span(dev(30.0)),
        e + "frame/shade": _span(dev(8.0)), e + "frame/restore": _span(dev(2.0)),
        # a frame re-rendered by the host checks counts too
        "sequence/finish/" + e + "frame/refine": _span(dev(10.0)),
        "sequence/enqueue": _span(None, 6.0), "sequence/fetch": _span(None, 40.0),
        "sequence/finish": _span(None, 2.0),
        "sequence/finish/sequence/enqueue": _span(None, 1.0),
    }
    counters = {
        e + "frame/coarse/march.lanes": 400, e + "frame/coarse/march.active_in": 300,
        e + "frame/coarse/march.useful": 900, e + "frame/coarse/march.slots": 1200,
        e + "frame/refine/highest/rung0/march.lanes": 100,
        e + "frame/refine/highest/rung0/march.active_in": 60,
        e + "frame/refine/highest/rung0/march.useful": 200,
        e + "frame/refine/highest/rung0/march.slots": 400,
        e + "frame/refine/highest/rung3/march.lanes": 100,
        e + "frame/refine/highest/rung3/march.active_in": 20,
        e + "frame/refine/highest/rung3/march.useful": 300,
        e + "frame/refine/highest/rung3/march.slots": 300,
    }
    return dict(slice=dict(frames=4, program=dict(spans=spans, counters=counters,
                                                  wall_s=0.1, frames=4)))


def _read(run, name):
    return spec.reader(name)(run, name)


def test_readers_on_a_synthetic_run():
    run = _record()
    want = {"phase_ms_per_frame.coarse": 5.0, "phase_ms_per_frame.refine": 10.0,
            "phase_ms_per_frame.shade": 2.0, "phase_ms_per_frame.restore": 0.5,
            "lane_efficiency_pct.coarse": 75.0, "lane_efficiency_pct.refine": 500 / 7,
            "bucket_fill_pct.refine": 40.0, "host_ms_per_frame.enqueue": 1.5,
            "host_ms_per_frame.finish": 0.5}
    for name in NAMES:
        assert _read(run, name) == pytest.approx(want[name]), name
    cpu = _record(device=False)
    assert all(_read(cpu, n) is None for n in NAMES if n.startswith("phase_ms"))
    assert _read(cpu, "lane_efficiency_pct.refine") == pytest.approx(500 / 7)


@pytest.mark.parametrize("run", [dict(slice=None), dict(slice=dict(frames=4)),
                                 dict(slice=dict(frames=4, program=None))])
def test_readers_return_none_without_a_program_part(run):
    assert all(_read(run, name) is None for name in NAMES)


def test_program_parts_on_the_cpu():
    import cudaneuralrender_torch as cnr

    cell = spec.cell(spec.benchmark()["workloads"][0]["name"])
    tr = dict(cell["traffic"], width=64, height=48, batch=2, render={"compact_min": 64})
    layers = weights.make(cell["config"], spec.ROOT, 2**32 + 5)
    params = cnr.from_numpy_params(layers, device="cpu")
    driver = pipelined.Driver(cnr, params, harness.render_config(cnr, cell["config"], tr),
                              traffic.poses(tr, 2**32 + 5), tr)
    prog = program.run(driver, traffic.take(driver.stream, 2))
    assert not cnr.trace.enabled()
    assert prog["frames"] == 2 and prog["wall_s"] > 0 and prog["idle_gaps"] is None
    run = dict(slice=dict(frames=2, program=prog))
    values = {name: _read(run, name) for name in NAMES}
    for name, value in values.items():
        if name.startswith("phase_ms"):
            assert value is None, name  # no device marks on the CPU
        else:
            assert value is not None and value > 0, name
    for name in ("lane_efficiency_pct.coarse", "lane_efficiency_pct.refine",
                 "bucket_fill_pct.refine"):
        assert 0 < values[name] <= 100, name
