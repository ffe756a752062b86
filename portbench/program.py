"""The program's own spans and counters over a traced window's poses.

``cudaneuralrender_torch.trace`` (off by default) times the staged frame's
phases on the card's clock, through CUDA graphs too, and counts each march
call's lanes. ``run(driver, poses)`` reads it in three parts on one batch's
poses, after a traced window's ``"host"`` part, whose frames go neither to
the window's frames nor to its keeper:

  * ``"program_warm"``: tracing on, one batch (through ``chunk=k`` this
    captures the traced graph: a graph with marks never serves an untraced
    call);
  * ``"program"``: ``trace.reset()``, one batch unprofiled, synchronised at
    both ends, then ``trace.snapshot()`` with its wall time and frames;
  * ``"program_host"``: the same poses profiled with the host, the idle
    gaps labelled ``<harness span>/<innermost cnr span>/<host op>``
    (``program_gaps``).

Then tracing is off again. A driver loop stores the result as its slice's
``program``; the readers (``metrics/phase_ms_per_frame.py``,
``lane_efficiency_pct.py``, ``bucket_fill_pct.py``, ``host_ms_per_frame.py``)
read it there, and return None where a run has none.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import work


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def run(driver, poses) -> dict:
    """The three parts on ``poses`` through ``driver.render``: the
    ``"program"`` part's snapshot (``spans``, ``counters``) with its
    ``wall_s`` and ``frames``, and the ``"program_host"`` part's
    ``idle_gaps`` (None without a card)."""
    trace = driver.cnr.trace
    trace.enable()
    try:
        driver.render(poses, [])
        trace.reset()
        _sync()
        t0 = time.perf_counter()
        driver.render(poses, [])
        _sync()
        out = dict(trace.snapshot(), wall_s=time.perf_counter() - t0, frames=len(poses))
        with HostSlice(len(poses)) as sl:
            with torch.profiler.record_function("dispatch"):
                driver.render(poses, [])
        out["idle_gaps"] = sl.result
    finally:
        trace.disable()
    return out


class HostSlice(work.Slice):
    """``work.Slice(host=True)`` whose reading is ``program_gaps``."""

    def __init__(self, frames: int):
        super().__init__(frames, host=True)

    def __exit__(self, *exc):
        if self._cuda:
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is None and self._cuda:
            self.result = program_gaps(self._prof.events())
        return False


def _annotation(name: str) -> bool:
    """A ``record_function`` range, which the profiler also shows on the
    device's timeline: the harness's spans and the program's ``cnr.*``."""
    return name in work.SPANS or name.startswith("cnr.")


def program_gaps(events) -> list:
    """The device's idle gaps between its operations, the
    ``work.LABELLED_GAPS`` longest labelled by what the host was doing at
    their start (the harness's span, the innermost ``cnr.*`` span, the
    innermost other host operation): the 10 labels of the most idle
    seconds, as [label, seconds]."""
    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == cuda and not _annotation(e.name))
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type != cuda]
    if not dev:
        raise RuntimeError("torch.profiler recorded no device activity")
    gaps, reach = [], dev[0][0]
    for start, end in dev:
        if start > reach:
            gaps.append((reach, start))
        reach = max(reach, end)
    h_start = np.array([h[0] for h in host], dtype=np.float64)
    h_end = np.array([h[1] for h in host], dtype=np.float64)
    kind = np.array([0 if h[2] in work.SPANS else 1 if h[2].startswith("cnr.") else 2
                     for h in host], dtype=np.int64)

    def label(t):
        inside = (h_start <= t) & (t < h_end)
        names = []
        for want in (0, 1, 2):
            cand = np.nonzero(inside & (kind == want))[0]
            names.append(host[cand[np.argmax(h_start[cand])]][2] if cand.size else None)
        return f"{names[0] or 'harness'}/{names[1] or 'cnr'}/{names[2] or 'idle'}"

    gaps.sort(key=lambda g: g[0] - g[1])
    idle = {}
    for s, e in gaps[:work.LABELLED_GAPS]:
        key = label(s)
        idle[key] = idle.get(key, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]]


def program_of(run):
    """The traced slice's ``program`` part, or None."""
    sl = run.get("slice")
    prog = sl.get("program") if sl else None
    return prog if prog and prog.get("frames") else None


def _is(name: str, path: str) -> bool:
    return name == path or name.endswith("/" + path)


def device_ms(prog, path: str):
    """The device ms of every span named ``path`` (at any depth: a frame
    re-rendered by the host checks too), or None where none ran or the
    device had no marks."""
    values = [s["device_ms"] for name, s in prog["spans"].items() if _is(name, path)]
    if not values or any(v is None for v in values):
        return None
    return sum(values)


def counter_sum(prog, phase: str, key: str) -> int:
    """The march calls' counter ``key`` summed over every call inside the
    frame's ``phase`` span."""
    inside = f"frame/{phase}/"
    return sum(v for name, v in prog["counters"].items()
               if name.endswith("/march." + key) and (name.startswith(inside)
                                                      or "/" + inside in name))
