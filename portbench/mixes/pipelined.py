"""Pipelined delivery: batches of ``batch`` poses through
``render_sequence``, back to back, until the window's seconds have passed;
the images stay on the card. The traffic file's ``call`` holds keyword
arguments of ``render_sequence`` (``warm_start``, ``chunk``), and its
``render`` overrides of the configuration's render settings.

A traced window renders one batch's poses ``MATCHED`` times over, back to
back, unprofiled and timed, synchronised at both ends, before the process's
first profiling session; then the same poses once under the profiler to
prime it (its reading is dropped), once more recording the device alone
(the slice that the per-layer metrics read); then the next batch profiled
with the host as well, for the idle gaps' labels. The profiler costs the host time,
and recording the host's operations slows its enqueue several times over,
so the slice's busy time and work are set against the unprofiled renderings
of the same frames (``matched_s``, ``matched_frames``). One reading session
of each kind: a process's later sessions can return the events of earlier
ones. After the host batch, the program's own spans and counters are read
on the slice's poses (``program.run``) and kept as the slice's ``program``.
A traced window runs on past its seconds until that is done.
"""
from __future__ import annotations

import contextlib
import time

import torch

from .. import program, traffic, work

#: Unprofiled renderings of the slice's poses before it is profiled.
MATCHED = 3


def span(name: str):
    return torch.profiler.record_function(name)


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def plan(b: int, trace: bool, warm: bool):
    """Batch ``b``'s part: None (untouched), ``"matched"``, ``"prime"``,
    ``"device"`` (the profiled slice) or ``"host"``."""
    if warm or not trace:
        return None
    if 1 <= b <= MATCHED:
        return "matched"
    return {MATCHED + 1: "prime", MATCHED + 2: "device", MATCHED + 3: "host"}.get(b)


class Driver:
    def __init__(self, cnr, params, rcfg, stream, tr: dict):
        self.cnr, self.params, self.rcfg, self.stream = cnr, params, rcfg, stream
        self.batch, self.warm_batches = int(tr["batch"]), int(tr["warm_batches"])
        self.call = dict(tr.get("call", {}))

    def render(self, poses, stats) -> list:
        cams = [self.cnr.Camera(rotation_x=p.rotation_x, rotation_y=p.rotation_y)
                for p in poses]
        return self.cnr.render_sequence(self.params, cams, self.rcfg,
                                        frames=[p.frame for p in poses], stats_out=stats,
                                        **self.call)

    def run(self, *, seconds, keeper, trace, warm) -> dict:
        """The window (``warm``: ``warm_batches`` batches of warm-up)."""
        frames, slice_, poses = [], None, []
        matched_s = matched_frames = 0
        start = last = time.perf_counter()
        b = 0
        while (b < self.warm_batches) if warm else (
                time.perf_counter() < start + seconds or (trace and b <= MATCHED + 3)):
            part = plan(b, trace, warm)
            if part not in ("prime", "device") and not (part == "matched" and b > 1):
                poses = traffic.take(self.stream, self.batch)
            if part == "matched" and b == 1:
                sync()
                t_matched = time.perf_counter()
            profiled = part in ("prime", "device", "host")
            ctx = work.Slice(self.batch, host=part == "host") if profiled \
                else contextlib.nullcontext()
            stats = []
            with ctx:
                with span("dispatch"):
                    images = self.render(poses, stats)
                last = time.perf_counter()
                with span("drain"):
                    for p, img, st in zip(poses, images, stats):
                        if keeper is not None:
                            keeper.offer(len(frames), st["steps"], img, p)
                        frames.append(dict(pose=p, stats=st, done=last))
            if part == "matched":
                matched_frames += len(poses)
                if b == MATCHED:
                    sync()
                    matched_s = time.perf_counter() - t_matched
            if part in ("device", "host") and ctx.result is not None:
                if part == "device":
                    slice_ = dict(ctx.result, matched_s=matched_s,
                                  matched_frames=matched_frames,
                                  poses=[p.as_dict() for p in poses])
                elif slice_ is not None:
                    slice_["idle_gaps"] = ctx.result["idle_gaps"]
                    slice_["program"] = program.run(
                        self, [traffic.Pose(**p) for p in slice_["poses"]])
            b += 1
        return dict(start=start, end=last, frames=frames, slice=slice_)

    @staticmethod
    def to_bytes(image) -> torch.Tensor:
        """The float frame packed as ``rgbaFloatToInt`` packs it."""
        return (torch.clamp(image.detach(), 0.0, 1.0) * 255.0).to(torch.uint8).cpu()
