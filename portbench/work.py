"""The yardstick's arithmetic: work, peaks and the reading of a device trace.

Work is counted on the plain reference, whatever implements it: the SDF
evaluations a plain sphere trace of the cell's own poses needs (no
over-relaxation, down to ``march_eps`` from the bounding sphere's entry, at
most ``max_steps``), on a seeded sample of pixels, plus 4 evaluations a hit
pixel for the reference's tetrahedron normal (``volumeRender_kernel.cu:
362-377``). An evaluation costs the configuration's model kind's
``flops_per_eval`` FLOPs (2 * sum(fan_in * fan_out) for a dense chain) and
moves its ``bytes_per_eval`` bytes beyond the weights; the scene's compose
arithmetic is left out.
"""
from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

#: Published dense peaks of one NVIDIA H100 SXM (data sheet, 700 W): bf16
#: tensor cores, the fastest unit the march kernels use, and HBM3.
PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
#: Bytes a ray needs from and to memory, counted once: its direction in,
#: its distance and hit flag out.
RAY_BYTES = 12 + 8
#: Evaluations of the reference's tetrahedron normal at a hit pixel.
NORMAL_EVALS = 4
#: Kernel names that are the march (``csrc/march.cuh``).
MARCH_KERNELS = ("march_kernel", "march_split_kernel")
#: The longest idle gaps of a slice that are labelled by the host's activity.
LABELLED_GAPS = 400


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as err:
        return f"not read ({type(err).__name__})"
    return out.stdout.strip().splitlines()[0]


#: The harness's own spans (``record_function``), which the profiler also
#: shows on the device's timeline: they are not device work.
SPANS = ("dispatch", "drain")


def is_march(name: str) -> bool:
    """Whether a kernel's name (``void cnr::march_kernel<32, 0, 0, true>(...)``)
    is one of the march kernels."""
    base = name.split("<", 1)[0].split("(", 1)[0].strip()
    return bool(base) and base.split()[-1].split("::")[-1] in MARCH_KERNELS


class Slice:
    """torch.profiler over a steady slice of the window (a frozen and
    extended copy of ``chip_smoke.profile_breakdown``): device time by
    kernel name and busy time; with ``host=True`` also the idle gaps
    labelled by what the host was doing (the harness's span and the
    innermost host operation). Recording the host's operations slows the
    host's enqueue several times over, so a slice that is read for busy
    and idle time records the device alone."""

    def __init__(self, frames: int, host: bool = False):
        self.frames, self.host = frames, host
        self.result = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] if self.host or not self._cuda else []
        if self._cuda:
            torch.cuda.synchronize()
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None and self._cuda:  # a CPU run has no device to read
            self.result = read_trace(self._prof.events(), wall, self.frames)
        return False


def read_trace(events, wall_s: float, frames: int) -> dict:
    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type == cuda and e.name not in SPANS)
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type != cuda]
    if not dev:
        raise RuntimeError("torch.profiler recorded no device activity")
    busy_us, reach = 0.0, dev[0][0]
    per_name, march_us, gaps = {}, 0.0, []
    for start, end, name in dev:
        if start > reach:
            gaps.append((reach, start))
        busy_us += max(end, reach) - max(start, reach)
        reach = max(reach, end)
        per_name[name] = per_name.get(name, 0.0) + (end - start)
        if is_march(name):
            march_us += end - start
    h_start = np.array([h[0] for h in host], dtype=np.float64)
    h_end = np.array([h[1] for h in host], dtype=np.float64)
    h_span = np.array([h[2] in SPANS for h in host], dtype=bool)

    def label(t):
        """The harness span open at ``t`` and the innermost host operation."""
        inside = (h_start <= t) & (t < h_end)
        names = []
        for want in (True, False):
            cand = np.nonzero(inside & (h_span == want))[0]
            names.append(host[cand[np.argmax(h_start[cand])]][2] if cand.size else None)
        return f"{names[0] or 'harness'}/{names[1] or 'idle'}"

    gaps.sort(key=lambda g: g[0] - g[1])
    idle = {}
    for s, e in gaps[:LABELLED_GAPS]:
        key = label(s)
        idle[key] = idle.get(key, 0.0) + (e - s) / 1e6
    top_ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        frames=frames, wall_s=wall_s, busy_s=busy_us / 1e6, n_ops=len(dev),
        march_s=march_us / 1e6, device_s=sum(per_name.values()) / 1e6,
        idle_s=sum(e - s for s, e in gaps) / 1e6,
        device_ops=[[n[:120], us / 1e6] for n, us in top_ops],
        idle_gaps=[[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    )


def count_work(net, poses, *, scene: str, width: int, height: int, render: dict,
               stride: int, rng, device) -> dict:
    """The plain reference's evaluations a frame of the reference net
    ``net``, over a seeded sample of one pixel in ``stride`` of each pose's
    frame, scaled to the frame."""
    from .reference import render as ref

    n = width * height
    evals, hits = [], []
    for pose in poses:
        pixels = torch.as_tensor(np.sort(rng.choice(n, n // stride, replace=False)))
        out = ref.render(net, pose, scene=scene, width=width, height=height,
                         device=device, max_steps=render["max_steps"],
                         march_eps=render["march_eps"], bound_radius=render["bound_radius"],
                         focal=render["focal"], pixels=pixels)
        evals.append(float(out["evals"].sum()) * n / pixels.numel())
        hits.append(float((out["alpha"] > 0).sum()) * n / pixels.numel())
    return dict(march_evals=float(np.mean(evals)), hits=float(np.mean(hits)),
                frames=len(poses), rays=n)
