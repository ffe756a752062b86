"""Timing on the card: CUDA-event medians and the card's name and power limit."""
from __future__ import annotations

import statistics
import subprocess

import torch


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, reps: int, warmup: int = 0) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs after ``warmup``
    untimed ones, each run timed by CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
