"""Spans and counters inside the renderer, off by default.

    from cudaneuralrender_torch import trace
    trace.enable()
    trace.reset()
    cnr.render_sequence(...)
    trace.snapshot()   # {"spans": {...}, "counters": {...}}

``span(name)`` times a block of the program under its full nested name
(``frame/refine/highest/rung1``): the host's ``perf_counter`` time and call
count; a ``torch.profiler.record_function("cnr." + full name)`` range, so a
profiler session shows the span on the device trace's clock; and, where the
span or an enclosing one names a CUDA device, a begin mark and an end mark
on the device's current stream. A mark is a one-thread kernel
(``csrc/march.cu`` ``cnr_trace_mark``) that reads the card's
``%globaltimer``: the begin mark stores the time in the span's slot, the end
mark adds the time since then to the slot's total and 1 to its count. Marks
are nodes of a captured CUDA graph, so every replay accumulates on the
device with no host sync (events in a graph are re-recorded by each replay
and keep only the last one). A device span also holds whatever the stream
ran between its marks, the marks themselves and any idle time included.

``count(name, **values)`` adds int64 totals (0-d tensors or ints) into the
same preallocated device buffer, under ``<enclosing span>/<name>.<key>``.
Slots are given to names on the host at first use; the buffer is made by the
first traced call on a device, so a CUDA graph captured with tracing on
(``render_sequence(chunk=k)``'s capture renders a frame first) writes into a
buffer that already exists, and ``reset`` zeroes it in place.

Off, ``span`` returns one shared null context and ``count`` returns at once:
neither touches a tensor or the device, and callers compute what they count
only when ``enabled()``.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

#: int64 words of a device's buffer: a span takes 3 (begin, total ns,
#: count), a counter 1.
BUFFER_WORDS = 8192

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_on = False
_host: dict = {}      # full span name -> [calls, seconds]
_span_slots: dict = {}  # (device, full span name) -> word offset
_count_slots: dict = {}  # (device, name prefix, keys) -> word offset of the first key
_buffers: dict = {}   # device -> int64 [BUFFER_WORDS]
_used: dict = {}      # device -> words given out


def enable() -> None:
    """Turn spans and counters on (for every thread of the process)."""
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Zero the host totals and every device buffer in place (slots stay
    given, so captured graphs keep writing where ``snapshot`` reads)."""
    with _lock:
        _host.clear()
        for buf in _buffers.values():
            buf.zero_()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _buffer(dev: torch.device) -> torch.Tensor:
    buf = _buffers.get(dev)
    if buf is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("trace: the first traced call on a device must come before "
                               "a CUDA graph capture (the buffer would live in the graph)")
        buf = _buffers[dev] = torch.zeros(BUFFER_WORDS, dtype=torch.int64, device=dev)
    return buf


def _slot(table: dict, key: tuple, words: int) -> int:
    dev = key[0]
    s = table.get(key)
    if s is None:
        s = _used.get(dev, 0)
        if s + words > BUFFER_WORDS:
            raise RuntimeError(f"trace: the device buffer's {BUFFER_WORDS} words are given out")
        _used[dev] = s + words
        table[key] = s
    return s


def _mark(dev: torch.device, slot: int, end: bool) -> None:
    from ..kernels import build

    lib = build.load_library()
    err = lib.cnr_trace_mark(dev.index, _buffers[dev].data_ptr(), slot, int(end),
                             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"trace mark launch failed: {lib.cnr_error_string(err).decode()} "
                           f"({err})")


class _Span:
    __slots__ = ("name", "device", "full", "slot", "record", "t0")

    def __init__(self, name: str, device):
        self.name = name
        self.device = None if device is None else _device(device)

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.full = f"{parent.full}/{self.name}" if parent else self.name
        if self.device is None and parent is not None:
            self.device = parent.device
        stack.append(self)
        self.record = torch.profiler.record_function("cnr." + self.full)
        self.record.__enter__()
        self.slot = None
        if self.device is not None and self.device.type == "cuda":
            with _lock:
                _buffer(self.device)
                self.slot = _slot(_span_slots, (self.device, self.full), 3)
            _mark(self.device, self.slot, end=False)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        if self.slot is not None:
            _mark(self.device, self.slot, end=True)
        self.record.__exit__(*exc)
        _stack().pop()
        with _lock:
            total = _host.setdefault(self.full, [0, 0.0])
            total[0] += 1
            total[1] += seconds
        return False


def span(name: str, device=None):
    """A context that times its block as ``name`` under the enclosing span.
    ``device`` (else the enclosing span's) places the device marks: on a
    CUDA device, its current stream; elsewhere none."""
    return _Span(name, device) if _on else _NULL


def count(name: str, **values) -> None:
    """Add each value (a 0-d integer tensor, on the device that holds the
    buffer, or an int) to the counter ``<enclosing span>/<name>.<key>``."""
    if not _on:
        return
    stack = _stack()
    prefix = f"{stack[-1].full}/{name}" if stack else name
    tensors = [(k, v) for k, v in values.items() if isinstance(v, torch.Tensor)]
    ints = [(k, int(v)) for k, v in values.items() if not isinstance(v, torch.Tensor)]
    dev = tensors[0][1].device if tensors else (stack[-1].device if stack else None)
    dev = torch.device("cpu") if dev is None else dev
    keys = tuple(k for k, _ in tensors + ints)
    with _lock:
        buf = _buffer(dev)
        # The keys of one call take consecutive words: its tensors add in one op.
        s0 = _slot(_count_slots, (dev, prefix, keys), len(keys))
    if tensors:
        buf[s0:s0 + len(tensors)].add_(
            torch.stack([v.reshape(()).to(torch.int64) for _, v in tensors]))
    for i, (_, v) in enumerate(ints):
        buf[s0 + len(tensors) + i].add_(v)


def snapshot() -> dict:
    """Everything recorded since ``reset``, in one fetch a device:
    ``spans``: full name -> ``calls`` and ``host_ms`` (the host's blocks),
    ``device_ms`` and ``device_calls`` (the device marks' totals; None for a
    span that never ran on a CUDA device); ``counters``: full name -> int.
    What did not run since ``reset`` is left out, and so is a counter call
    whose values all read 0."""
    with _lock:
        host = {k: list(v) for k, v in _host.items()}
        words = {dev: buf.cpu().tolist() for dev, buf in _buffers.items()}
        spans_at = dict(_span_slots)
        counts_at = dict(_count_slots)
    spans = {name: dict(calls=c, host_ms=s * 1e3, device_ms=None, device_calls=None)
             for name, (c, s) in host.items()}
    for (dev, name), s in spans_at.items():
        total_ns, calls = words[dev][s + 1], words[dev][s + 2]
        if not calls and name not in spans:
            continue  # given a slot before the last reset, not run since
        entry = spans.setdefault(name, dict(calls=0, host_ms=0.0, device_ms=None,
                                            device_calls=None))
        entry["device_ms"] = (entry["device_ms"] or 0.0) + total_ns / 1e6
        entry["device_calls"] = (entry["device_calls"] or 0) + calls
    counters = {}
    for (dev, prefix, keys), s in counts_at.items():
        values = words[dev][s:s + len(keys)]
        if not any(values):
            continue  # not counted since the last reset
        for k, v in zip(keys, values):
            counters[f"{prefix}.{k}"] = counters.get(f"{prefix}.{k}", 0) + v
    return dict(spans=spans, counters=counters)
