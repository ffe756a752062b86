"""The port's spans and counters (``cudaneuralrender_torch.utils.trace``).

On the CPU, csg_demo at 64x48, max_steps 300, compact_min 64 (so the refine
rungs run on the march kernel's plain version, ``march_state``):
  * images and ``stats_out`` of ``render_staged`` and ``render_sequence``
    are bit-equal with tracing on and off, under the default ladder (whose
    first bucket overflows at this size: the re-renders of
    ``_sequence_finish`` run too) and under a ladder whose frames stay on
    the fast path;
  * with tracing on, each span of the staged frame appears once a frame,
    nested under its parent, and the device spans are None on the CPU;
  * one hand-built ``march_state`` call, at 32 and at 128 (csg_demo
    widened), counts its lanes, its active lanes at entry, ``useful`` =
    sum(lane_steps - start) and ``slots`` = the lockstep unit x the sum
    over units of the deepest lane (a ray per thread: a warp of 32, at 128
    a block's group of ``megakernel.SHARED_GROUP`` rays, the launcher's
    ``kGroupRays``) or the ray-steps (a ray per warp), and ``split_lanes``
    (a ray per warp) or ``shared_lanes`` (a ray per thread at 128);
  * with tracing off, a profiled frame issues as many aten ops as with
    ``span`` and ``count`` patched to no-ops.
On the card (marked ``cuda``; skips elsewhere): a captured CUDA graph
holding a span around ``torch.cuda._sleep`` replayed three times reads a
device count of 3 and about three times one replay's time. Run it there
with ``python -m pytest tests/test_torch_trace.py --noconftest -m cuda``.
"""
import contextlib
import os
import re

import pytest
import torch

import cudaneuralrender_torch as ct
from cudaneuralrender_torch.kernels import megakernel
from cudaneuralrender_torch.ops import march as march_t
from cudaneuralrender_torch.utils import trace

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H5 = os.path.join(REPO, "examples", "assets", "csg_demo.h5")
SMALL = dict(width=64, height=48, max_steps=300, march_impl="staged", compact_min=64)
#: A first refine bucket of half the image: every frame at SMALL stays fast.
FAST_LADDER = ((2, 16), (4, 24), (16, 64), (64, 0))
FRAME_SPANS = ("frame", "frame/coarse", "frame/refine", "frame/refine/highest",
               "frame/refine/highest/rung0", "frame/refine/highest/rung1",
               "frame/refine/highest/rung2", "frame/refine/highest/rung3",
               "frame/shade", "frame/restore")


@pytest.fixture(autouse=True)
def tracing_off_after():
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def params():
    return ct.load(H5, device="cpu")


def _cams(n):
    return [ct.Camera(rotation_x=-20.0, rotation_y=30.0 + 7.0 * i) for i in range(n)]


def _render_both(params, cfg, on: bool):
    ct.reset_schedule_memo()
    (trace.enable if on else trace.disable)()
    trace.reset()
    seq_stats, one_stats = [], {}
    images = ct.render_sequence(params, _cams(2), cfg, stats_out=seq_stats)
    images.append(ct.render_staged(params, _cams(1)[0], cfg, stats_out=one_stats))
    return images, seq_stats + [one_stats]


@pytest.mark.parametrize("ladder", ["default", "fast"])
def test_images_and_stats_equal_with_tracing_on_and_off(params, ladder):
    extra = {} if ladder == "default" else dict(refine_schedule=FAST_LADDER)
    cfg = ct.RenderConfig(**SMALL, **extra).validate()
    off, off_stats = _render_both(params, cfg, on=False)
    on, on_stats = _render_both(params, cfg, on=True)
    assert on_stats == off_stats
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    if ladder == "default":  # the overflow re-renders ran, traced
        assert not all(s["fast_path"] for s in on_stats)
        assert any(k.startswith("sequence/finish/sequence/enqueue/frame")
                   for k in trace.snapshot()["spans"])


def test_every_span_once_a_frame_nested(params):
    cfg = ct.RenderConfig(**SMALL, refine_schedule=FAST_LADDER).validate()
    ct.reset_schedule_memo()
    trace.enable()
    trace.reset()
    stats = []
    ct.render_sequence(params, _cams(3), cfg, stats_out=stats)
    assert all(s["fast_path"] for s in stats)
    spans = trace.snapshot()["spans"]
    for name in ("sequence/enqueue", "sequence/fetch", "sequence/finish"):
        assert spans[name]["calls"] == 1, name
    for name in FRAME_SPANS:
        assert spans["sequence/enqueue/" + name]["calls"] == 3, name
    assert set(spans) == ({"sequence/enqueue", "sequence/fetch", "sequence/finish"}
                          | {"sequence/enqueue/" + n for n in FRAME_SPANS})
    for name, entry in spans.items():
        assert entry["device_ms"] is None and entry["device_calls"] is None, name
        parent = name.rsplit("/", 1)[0]
        if "/" in name and parent != "sequence":
            assert parent in spans, name
            assert spans[parent]["host_ms"] >= entry["host_ms"], name

    ct.reset_schedule_memo()
    trace.reset()
    ct.render_staged(params, _cams(1)[0], cfg)
    spans = trace.snapshot()["spans"]
    for name in FRAME_SPANS:
        assert spans["sequence/enqueue/" + name]["calls"] == 1, name
    counters = trace.snapshot()["counters"]
    for phase in ("coarse", "refine/highest/rung0", "refine/highest/rung3"):
        key = f"sequence/enqueue/frame/{phase}/march."
        assert 0 < counters[key + "useful"] <= counters[key + "slots"], phase
        assert counters[key + "active_in"] <= counters[key + "lanes"], phase


@pytest.fixture(scope="module")
def params128(params):
    """csg_demo widened to 3 -> 128 x 8 -> 1 (chip_smoke.widen)."""
    import chip_smoke

    return ct.from_numpy_params(chip_smoke.widen(ct.mlp.to_numpy_params(params), 4, seed=4),
                                device="cpu")


def _group_in_source(name: str) -> int:
    """A constant of the 128-wide group march in the launcher's source
    (csrc/chain.cuh: ``kGroupRays``, the rays of a group; ``kGroupBlock``,
    the threads of a block)."""
    with open(os.path.join(REPO, "cudaneuralrender_torch", "csrc", "chain.cuh")) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


@pytest.mark.parametrize("hidden,lanes", [(32, 1), (32, megakernel.SPLIT_LANES), (128, 1),
                                          (128, megakernel.SPLIT_LANES)])
def test_march_counters_of_one_call(params, params128, hidden, lanes):
    """One call's counters: ``slots`` at the lockstep unit the launch used
    (a warp at 32; a block's group, SHARED_GROUP rays as the launcher's
    source has it, at 128 a ray per thread; each ray alone a ray per warp),
    ``split_lanes`` a ray per warp, ``shared_lanes`` only at 128 a ray per
    thread."""
    net = params128 if hidden == 128 else params
    cfg = ct.RenderConfig(**SMALL).validate()
    n, start = 70, 5  # the last warp holds 6 lanes, the last 64-ray group 6
    g = torch.Generator().manual_seed(3)
    theta = torch.rand(n, generator=g) * 0.6 - 0.3
    dirs = torch.stack([torch.sin(theta), 0.2 * torch.cos(theta), torch.cos(theta)], 1)
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    origin = torch.tensor([0.0, 0.0, -2.0])
    state = march_t.init_state(origin, dirs, cfg.bound_center, cfg.bound_radius)
    active = state.active & (torch.rand(n, generator=g) < 0.8)
    state = state._replace(active=active, steps=torch.tensor(start, dtype=torch.int32))
    trace.enable()
    trace.reset()
    with trace.span("call"):
        _, lane_steps = megakernel.march_state(
            net, origin, dirs, state, cfg, num_steps=40, return_resolve=True,
            _ray_lanes=lanes)
    counters = trace.snapshot()["counters"]
    steps = (lane_steps - start).tolist()
    assert max(steps) > 0 and min(steps) == 0
    unit = 1 if lanes != 1 else (_group_in_source("kGroupRays") if hidden == 128 else 32)
    assert megakernel.SHARED_BLOCK == _group_in_source("kGroupBlock")
    assert megakernel.lockstep_lanes(hidden, lanes) == unit
    slots = unit * sum(max(steps[i:i + unit]) for i in range(0, n, unit))
    mode = ({"call/march.split_lanes": n} if lanes != 1 else
            {"call/march.shared_lanes": n} if hidden == 128 else {})
    assert counters == {"call/march.lanes": n, "call/march.active_in": int(active.sum()),
                        "call/march.useful": sum(steps), "call/march.slots": slots, **mode}
    assert counters["call/march.useful"] <= counters["call/march.slots"]


def _aten_ops(params, cfg) -> int:
    from torch.profiler import ProfilerActivity, profile

    ct.reset_schedule_memo()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ct.render_staged(params, _cams(1)[0], cfg)
    return sum(1 for e in prof.events() if e.name.startswith("aten::"))


def test_tracing_off_adds_no_ops(params, monkeypatch):
    cfg = ct.RenderConfig(**SMALL, refine_schedule=FAST_LADDER).validate()
    trace.disable()
    _aten_ops(params, cfg)  # packs the weights, makes the constants
    off = _aten_ops(params, cfg)
    monkeypatch.setattr(trace, "span", lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(trace, "count", lambda *a, **k: None)
    assert _aten_ops(params, cfg) == off


@pytest.mark.cuda
def test_graph_replays_accumulate_device_marks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    trace.enable()
    with trace.span("warm", dev):  # the library and the buffer, before capture
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        with trace.span("sleep", dev):
            torch.cuda._sleep(20_000_000)

    def replays(k):
        trace.reset()
        for _ in range(k):
            graph.replay()
        torch.cuda.synchronize()
        return trace.snapshot()["spans"]["sleep"]

    one, three = replays(1), replays(3)
    assert one["device_calls"] == 1 and three["device_calls"] == 3
    assert one["device_ms"] > 1.0
    assert 2.7 * one["device_ms"] < three["device_ms"] < 3.3 * one["device_ms"]
    assert three["calls"] == 0  # the host block ran at capture only
