"""One run of one cell: set-up, the measured window, the check, the metrics.

The program under test is ``cudaneuralrender_torch``, driven through its
public API only, by the driver loop that the traffic's ``delivery`` names
(``portbench/mixes/``).
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

from . import check, spec, traffic, work


def fresh_memo() -> None:
    """Point the program's schedule store at a fixed file under ``TMPDIR``,
    emptied at the start of every run, so each run learns its own schedule
    in its own warm-up."""
    path = os.path.join(tempfile.gettempdir(), "portbench", "schedule_memo.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with contextlib.suppress(FileNotFoundError):
        os.remove(path)
    os.environ["CNR_SCHEDULE_MEMO"] = path


class Keeper:
    """The frames a run checks: a reservoir of ``k - 1`` drawn from the seed
    over every frame of the window, and the frame whose march went deepest."""

    def __init__(self, k: int, rng):
        self.k, self.rng = max(int(k) - 1, 0), rng
        self.slots, self.offers = [], 0
        self.deepest = None

    def offer(self, index: int, steps: int, image, pose):
        item = (index, image, pose, steps)
        if len(self.slots) < self.k:
            self.slots.append(item)
        else:
            j = int(self.rng.integers(0, self.offers + 1))
            if j < self.k:
                self.slots[j] = item
        self.offers += 1
        if self.deepest is None or steps > self.deepest[3]:
            self.deepest = item

    def frames(self) -> list:
        items = {i[0]: i for i in self.slots}
        if self.deepest is not None:
            items[self.deepest[0]] = self.deepest
        return [items[i] for i in sorted(items)]


def render_config(cnr, cfg: dict, tr: dict):
    """The configuration's render settings, the traffic's ``render``
    overrides (``grid_res``, say) and its frame and scene."""
    fields = check.render_fields(cfg, tr)
    fields.update(width=int(tr["width"]), height=int(tr["height"]), scene=tr["scene"])
    return cnr.RenderConfig(**fields).validate()


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t_start: float | None = None, overrides: dict | None = None,
             stand_ins: tuple = ()) -> dict:
    """One run. Returns the result line's fields (``checks`` last).

    ``overrides`` replaces traffic parameters (tests shrink the frame);
    ``stand_ins`` also reads the named stand-ins for the program on the kept
    frames' poses (``check.STAND_INS``: the control, planted faults), under
    ``readings``."""
    t_start = time.perf_counter() if t_start is None else t_start
    c = spec.cell(name)
    cfg, tr, wl = c["config"], dict(c["traffic"]), c["workload"]
    tr.update(overrides or {})
    fresh_memo()
    import cudaneuralrender_torch as cnr

    cnr.reset_schedule_memo()  # a second run in one process learns afresh too
    dev = torch.device(device)
    kind = spec.model(cfg)
    weights = kind.make(cfg, spec.ROOT, seed)
    params = kind.program(cnr, weights, dev)
    rcfg = render_config(cnr, cfg, tr)
    driver = spec.mix(tr["delivery"]).Driver(cnr, params, rcfg, traffic.poses(tr, seed), tr)

    driver.run(seconds=0.0, keeper=None, trace=trace, warm=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start

    keeper = Keeper(wl["check_frames"], traffic.rng_for(seed, "check"))
    win = driver.run(seconds=seconds, keeper=keeper, trace=trace, warm=False)

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kept = [(i, driver.to_bytes(img), pose) for i, img, pose, _ in keeper.frames()]
    del keeper, driver, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    net = kind.reference_net(weights, dev)
    readings = check.compare(net, kept, cfg, tr, device=dev, stand_ins=stand_ins)
    check_s = time.perf_counter() - t_check
    limits = wl["limits"]
    checks = {k: dict(value=readings["program"][k], limit=limits[k]) for k in limits}
    failed = 0  # a frame that raises ends the run
    correct = bool(kept) and all(v["value"] <= v["limit"] for v in checks.values())

    run = dict(setup_s=setup_s, window=win, pixels=int(tr["width"]) * int(tr["height"]),
               slice=win["slice"], work=None)
    if trace and win["slice"] is not None:
        sl = win["slice"]
        poses = sl["poses"][:: max(1, len(sl["poses"]) // int(tr["work_frames"]))]
        poses = poses[: int(tr["work_frames"])]
        run["work"] = work.count_work(
            net, poses, scene=tr["scene"], width=int(tr["width"]),
            height=int(tr["height"]), render=check.render_fields(cfg, tr),
            stride=int(tr["work_pixel_stride"]), rng=traffic.rng_for(seed, "work"),
            device=dev)
        run["work"].update(flops_per_eval=kind.flops_per_eval(cfg),
                           bytes_per_eval=kind.bytes_per_eval(cfg))

    metrics = {}
    for m in (c["per_layer"] if trace else c["end_to_end"]):
        value = spec.reader(m["name"])(run, m["name"])
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])

    result = dict(correct=correct, attempted=len(win["frames"]), failed=failed,
                  metrics=metrics)
    result["device"] = device_info(dev, peak, win["slice"] if trace else None)
    if trace and win["slice"] is not None:
        sl = win["slice"]
        result["breakdown"] = dict(
            device_ops=sl["device_ops"], idle_gaps=sl.get("idle_gaps", []),
            program_idle_gaps=(sl.get("program") or {}).get("idle_gaps"))
    result["window"] = window_summary(win)
    result["check_s"] = check_s
    result["readings"] = readings
    result["checks"] = checks
    return result


def window_summary(win) -> dict:
    """What the window did, for reading a run that reads far off: frames,
    frames off the fast path, the deepest march, the longest gap between
    two completions on the host."""
    frames = win["frames"]
    stats = [f["stats"] for f in frames]
    done = [win["start"]] + sorted({f["done"] for f in frames})
    gaps = [b - a for a, b in zip(done, done[1:])]
    return dict(frames=len(frames), slow_frames=sum(1 for s in stats if not s["fast_path"]),
                deepest_steps=max((s["steps"] for s in stats), default=0),
                longest_wait_s=max(gaps, default=0.0), seconds=win["end"] - win["start"])


def device_info(dev, peak: int, sl) -> dict:
    if dev.type == "cuda":
        info = dict(platform="gpu", kind=torch.cuda.get_device_name(dev), count=1,
                    memory_peak_bytes=int(peak), power_limit=work.power_limit())
    else:
        info = dict(platform="cpu", kind="cpu", count=0, memory_peak_bytes=0)
    if sl is not None:
        info.update(busy_s=sl["busy_s"], window_s=sl["wall_s"])
    return info

