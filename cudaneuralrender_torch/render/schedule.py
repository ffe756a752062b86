"""The staged frame's stats vector and the schedule policy that reads it.

A staged frame reads the host once, for one small int vector: a frame's
``[active, steps, hits, refine_overflow, rung actives...]``, or a shard's
with ``shade_excess`` after the four counts (a band's tail is its rung
actives, a sharded frame's the per-shard block). Every caller builds it
with ``encode``, reads it with ``decode`` and decides with the policy here:
final or not, the retry after a refine-bucket overflow, and the memo of
schedules per (geometry, config), a hint that the retry corrects.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..utils import memo as _memo_store
from ..utils.config import RenderConfig

#: Counts ahead of the tail in the frame layout and in the shard layout.
HEAD, SHARD_HEAD = 4, 5
#: Headroom of caps tuned to one frame's rung counts (and of an overflow's
#: retune), and to a batch's per-rung maximum, which covers its poses.
FRAME_MARGIN, BATCH_MARGIN = 1.35, 1.1


def cap_for(n: int, div: int, cap_abs: int, config: RenderConfig) -> int:
    """Lane cap of one refine rung: the tuned cap when the config carries
    one (scaled to this bundle's ``n``), else n//div; floored at
    compact_min."""
    if cap_abs:
        cap = cap_abs if n == config.num_rays else -(-cap_abs * n // config.num_rays)
        return max(min(cap, n), config.compact_min)
    return max(n // div, config.compact_min)


def conv_within(config: RenderConfig, n: int | None = None):
    """Bound on where converged lanes can live after the scheduled march: in
    the mixed path every hit lives in the first refine rung's bucket."""
    if config.march_precision != "mixed":
        return None
    if n is None:
        n = config.num_rays
    cap0 = cap_for(
        n, config.refine_schedule[0][0],
        config.refine_caps[0] if config.refine_caps else 0, config,
    )
    return cap0 if cap0 < n else None


def shade_capacity(config: RenderConfig, n: int, within) -> int:
    """Lane count the packed shading shades (and that can hold hits)."""
    if within is not None and within < n:
        return n  # in-place prefix shade: every hit is inside `within`
    return max(n // config.shade_div, config.compact_min)


def encode(active, steps, hits, refine_overflow, tail, *, shade_excess=None) -> torch.Tensor:
    """The vector, of ``active``'s dtype, from the device counts (scalar
    tensors) and ``tail``: the frame layout, or with ``shade_excess`` the
    shard layout."""
    head = [active, steps, hits, refine_overflow]
    if shade_excess is not None:
        head.append(shade_excess)
    return torch.cat([torch.stack([c.to(active.dtype) for c in head]), tail.to(active.dtype)])


class FrameStats(NamedTuple):
    """A fetched vector; ``shade_excess``, hits beyond the shading bucket."""

    active: int
    steps: int
    hits: int
    refine_overflow: int
    shade_excess: int
    rung_actives: tuple

    def record(self, config: RenderConfig, fast_path: bool) -> dict:
        """The ``stats_out`` dict of a staged frame or solve."""
        return dict(rays=config.num_rays, steps=self.steps, hits=self.hits,
                    unresolved=self.active, refine_overflow=self.refine_overflow,
                    fast_path=fast_path)


def decode(stats, config: RenderConfig, *, shard: bool = False) -> FrameStats:
    """A fetched vector of the frame (or with ``shard=True`` the shard)
    layout as ``FrameStats``."""
    st = np.asarray(stats)
    active, steps, hits, ovf = (int(v) for v in st[:HEAD])
    if shard:
        excess, tail = int(st[HEAD]), st[SHARD_HEAD:]
    else:
        n = config.num_rays
        cap = shade_capacity(config, n, conv_within(config))
        excess, tail = (0 if cap >= n else max(hits - cap, 0)), st[HEAD:]
    return FrameStats(active, steps, hits, ovf, excess, tuple(int(v) for v in tail))


# (geometry tag, config) -> the schedule a retry or a final frame's counts taught.
_SCHEDULE_MEMO: dict = {}


def reset_schedule_memo(clear_persisted: bool = False) -> None:
    """Clear the in-process adaptive-schedule memo (and, with
    ``clear_persisted=True``, the cross-process store file)."""
    _SCHEDULE_MEMO.clear()
    _memo_store.reset_store(clear_file=clear_persisted)


def _config_fp(config: RenderConfig) -> str:
    return hashlib.sha1(repr(config).encode()).hexdigest()[:16]


def memo_lookup(params, config: RenderConfig) -> RenderConfig:
    """The schedule a previous frame taught for (geometry, config), or
    ``config`` unchanged. Checks the persistent store for tagged geometries."""
    tag = _memo_store.geom_tag(params)
    hit = _SCHEDULE_MEMO.get((tag, config))
    if hit is not None:
        return hit
    if tag is not None:
        entry = _memo_store.store_get(f"{tag}|{_config_fp(config)}")
        if entry:
            try:
                widened = config.replace(
                    refine_schedule=tuple((int(d), int(s)) for d, s in entry["refine_schedule"]),
                    mid_schedule=tuple((int(d), int(s)) for d, s in entry["mid_schedule"]),
                    refine_caps=tuple(int(c) for c in entry.get("refine_caps", ())),
                )
                widened.validate()
            except (KeyError, TypeError, ValueError):
                return config  # malformed store entry: ignore it
            _SCHEDULE_MEMO[(tag, config)] = widened
            return widened
    return config


def memo_teach(params, orig_config: RenderConfig, widened: RenderConfig) -> None:
    """Record that ``orig_config`` needs ``widened``'s schedules for this
    geometry (following any deeper widening already learned for it)."""
    tag = _memo_store.geom_tag(params)
    final = _SCHEDULE_MEMO.get((tag, widened), widened)
    _SCHEDULE_MEMO[(tag, orig_config)] = final
    if tag is not None:
        _memo_store.store_put(f"{tag}|{_config_fp(orig_config)}", {
            "refine_schedule": [list(r) for r in final.refine_schedule],
            "mid_schedule": [list(r) for r in final.mid_schedule],
            "refine_caps": list(final.refine_caps),
        })


def widen(config: RenderConfig) -> RenderConfig:
    """Every bucket doubled: the rungs' divisors halved, the caps doubled."""
    return config.replace(
        refine_schedule=tuple((max(d // 2, 1), s) for d, s in config.refine_schedule),
        mid_schedule=tuple((max(d // 2, 1), s) for d, s in config.mid_schedule),
        # Caps double alongside, clamped at the image (a cap >= n marches
        # densely and cannot overflow, so widening terminates).
        refine_caps=tuple(min(c * 2, config.num_rays) for c in config.refine_caps),
    )


def tune_caps(config: RenderConfig, rung_actives, *, margin: float = 1.25,
              granule: Optional[int] = None,
              allow_grow: bool = False) -> Optional[RenderConfig]:
    """Shrink the refine ladder's rungs to the measured near-set decay.

    ``rung_actives`` are the entry-active counts of each refine rung
    (``FrameStats.rung_actives``). Caps are actives*margin rounded up to
    ``granule``, never larger than the divisor default (unless
    ``allow_grow``, the overflow recovery mode), floored at compact_min and
    non-increasing down the ladder. Returns the tuned config, or None when
    nothing would shrink or the config is ineligible.
    """
    if (
        not config.adaptive_rungs
        or (config.refine_caps and not allow_grow)
        or config.march_precision != "mixed"
        or len(rung_actives) != len(config.refine_schedule)
    ):
        return None
    n = config.num_rays
    if granule is None:
        granule = 8192 if n >= 8192 * 32 else max(64, n // 32)
    caps, prev, changed = [], n, False
    for (div, _s), a in zip(config.refine_schedule, rung_actives):
        base = max(n // div, config.compact_min)
        want = -(-int(int(a) * margin) // granule) * granule
        cap = max(min(want, prev) if allow_grow else min(want, base, prev),
                  config.compact_min)
        if cap < base:
            changed = True
        caps.append(cap)
        prev = cap
    if not (changed or allow_grow):
        return None
    return config.replace(refine_caps=tuple(caps))


def widen_or_retune(config: RenderConfig, stats: FrameStats) -> RenderConfig:
    """Recovery config after a refine-bucket overflow: resize the caps from
    the overflowing frame's own per-rung counts when that raises them,
    else double every bucket (``widen``, which guarantees termination)."""
    tuned = tune_caps(config.replace(refine_caps=()), stats.rung_actives,
                      margin=FRAME_MARGIN, allow_grow=True)
    if tuned is not None and tuned != config:
        old, new = config.refine_caps, tuned.refine_caps
        if not old or (
            all(b >= a for a, b in zip(new, old))
            and any(b > a for a, b in zip(new, old))
        ):
            return tuned
    return widen(config)


def maybe_tune(params, orig_config: RenderConfig, config: RenderConfig,
               stats: FrameStats) -> None:
    """Teach the memo caps tuned to a final frame's per-rung counts, at
    ``FRAME_MARGIN`` (no-op when the config is ineligible)."""
    tuned = tune_caps(config, stats.rung_actives, margin=FRAME_MARGIN)
    if tuned is not None:
        memo_teach(params, orig_config, tuned)


def maybe_tune_batch(params, orig_config: RenderConfig, config: RenderConfig,
                     batch: Sequence[FrameStats]) -> None:
    """``maybe_tune`` for a batch of final frames: their per-rung maximum,
    at ``BATCH_MARGIN``."""
    tuned = batch and tune_caps(config, np.max([s.rung_actives for s in batch], axis=0),
                                margin=BATCH_MARGIN)
    if tuned:
        memo_teach(params, orig_config, tuned)


def schedule_ok(stats: FrameStats, config: RenderConfig) -> bool:
    """True iff the staged march's result is final (no overflow retry, no
    continuation, no dense fallback needed)."""
    if stats.refine_overflow > 0:
        return False
    if stats.active == 0:
        return True
    # Active rays with steps exhausted are acceptable in mixed mode
    # (silhouette tolerance); "full" must re-render densely.
    return stats.steps >= config.max_steps and config.march_precision == "mixed"


def check_fast(stats: FrameStats, config: RenderConfig) -> bool:
    """True iff a staged frame (or shard set) is final: its march is
    (``schedule_ok``) and its shading bucket held every hit."""
    return schedule_ok(stats, config) and stats.shade_excess == 0
