"""Geometry tags + the persistent adaptive-schedule store.

The staged renderer's adaptive-schedule memo (render/schedule.py
``_SCHEDULE_MEMO``) learns, per (geometry, config), the refine schedule a
refine-bucket overflow (or a successful frame's per-rung stats) proved
right. Two pieces live here so the renderer and the checkpoint loader can
share them without import cycles:

  * a **geometry tag registry**: ``checkpoint.load`` tags each loaded model
    with its file path, so the memo keys on geometry identity instead of
    config alone;
  * a **persistent store** (one small JSON file): learned schedules are
    remembered across processes.

The store is purely a performance hint — a stale or wrong entry only
dispatches a schedule the overflow retry would correct anyway, never a
wrong image. This package keeps its own store file: schedules learned on
another device and framework are not evidence for this one.
"""
from __future__ import annotations

import json
import os
import tempfile
import weakref
from typing import Optional

# id(leading weight tensor) -> (weakref-or-None, tag). The weakref validates
# identity against id() reuse after GC; a failed validation only loses the
# tag (config-keyed memoization still applies), never correctness.
_TAGS: dict = {}


def tag_geometry(params, tag: str) -> None:
    """Associate a stable identity string with an MLP (by the object
    identity of its first weight tensor). Called by checkpoint.load with the
    model file's path; callers with in-memory models may tag manually."""
    try:
        lead = params[0].w
    except (TypeError, IndexError, AttributeError):
        return
    try:
        ref = weakref.ref(lead)
    except TypeError:
        ref = None
    _TAGS[id(lead)] = (ref, str(tag))


def geom_tag(params) -> Optional[str]:
    """The tag registered for this MLP, or None (untagged/stale)."""
    try:
        lead = params[0].w
    except (TypeError, IndexError, AttributeError):
        return None
    ent = _TAGS.get(id(lead))
    if ent is None:
        return None
    ref, tag = ent
    if ref is not None and ref() is not lead:
        del _TAGS[id(lead)]  # id reused by a different tensor
        return None
    return tag


def _store_path() -> Optional[str]:
    """Path of the persistent schedule store.

    Override with CNR_SCHEDULE_MEMO (empty string disables persistence).
    Default: ``.cnr_cache/schedule_memo_torch.json`` beside the package's
    repo root — kept out of version control.
    """
    p = os.environ.get("CNR_SCHEDULE_MEMO")
    if p is not None:
        return p or None
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, ".cnr_cache", "schedule_memo_torch.json")


_STORE: Optional[dict] = None

#: (tag, config) keys whose rank-0 entry this process has received in a
#: broadcast to every rank of a process world.
BROADCAST_DONE: set = set()


def _load_store() -> dict:
    global _STORE
    if _STORE is None:
        _STORE = {}
        path = _store_path()
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
                if isinstance(data, dict):
                    _STORE = data
            except (OSError, ValueError):
                pass  # corrupt cache == empty cache
    return _STORE


def store_get(key: str) -> Optional[dict]:
    return _load_store().get(key)


def store_put(key: str, value: dict) -> None:
    store = _load_store()
    if store.get(key) == value:
        return
    store[key] = value
    path = _store_path()
    if not path:
        return
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
        with os.fdopen(fd, "w") as f:
            json.dump(store, f)
        os.replace(tmp, path)  # atomic vs concurrent readers
    except OSError:
        pass  # persistence is best-effort


def reset_store(clear_file: bool = False) -> None:
    """Forget the in-process store cache (and optionally the file), and
    which entries were broadcast across processes (``BROADCAST_DONE``)."""
    global _STORE
    _STORE = None
    BROADCAST_DONE.clear()
    if clear_file:
        path = _store_path()
        if path and os.path.exists(path):
            os.remove(path)
