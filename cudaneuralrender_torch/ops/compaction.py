"""Active-ray compaction: sort-based packing and the slow path's scatter.

The PyTorch counterpart of the JAX package's ``ops/compaction.py``. The
staged renderer keeps per-ray state in one reorderable bundle: a stable
sort on the active mask packs the actives into a dense prefix, and a sort
on the carried original position restores image order.

Keys are int64, so the difficulty order needs neither the JAX package's
int32 composite-key fallback nor its clip of order keys to [0, 254]: above
254 this package keeps the finer order. For keys in [0, 254] the
permutation equals the JAX package's.
"""
from __future__ import annotations

from typing import Tuple

import torch

# Sorts after every clamped order key (order keys are step counts).
_INACTIVE_KEY = 1 << 62


def capacity_bucket(count: int, minimum: int = 256) -> int:
    """Smallest power of two >= ``count`` (and >= ``minimum``)."""
    cap = max(int(minimum), 1)
    while cap < count:
        cap *= 2
    return cap


def capacity_bucket_of(count: int, total: int, minimum: int = 8192) -> int:
    """Coarse capacity bucket: total / 4^k, the largest shrink that still
    holds ``count`` (floored at ``minimum``)."""
    cap = int(total)
    floor = max(int(minimum), 1)
    while cap // 4 >= max(int(count), floor):
        cap //= 4
    return min(cap, total)


def capacity_pow2_of(count: int, total: int, minimum: int = 8192,
                     headroom: float = 1.25) -> int:
    """Snug power-of-2 capacity holding ``count`` with ``headroom`` slack
    (floored at ``minimum``, capped at ``total``). Finer than
    ``capacity_bucket_of``'s powers of 4: the training step's grad bucket
    (diff/losses.pixel_loss ``compact_cap``) costs in proportion to it."""
    need = max(int(count * headroom), int(minimum), 1)
    cap = 1 << (need - 1).bit_length()
    return min(cap, int(total))


def compact_indices(mask: torch.Tensor, capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of True lanes packed into a dense [capacity] prefix.

    Returns (indices [capacity] int64, valid [capacity] bool). Lanes beyond
    the true count point at slot 0 with valid=False (gathers are harmless,
    scatters masked)."""
    n = mask.shape[0]
    mask_i = mask.to(torch.int64)
    slots = torch.cumsum(mask_i, 0) - mask_i  # exclusive scan
    count = mask_i.sum()
    src = torch.arange(n, dtype=torch.int64, device=mask.device)
    dest = torch.where(mask & (slots < capacity), slots, torch.full_like(slots, capacity))
    indices = torch.zeros(capacity + 1, dtype=torch.int64, device=mask.device)
    indices[dest] = src  # overflow and inactive lanes land in the dropped dump slot
    valid = torch.arange(capacity, device=mask.device) < count
    return indices[:capacity], valid


def _pack_key(mask: torch.Tensor, order) -> torch.Tensor:
    if order is None:
        return (~mask).to(torch.int64)
    return torch.where(mask, torch.clamp(order.to(torch.int64), min=0),
                       torch.full_like(mask, _INACTIVE_KEY, dtype=torch.int64))


def sort_pack_leaves(mask: torch.Tensor, leaves, within: int | None = None, order=None):
    """Reorder every leaf so mask-True lanes form a dense prefix (stable:
    image order is kept within each group).

    ``order`` (optional int [N]): secondary ascending sort among mask-True
    lanes (difficulty-ordered packing); inactive lanes still sort after
    every active lane.

    ``within``: only the first ``within`` lanes are reordered (the caller
    guarantees mask is False beyond them); the suffix passes through.
    """
    n = mask.shape[0]
    if within is None or within >= n:
        perm = torch.sort(_pack_key(mask, order), stable=True).indices
        return tuple(l[perm] for l in leaves)
    head_order = None if order is None else order[:within]
    perm = torch.sort(_pack_key(mask[:within], head_order), stable=True).indices
    return tuple(torch.cat([l[:within][perm], l[within:]]) for l in leaves)


def sort_restore_leaves(pos: torch.Tensor, leaves):
    """Undo any number of ``sort_pack_leaves`` reorderings in one sort: key
    on the carried original-position payload (a permutation)."""
    perm = torch.sort(pos.to(torch.int64), stable=True).indices
    return tuple(l[perm] for l in leaves)


def gather_state(tree, indices: torch.Tensor):
    """The rows ``indices`` of every [N, ...] tensor of ``tree``: a tensor,
    or a tuple or NamedTuple of them (nested), returned in the same
    structure."""
    if isinstance(tree, torch.Tensor):
        return tree[indices]
    leaves = [gather_state(v, indices) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple
        return type(tree)(*leaves)
    return type(tree)(leaves)


def scatter_state(full_tree, compact_tree, indices: torch.Tensor, valid: torch.Tensor):
    """Scatter compacted leaves back into copies of the full-size leaves
    (valid lanes only); the inputs are not modified."""
    out = []
    idx = indices[valid]
    for full, comp in zip(full_tree, compact_tree):
        full = full.clone()
        full[idx] = comp[valid]
        out.append(full)
    return tuple(out)
