"""Key-value pair for argmin-style reductions (counterpart of
``raft_tpu/core/kvp.py``; ref: cpp/include/raft/core/kvp.hpp), and the
(value, id) key the port's exact selections rank by."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class KeyValuePair(NamedTuple):
    key: Any
    value: Any


def total_order(v):
    """``v``'s place in IEEE total order (−NaN < −inf < … < −0 < +0 < … <
    +inf < +NaN), as an int64 tensor of its shape, for a floating ``v`` of
    16, 32 or 64 bits; an integer ``v`` is its own order."""
    if not v.dtype.is_floating_point:
        return v.long()
    width = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
        v.element_size()]
    bits = v.contiguous().view(width)
    return torch.where(bits < 0, bits ^ torch.iinfo(width).max,
                       bits).long()


def flip_sign(v):
    """``v`` (f32) with every sign bit flipped: the exact reversal of IEEE
    total order (``total_order(flip_sign(v)) == ~total_order(v)``), and
    its own inverse. The k smallest of it are the k largest of ``v``, as
    ``jax.lax.top_k(−v)`` ranks them on the CPU. Arithmetic negation on
    the card need not flip a zero's or a NaN's sign, so a selection ranks
    this, never ``−v``."""
    return (v.view(torch.int32) ^ -2 ** 31).view(torch.float32)


def order_key(v, ids=None, descending: bool = False):
    """A unique int64 key for each entry of ``v`` [B, n] (a type of at
    most 32 bits): its :func:`total_order` (reversed when ``descending``)
    in the high word and its id in the low word (``ids`` [B, n], or the
    position when None). An ascending ``torch.topk`` or sort of the key
    ranks the values with exact ties at the lower id, whatever algorithm
    it picks for the shape."""
    if v.element_size() > 4:
        raise ValueError(f"order_key: {v.dtype} leaves no room for the id; "
                         f"rank it by a stable sort of total_order")
    key = total_order(v)
    if descending:
        key = ~key
    key <<= 32                    # in place: the key is [B, n] int64
    if ids is None:
        key |= torch.arange(v.shape[1], device=v.device)
    else:
        key |= ids.long() & 0xFFFFFFFF
    return key


def smallest_by_key(v, k: int, descending: bool = False):
    """The k smallest of ``v`` [B, n] in :func:`order_key` order (the k
    largest when ``descending``) — exact ties at the lower position, as
    ``jax.lax.top_k(−v, k)`` (``jax.lax.top_k(v, k)``) — by one int64
    top-k over the key; a 64-bit ``v`` by a stable sort of its
    :func:`total_order`. Returns (values, positions int64)."""
    if v.element_size() > 4:
        order = total_order(v)
        if descending:
            order = ~order
        pos = torch.sort(order, dim=1, stable=True).indices[:, :k]
    else:
        _, pos = torch.topk(order_key(v, descending=descending), k, dim=1,
                            largest=False, sorted=True)
    return torch.gather(v, 1, pos), pos


def ranked_head(v, k: int, keep: int = 0):
    """The k + ``keep`` smallest of ``v`` [B, n] (f32) by one f32
    ``torch.topk``, in :func:`order_key` order, and the rows whose first k
    may not be :func:`smallest_by_key`'s. That top-k picks an arbitrary
    member of a tie and ranks every NaN last: it takes one value past the
    k + keep, puts them in key order, and marks the rows where that value
    equals the k-th (a tie from inside the first k to past the cut) or
    that hold a NaN anywhere (a −NaN ranks first in total order; the
    row's sum is then NaN). In every other row the first k are exact and
    the ``keep`` after them rank after them. No host round trip. Returns
    (values, positions int64, unsure [B] bool)."""
    n = v.shape[1]
    m = min(k + keep, n)
    vals, pos = torch.topk(v, min(m + 1, n), dim=1, largest=False,
                           sorted=True)
    unsure = torch.isnan(v.sum(1))
    if m < n:
        unsure |= vals[:, m] == vals[:, k - 1]
    vals, pos = vals[:, :m], pos[:, :m]
    _, o = torch.sort(order_key(vals, pos), dim=1)
    return torch.gather(vals, 1, o), torch.gather(pos, 1, o), unsure


def select_smallest(v, k: int):
    """:func:`smallest_by_key` at about the cost of one f32 ``torch.topk``:
    :func:`ranked_head`, with its unsure rows selected again through the
    key. Returns (values ascending, positions int64)."""
    vals, pos, unsure = ranked_head(v, k)
    rows = unsure.nonzero().squeeze(1)
    if rows.numel():
        vals[rows], pos[rows] = smallest_by_key(v[rows], k)
    return vals, pos
