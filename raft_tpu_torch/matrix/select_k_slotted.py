"""Certified slotted select_k (counterpart of
``raft_tpu/matrix/select_k_slotted.py``) — the bandwidth-bound selection.

Each row is folded into per-bucket top-2 and third minima; the k + 32
smallest pooled candidates give the answer, and a per-row certificate
(every non-candidate is ≥ the bound B, and B ≥ θ, the k-th value) proves
it exact. Rows that fail — several of the true top-k in one bucket, or
non-finite values — are re-solved exactly, so the result is always exact;
the slotting only decides how fast.

Rows of 4,096 or more go through K3 (``ops.select_slotted``, a Hopper
kernel on the card): one streaming pass with packed codes, tiles of
``_T_SEL`` columns, ``_TPG_SEL`` tiles a group (one for k > 64). Shorter
rows take the slot fold in plain torch. The constants are the
reference's: the decode and the certificate depend on them.

Selections copy ``jax.lax.top_k``'s order (:func:`lax_top_k`), so rows
with ties, ±inf or NaN give the reference's answer. The reference's
static fallback tiers inside ``lax.cond`` become one read of the failure
count and an exact re-solve of the failed rows.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.kvp import flip_sign, order_key
from raft_tpu_torch.ops.folds import fold_group_top2
from raft_tpu_torch.ops.select_slotted import select_slot_topk_packed
from raft_tpu_torch.observability.spans import instrument
from raft_tpu_torch.resilience.faults import fault_point

_POOL_PAD = 32
# the streaming path's geometry (reference :127-131)
_T_SEL = 8192
_TPG_SEL = 4
_STREAM_MIN_L = 4096


def lax_top_k(v, k: int):
    """``jax.lax.top_k`` on a [B, n] f32 tensor: the k largest per row in
    IEEE total order, ties to the lower position, descending.
    ``torch.topk`` ranks every NaN above +inf and leaves ties unordered;
    this selects by :func:`order_key` so the answer is the reference's.
    Returns (values, positions int64)."""
    _, sel = torch.topk(order_key(v, descending=True), k, dim=1,
                        largest=False, sorted=True)
    return torch.gather(v, 1, sel), sel


def _smallest(v, k: int):
    """The k smallest of ``v`` [B, n] f32 in IEEE total order, ties to the
    lower position: ``jax.lax.top_k(−v, k)``'s ranking, taken as
    :func:`lax_top_k` of the sign-flipped bits (never of ``−v``). The
    values are gathered from ``v`` as bits. Returns (values, positions
    int64)."""
    _, pos = lax_top_k(flip_sign(v), k)
    return _gather_bits(v, pos), pos


def _gather_bits(v, pos):
    return torch.gather(v.view(torch.int32), 1, pos).view(torch.float32)


def _certified_fallback(vals, out_v, out_i, failed, k: int):
    """Re-solve the rows flagged ``failed`` exactly (the reference's
    ``top_k`` on the row) and write them back. Returns (values, positions
    int32, failure count)."""
    n_fail = int(failed.sum())
    if n_fail:
        rows = failed.nonzero().squeeze(1)
        nv, pos = _smallest(vals[rows], k)
        out_v, out_i = out_v.clone(), out_i.clone()
        out_v[rows] = nv
        out_i[rows] = pos.to(out_i.dtype)
    return out_v, out_i, n_fail


def _slotted_select_min(vals, k: int, slot: int, g: int):
    """Exact k smallest per row of ``vals`` [B, L] (L % slot == 0) by the
    slot fold in plain torch: per-slot min / argmin / 2nd-min, per-group
    top-2, a pool and the certificate. Returns (values ascending,
    positions int32, failure count)."""
    B, L = vals.shape
    S = L // slot
    v3 = vals.reshape(B, S, slot)
    m1 = v3.min(dim=2).values
    a1 = v3.argmin(dim=2)
    i1 = (a1 + slot * torch.arange(S, device=vals.device)[None, :]).to(
        torch.int32)
    lane = torch.arange(slot, device=vals.device)
    masked = torch.where(lane[None, None, :] == a1[:, :, None],
                         float("inf"), v3)
    m2 = masked.min(dim=2).values

    p1, pid1, p2, pid2, p3 = fold_group_top2(m1, i1, g)
    pool_v = torch.cat([p1, p2], dim=1)
    pool_i = torch.cat([pid1, pid2], dim=1)
    C = min(k + _POOL_PAD, pool_v.shape[1])
    cand_v, pos = _smallest(pool_v, C)
    cand_i = torch.gather(pool_i, 1, pos)

    theta = cand_v[:, k - 1]
    bound = torch.minimum(m2.min(dim=1).values, p3.min(dim=1).values)
    bound = torch.minimum(bound, cand_v[:, C - 1])
    # NaN-safe: a NaN bound reads as failed; rows with fewer than k
    # finite values (unfilled −1 candidates) re-solve too. A NaN slot
    # minimum loses every compare of the group fold but poisons its a1
    # through the minimum, so the pool can hold a NaN whose id names
    # another entry: such rows re-solve as well (the reference certifies
    # some of them and returns that entry)
    failed = (~(bound >= theta) | (cand_i[:, :k] < 0).any(dim=1)
              | m1.isnan().any(dim=1))
    return _certified_fallback(vals, cand_v[:, :k], cand_i[:, :k], failed,
                               k)


def _slotted_select_min_streamed(work, k: int):
    """Exact k smallest per row of ``work`` [B, L] f32 via K3's packed
    streaming fold and the certified pool selection (reference
    ``_slotted_select_min_pallas``). Returns (values ascending, positions
    int32, failure count)."""
    from raft_tpu_torch.distance.knn_fused import decode_packed_pool

    B, L = work.shape
    _, tpg, _ = slotted_envelope(L, k)
    a1p, a2p, a3p = select_slot_topk_packed(work.contiguous(), T=_T_SEL,
                                            tpg=tpg)
    S_ = a1p.shape[1]
    pool_p = torch.cat([a1p, a2p], dim=1)                  # [B, 2S'] packed
    C = min(k + _POOL_PAD, pool_p.shape[1])
    cand_p, pos = _smallest(pool_p, C)
    pid = decode_packed_pool(cand_p, pos, S_, _T_SEL, tpg)
    # the candidates' true values: packing perturbs only the low mantissa
    # bits used for ordering; the answer's values are the inputs'
    cand_true = torch.gather(work, 1, pid.long().clamp(0, L - 1))
    cand_true = torch.where(pid >= 0, cand_true, float("inf"))
    out_v, ord_k = _smallest(cand_true, k)
    out_i = torch.gather(pid, 1, ord_k)

    # certificate: every non-candidate's packed value ≥ min(group
    # 3rd-mins, C-th pool entry); true ≥ packed − |packed|·2⁻¹⁵. ±inf
    # inputs become NaN once code bits are OR'd in, and that NaN poisons
    # a3p: the NaN-safe predicate sends the row to the exact re-solve
    theta = out_v[:, k - 1]
    b_packed = torch.minimum(a3p.min(dim=1).values, cand_p[:, C - 1])
    b_true = b_packed - b_packed.abs() * 2.0 ** -15
    failed = ~(b_true >= theta) | (out_i < 0).any(dim=1)
    return _certified_fallback(work, out_v, out_i, failed, k)


def slotted_envelope(L: int, k: int = None) -> Tuple[int, int, int]:
    """(slot, g, pool capacity) of the slotted algorithm for row length
    ``L`` (and, on the streaming path, request size ``k``: tpg drops to 1
    for k > 64, so the capacity grows). The one source of the envelope.
    ``k=None`` reports the small-k capacity."""
    if L >= _STREAM_MIN_L:
        tpg = _TPG_SEL if (k is None or k <= 64) else 1
        n_tiles = -(-L // _T_SEL)
        G = -(-n_tiles // tpg)
        return _T_SEL // 128, tpg, 2 * 128 * G
    slot, g = 4, 8
    Lp = -(-L // (slot * g)) * (slot * g)
    S = Lp // slot
    return slot, g, 2 * (S // min(g, S))


@instrument("matrix.select_k_slotted")
def select_k_slotted(in_val, in_idx, k: int, select_min: bool,
                     with_stats: bool = False):
    """select_k by certified slot folding.

    Envelope (``NotImplementedError`` outside, so callers fall back): k ≤
    the pool capacity of :func:`slotted_envelope`, and f32/bf16/f16 keys
    (compared in f32; f64 and integer keys could collide). Values are
    gathered from the input, keeping its dtype; ``in_idx`` None returns
    positions. ``with_stats`` appends the number of rows that failed the
    certificate and were re-solved exactly."""
    fault_point("select_k_slotted")
    from raft_tpu_torch.matrix.select_k_types import f32_comparable_keys

    if not f32_comparable_keys(in_val.dtype):
        raise NotImplementedError(
            f"slotted select_k: f32/bf16/f16 keys only, got {in_val.dtype}")
    B, L = in_val.shape
    slot, g, pool = slotted_envelope(L, k)
    if k > pool:
        raise NotImplementedError(
            f"slotted select_k: k={k} exceeds pool {pool} for len={L}")
    keys = in_val.float()
    work = keys if select_min else flip_sign(keys)
    if L >= _STREAM_MIN_L:
        _, out_pos, n_fail = _slotted_select_min_streamed(work, k)
    else:
        # pad so the slot count is a whole number of groups
        Lp = -(-L // (slot * g)) * (slot * g)
        S = Lp // slot
        if Lp != L:
            work = torch.cat([work, work.new_full((B, Lp - L),
                                                  float("inf"))], dim=1)
        _, out_pos, n_fail = _slotted_select_min(work, k, slot, min(g, S))
    safe = out_pos.long().clamp(0, L - 1)
    out_v = torch.gather(in_val, 1, safe)
    out_idx = out_pos if in_idx is None else torch.gather(in_idx, 1, safe)
    if with_stats:
        return out_v, out_idx, n_fail
    return out_v, out_idx
