"""Chunked-merge select_k (counterpart of
``raft_tpu/matrix/select_k_chunked.py``): each row is cut into ``nc``
chunks, the top-k of every chunk is taken (a chunk holds at most k of the
row's top-k, so nothing is lost), and the ``nc·k`` survivors are merged by
one narrow top-k. Exact, plain torch; the reference has no kernel here."""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.matrix.select_k_slotted import lax_top_k
from raft_tpu_torch.observability.spans import instrument
from raft_tpu_torch.resilience.faults import fault_point


def _chunked_select_min(vals, k: int, nc: int):
    """Exact k smallest per row with positions, via per-chunk top-k +
    merge. ``vals`` [B, L] f32; returns (values ascending, positions)."""
    B, L = vals.shape
    Lc = -(-L // nc)
    pad = nc * Lc - L
    if pad:
        vals = torch.cat([vals, vals.new_full((B, pad), float("inf"))], 1)
    kc = min(k, Lc)
    neg, pos = lax_top_k(-vals.reshape(B * nc, Lc), kc)        # [B·nc, kc]
    base = (torch.arange(nc, device=vals.device) * Lc)[None, :, None]
    gpos = pos.reshape(B, nc, kc) + base
    cand_v = (-neg).reshape(B, nc * kc)
    cand_p = gpos.reshape(B, nc * kc)
    negk, sel = lax_top_k(-cand_v, k)
    return -negk, torch.gather(cand_p, 1, sel).to(torch.int32)


def chunked_envelope(length: int, nc: int = 8) -> bool:
    """Shape envelope of :func:`select_k_chunked` (the one definition the
    dispatch checks)."""
    return length >= 2 * nc


@instrument("matrix.select_k_chunked")
def select_k_chunked(in_val, in_idx, k: int, select_min: bool,
                     nc: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact chunked-merge select_k. Keys are compared in f32 — exact for
    f32/bf16/f16; wider or integer keys raise ``NotImplementedError``, as
    does a row shorter than 2·nc. Values are gathered from the input,
    keeping its dtype; ``in_idx`` None returns positions."""
    fault_point("select_k_chunked")
    from raft_tpu_torch.matrix.select_k_types import f32_comparable_keys

    if not f32_comparable_keys(in_val.dtype):
        raise NotImplementedError(
            f"chunked select_k: f32/bf16/f16 keys only, got {in_val.dtype}")
    B, L = in_val.shape
    if not chunked_envelope(L, nc):
        raise NotImplementedError(
            f"chunked select_k: len={L} too short for nc={nc}")
    work = in_val.float()
    if not select_min:
        work = -work
    _, out_pos = _chunked_select_min(work, k, nc)
    safe = out_pos.long().clamp(0, L - 1)
    out_v = torch.gather(in_val, 1, safe)
    out_idx = out_pos if in_idx is None else torch.gather(in_idx, 1, safe)
    return out_v, out_idx
