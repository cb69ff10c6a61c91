"""Shared compare/select fold of certified selection (counterpart of
``raft_tpu/ops/folds.py``): compress [B, S] slot minima into per-group
(top-2 values and ids, 3rd-min) with compare/selects, no sort. The 3rd-min
feeds the exactness certificate: a group's hidden entries are ≥ it once
its top-2 are pooled."""

from __future__ import annotations

import torch


def fold_group_top2(vals, ids, g: int):
    """[B, S] → per-group-of-g ``(a1, id1, a2, id2, a3)``, each [B, S/g];
    groups are contiguous runs of ``g`` slots. ``g`` is clamped to S and
    must then divide S. The reference's compare/select order: strict <,
    and a1 by a NaN-propagating minimum."""
    B, S = vals.shape
    g = min(g, S)
    G = S // g
    v = vals.reshape(B, G, g)
    pid = ids.reshape(B, G, g).to(torch.int32)
    a1 = vals.new_full((B, G), float("inf"))
    a2, a3 = a1.clone(), a1.clone()
    id1 = torch.full((B, G), -1, dtype=torch.int32, device=vals.device)
    id2 = id1.clone()
    for r in range(g):
        c = v[:, :, r]
        cid = pid[:, :, r]
        lt1 = c < a1
        lt2 = c < a2
        lt3 = c < a3
        a3 = torch.where(lt2, a2, torch.where(lt3, c, a3))
        id2 = torch.where(lt1, id1, torch.where(lt2, cid, id2))
        a2 = torch.where(lt1, a1, torch.where(lt2, c, a2))
        id1 = torch.where(lt1, cid, id1)
        a1 = torch.minimum(a1, c)
    return a1, id1, a2, id2, a3
