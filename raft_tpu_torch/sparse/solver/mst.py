"""Minimum spanning tree or forest (Borůvka) of the port (counterpart of
``raft_tpu/sparse/solver/mst.py``; ref: cpp/include/raft/sparse/solver/
mst.cuh:38 ``mst()`` returning ``Graph_COO``, mst_solver.cuh:32).

Each Borůvka round runs on the edges' device: one lexicographic rank of
every edge within its source component picks each component's lightest
outgoing edge. torch has no ``lexsort``, so the rank is four stable sorts,
least significant key first, which orders as the reference's
``jnp.lexsort((u_hi, u_lo, wk, csrc))``: equal weights pick the same
edges. The picked edges are merged on the host by min-label propagation
with pointer jumping, as the reference does; O(log n) rounds.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import input_device
from raft_tpu_torch.core.sparse_types import (COOMatrix, CSRMatrix,
                                              sparse_arrays, to_device)


class GraphCOO(NamedTuple):
    """(ref: solver/mst_solver.cuh ``Graph_COO``)"""

    src: torch.Tensor
    dst: torch.Tensor
    weights: torch.Tensor
    n_edges: int


class MSTResult(NamedTuple):
    mst: GraphCOO
    color: torch.Tensor       # each vertex's final component label


def _lexsort(keys):
    """The permutation that sorts by ``keys[-1]``, then ``keys[-2]``, …,
    ties kept in index order (``np.lexsort``'s order): stable sorts of the
    keys, least significant first."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in keys:
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def _min_outgoing(color, src, dst, w):
    """Each component's lightest outgoing edge, ties broken on the
    undirected key (min(u, v), max(u, v)) so both endpoints' components
    rank one physical edge alike. Returns (edge index, component) per
    winner slot, −1 where there is none."""
    csrc = color[src]
    wk = torch.where(csrc != color[dst], w, torch.full_like(w, float("inf")))
    u_lo = torch.minimum(src, dst)
    u_hi = torch.maximum(src, dst)
    order = _lexsort((u_hi, u_lo, wk, csrc))
    s_comp = csrc[order]
    first = torch.ones_like(s_comp, dtype=torch.bool)
    first[1:] = s_comp[1:] != s_comp[:-1]
    valid = first & torch.isfinite(wk[order])
    return (torch.where(valid, order, -1),
            torch.where(valid, s_comp.long(), -1))


def mst(res, G: Union[COOMatrix, CSRMatrix],
        initial_colors=None) -> MSTResult:
    """The minimum spanning tree or forest of a symmetric weighted graph,
    on G's device (the handle's when G holds no tensor).
    ``initial_colors`` starts from a partial forest's component labels.
    (ref: sparse/solver/mst.cuh:38 ``mst``)"""
    G = to_device(G, input_device(res, *sparse_arrays(G)))
    if isinstance(G, CSRMatrix):
        src, dst, w = G.row_ids(), G.indices, G.values
    else:
        src, dst, w = G.rows, G.cols, G.values
    n = G.shape[0]
    expects(G.shape[0] == G.shape[1], "mst: square adjacency required")
    dev = w.device
    src, dst = src.to(torch.int32), dst.to(torch.int32)
    color = (torch.arange(n, dtype=torch.int32, device=dev)
             if initial_colors is None
             else torch.as_tensor(initial_colors).to(dev, torch.int32))
    picked_src, picked_dst, picked_w = [], [], []
    max_rounds = int(np.ceil(np.log2(max(n, 2)))) + 1
    for _ in range(max_rounds):
        winners, _ = _min_outgoing(color, src.long(), dst.long(), w)
        edge_ids = winners[winners >= 0]
        if edge_ids.numel() == 0:
            break
        e_src = src[edge_ids].cpu().numpy()
        e_dst = dst[edge_ids].cpu().numpy()
        e_w = w[edge_ids].cpu().numpy()
        col = color.cpu().numpy()
        cu, cv = col[e_src], col[e_dst]
        # one copy of each edge two components picked from both sides
        pair_key = (np.minimum(cu, cv).astype(np.int64) * n
                    + np.maximum(cu, cv))
        _, keep = np.unique(pair_key, return_index=True)
        e_src, e_dst, e_w = e_src[keep], e_dst[keep], e_w[keep]
        picked_src.append(e_src)
        picked_dst.append(e_dst)
        picked_w.append(e_w)
        # union: min-label propagation over the picked edges, pointer
        # jumping to a fixpoint (one min scatter loses chain merges)
        cu, cv = col[e_src], col[e_dst]
        lbl = np.arange(n, dtype=col.dtype)
        while True:
            before = lbl.copy()
            m = np.minimum(lbl[cu], lbl[cv])
            np.minimum.at(lbl, cu, m)
            np.minimum.at(lbl, cv, m)
            while True:
                nxt = lbl[lbl]
                if (nxt == lbl).all():
                    break
                lbl = nxt
            if (lbl == before).all():
                break
        color = torch.from_numpy(lbl[col]).to(dev)
    if picked_src:
        out = [torch.from_numpy(np.concatenate(p)).to(dev)
               for p in (picked_src, picked_dst, picked_w)]
    else:
        out = [torch.zeros(0, dtype=torch.int32, device=dev),
               torch.zeros(0, dtype=torch.int32, device=dev),
               torch.zeros(0, dtype=w.dtype, device=dev)]
    src_o, dst_o, w_o = out
    return MSTResult(GraphCOO(src_o.to(torch.int32), dst_o.to(torch.int32),
                              w_o, int(src_o.shape[0])), color)
