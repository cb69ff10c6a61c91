"""The tiled contraction substrate of the port (counterpart of
``raft_tpu/linalg/contractions.py``; ref: cpp/include/raft/linalg/
contractions.cuh ``KernelPolicy``).

The policy is a workspace-budgeted tile plan; each tile's inner product is
one ``torch.matmul`` in f32 (TF32 off), as the reference leaves it to XLA
outside any Pallas kernel, followed by the caller's epilogue.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch.core.resources import (DeviceResources, as_tensors,
                                           ensure_resources)


class KernelPolicy:
    """Row and column tile extents. (ref: contractions.cuh
    ``KernelPolicy``)"""

    def __init__(self, m_tile: int = 1024, n_tile: int = 8192):
        self.m_tile = int(m_tile)
        self.n_tile = int(n_tile)

    @classmethod
    def from_workspace(cls, res, n_cols: int, bytes_per_elem: int = 4
                       ) -> "KernelPolicy":
        """Column tiles sized to the handle's ``allocation_limit``."""
        budget = ensure_resources(res).allocation_limit
        n_tile = max(128, min(8192, budget // (2 * bytes_per_elem
                                               * max(n_cols, 1))))
        return cls(m_tile=1024, n_tile=n_tile)


def tiled_contraction(res, x, y, epilogue: Callable,
                      policy: Optional[KernelPolicy] = None,
                      accumulate: Optional[Callable] = None, init=None):
    """``epilogue(x_tile · y_tileᵀ, x_tile, y_tile)`` over row tiles of x
    and column tiles of y, folded with ``accumulate(acc, out, m0, n0)``
    from ``init`` (or concatenated into one matrix when None)."""
    x, y = as_tensors(res, x, y)
    if policy is None:
        if res is None and x.device.type == "cpu":
            res = DeviceResources(device="cpu")   # CPU tensors stay there
        policy = KernelPolicy.from_workspace(res, x.shape[1])
    outs = []
    acc = init
    for m0 in range(0, x.shape[0], policy.m_tile):
        xt = x[m0:m0 + policy.m_tile]
        row_outs = []
        for n0 in range(0, y.shape[0], policy.n_tile):
            yt = y[n0:n0 + policy.n_tile]
            ip = torch.matmul(xt.float(), yt.float().T)
            out = epilogue(ip, xt, yt)
            if accumulate is None:
                row_outs.append(out)
            else:
                acc = accumulate(acc, out, m0, n0)
        if accumulate is None:
            outs.append(torch.cat(row_outs, dim=1))
    if accumulate is None:
        return torch.cat(outs, dim=0)
    return acc
