"""Row-sharded SpMV and SpMM: the multi-device tier of the sparse solvers.

Counterpart of ``raft_tpu/sparse/sharded.py`` (ref: 1-D row partitioning
of the Lanczos matvec, sparse/solver/detail/lanczos.cuh:248, with the
matvec's blocks gathered). The matrix's rows split into p contiguous
blocks of ``rb`` rows (a multiple of R), each laid out as its own
:class:`~raft_tpu_torch.sparse.tiled.TiledELL` on its rank's device.
:func:`spmv_sharded` / :func:`spmm_sharded` run K6a / K6c
(``ops.spmv.spmv_tiled`` / ``spmm_tiled``) on every block against the
replicated operand, one rank a block in turn
(:func:`~raft_tpu_torch.parallel.for_each_rank`), and concatenate the
blocks. The
reference stacks the blocks on one padded geometry because ``shard_map``
needs equal shards; rank-local blocks need no padding, so each block
keeps its own chunk counts. ``sparse.linalg.spmv`` / ``spmm`` and the
Lanczos solver take the operand as they take a ``TiledELL``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix, to_device
from raft_tpu_torch.resilience import fault_point
from raft_tpu_torch.sparse.tiled import TiledELL, tile_csr


class ShardedTiledELL:
    """p row blocks of one sparse matrix (``blocks[r]`` rows [r·rb,
    (r+1)·rb) as a :class:`TiledELL` on rank r's device) over
    ``mesh[axis]``."""

    def __init__(self, blocks: List[TiledELL], shape: Tuple[int, int],
                 rb: int, mesh, axis: str):
        self.blocks = blocks
        self.shape = tuple(shape)
        self.rb = rb
        self.mesh, self.axis = mesh, axis

    @property
    def n_shards(self) -> int:
        return len(self.blocks)

    @property
    def vals(self) -> torch.Tensor:
        """The first block's values (their dtype is the operand's)."""
        return self.blocks[0].vals

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    @property
    def nnz(self) -> int:
        """Pad-inclusive stream size, as ``TiledELL``'s."""
        return sum(b.vals.numel() for b in self.blocks)


def shard_spmv_operand(A, mesh, axis: str = "x", C: int = 512,
                       R: int = 256, E: int = 2048) -> ShardedTiledELL:
    """Split ``A`` (COO/CSR) into ``mesh[axis]`` R-aligned row blocks and
    tile each on its rank's device (reference ``:86``). f32 only: the
    tiled kernels compute in f32, and a silent downcast of an f64 solve
    would break its tolerances."""
    from raft_tpu_torch.parallel.mesh import axis_devices

    expects(axis in mesh.axis_names,
            "shard_spmv_operand: mesh has no axis %s", axis)
    if not isinstance(A, (COOMatrix, CSRMatrix)):
        raise TypeError(f"shard_spmv_operand: expected a sparse matrix, "
                        f"got {type(A)}")
    A = to_device(A)
    if A.values.element_size() > 4:
        raise ValueError(
            "shard_spmv_operand: tiled kernels compute in f32; cast the "
            "matrix explicitly (or run the single-device CSR path for "
            "f64 solves)")
    if isinstance(A, CSRMatrix):
        rows, cols = A.row_ids(), A.indices
    else:
        rows, cols = A.rows, A.cols
    vals = A.values
    n_rows, n_cols = A.shape
    devs = axis_devices(mesh, axis)
    rb = max(R, -(-n_rows // (len(devs) * R)) * R)
    blocks = []
    for r, dev in enumerate(devs):
        m = (rows >= r * rb) & (rows < (r + 1) * rb)
        part = COOMatrix((rows[m] - r * rb).to(torch.int32),
                         cols[m].to(torch.int32), vals[m].float(),
                         (rb, n_cols))
        blocks.append(tile_csr(part, C=C, R=R, E=E, device=dev))
    return ShardedTiledELL(blocks, (n_rows, n_cols), rb, mesh, axis)


def _per_block(S: ShardedTiledELL, fn, operand):
    from raft_tpu_torch.parallel.mesh import for_each_rank, line_mesh

    outs = for_each_rank(line_mesh(S.mesh, S.axis),
                         lambda t: fn(t, operand.to(t.device)),
                         [(t,) for t in S.blocks])
    dev = S.device
    return torch.cat([o.to(dev) for o in outs])[:S.shape[0]]


def spmv_sharded(S: ShardedTiledELL, x) -> torch.Tensor:
    """y = A @ x: K6a on every row block, the blocks concatenated on the
    first rank's device (reference ``:207``)."""
    from raft_tpu_torch.ops.spmv import spmv_tiled

    fault_point("spmv_sharded")
    x = torch.as_tensor(x).to(S.device, torch.float32)
    return _per_block(S, spmv_tiled, x)


def spmm_sharded(S: ShardedTiledELL, B) -> torch.Tensor:
    """C = A @ B for dense ``B`` [n_cols, kB]: K6c on every row block
    (reference ``:220``)."""
    from raft_tpu_torch.ops.spmv import spmm_tiled

    B = torch.as_tensor(B).to(S.device, torch.float32)
    return _per_block(S, spmm_tiled, B)
