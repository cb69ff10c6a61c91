"""raft_tpu_torch.sparse — sparse formats, layouts, linalg and the Lanczos
solver of the port (the sharded operand comes in a later slice)."""

from raft_tpu_torch.core.sparse_types import (COOMatrix, COOStructure,
                                              CSRMatrix, CSRStructure)
from raft_tpu_torch.sparse import convert, linalg, matrix, op, solver
from raft_tpu_torch.sparse.linalg import prepare_sddmm, prepare_spmv
from raft_tpu_torch.sparse.tiled import TiledELL, TiledPairs, TiledPairsSpmv

__all__ = [
    "COOMatrix", "COOStructure", "CSRMatrix", "CSRStructure", "TiledELL",
    "TiledPairs", "TiledPairsSpmv", "convert", "linalg", "matrix", "op",
    "prepare_sddmm", "prepare_spmv", "solver",
]
