"""raft_tpu_torch.sparse.solver — the sparse solvers of the port: the
thick-restart Lanczos eigensolver, Cholesky-QR, the randomized sparse SVD
and the minimum spanning tree (Borůvka)."""

from raft_tpu_torch.sparse.solver.cholesky_qr import cholesky_qr, cholesky_qr2
from raft_tpu_torch.sparse.solver.lanczos import lanczos_compute_eigenpairs
from raft_tpu_torch.sparse.solver.lanczos_types import (LANCZOS_WHICH,
                                                        LanczosSolverConfig)
from raft_tpu_torch.sparse.solver.mst import GraphCOO, MSTResult, mst
from raft_tpu_torch.sparse.solver.randomized_svds import (SvdsConfig,
                                                          randomized_svds,
                                                          sign_correction)

__all__ = ["LANCZOS_WHICH", "LanczosSolverConfig",
           "lanczos_compute_eigenpairs", "cholesky_qr", "cholesky_qr2",
           "SvdsConfig", "randomized_svds", "sign_correction", "GraphCOO",
           "MSTResult", "mst"]
