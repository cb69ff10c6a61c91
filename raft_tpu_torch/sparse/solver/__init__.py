"""raft_tpu_torch.sparse.solver — the thick-restart Lanczos eigensolver of
the port (randomized SVD, Cholesky-QR and MST come in a later slice)."""

from raft_tpu_torch.sparse.solver.lanczos import lanczos_compute_eigenpairs
from raft_tpu_torch.sparse.solver.lanczos_types import (LANCZOS_WHICH,
                                                        LanczosSolverConfig)

__all__ = ["LANCZOS_WHICH", "LanczosSolverConfig",
           "lanczos_compute_eigenpairs"]
