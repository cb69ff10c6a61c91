"""raft_tpu_torch.spectral — spectral operators, partition analysis and
spectral embedding of the port."""

from raft_tpu_torch.spectral.analysis import (analyze_modularity,
                                              analyze_partition,
                                              fit_embedding)
from raft_tpu_torch.spectral.matrix_wrappers import (LaplacianMatrix,
                                                     ModularityMatrix,
                                                     SparseMatrix)

__all__ = ["LaplacianMatrix", "ModularityMatrix", "SparseMatrix",
           "analyze_modularity", "analyze_partition", "fit_embedding"]
