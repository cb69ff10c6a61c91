"""raft_tpu_torch.runtime — serving entry points of the port (only
``knn_query`` so far; the Lanczos, randomized SVD and R-MAT entries of the
reference come later)."""

from raft_tpu_torch.runtime.entry_points import knn_query

__all__ = ["knn_query"]
