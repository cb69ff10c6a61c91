"""raft_tpu_torch.distance — fused L2-NN and brute-force KNN of the port
(the sharded functions of the reference come in a later slice)."""

from raft_tpu_torch.distance.fused_l2nn import (
    fused_l2_nn,
    fused_l2_nn_argmin,
    knn,
)
from raft_tpu_torch.distance.knn_fused import KnnIndex, prepare_knn_index

__all__ = ["fused_l2_nn", "fused_l2_nn_argmin", "knn", "KnnIndex",
           "prepare_knn_index"]
