"""raft_tpu_torch.distance — pairwise distances (all 19 metrics, K8 for
the unexpanded ones), fused L2-NN and brute-force KNN of the port (the
sharded functions of the reference come in a later slice)."""

from raft_tpu_torch.distance.fused_l2nn import (
    fused_l2_nn,
    fused_l2_nn_argmin,
    knn,
)
from raft_tpu_torch.distance.knn_fused import (DB_DTYPES, KnnIndex,
                                               pad_query_rows,
                                               prepare_knn_index,
                                               resolve_db_dtype)
from raft_tpu_torch.distance.pairwise import pairwise_distance
from raft_tpu_torch.distance.types import METRIC_NAMES, DistanceType

__all__ = ["fused_l2_nn", "fused_l2_nn_argmin", "knn", "DB_DTYPES",
           "KnnIndex", "pad_query_rows", "prepare_knn_index",
           "resolve_db_dtype", "pairwise_distance", "DistanceType",
           "METRIC_NAMES"]
