"""raft_tpu_torch.distance — pairwise distances (all 19 metrics, K8 for
the unexpanded ones), fused L2-NN and brute-force KNN of the port, and their sharded forms over
a mesh (``knn_fused_sharded``, ``knn_sharded``, ``knn_index_sharded``)."""

from raft_tpu_torch.distance.fused_l2nn import (
    ShardedKnnIndex,
    fused_l2_nn,
    fused_l2_nn_argmin,
    knn,
    knn_index_sharded,
    knn_sharded,
    prepare_index_sharded,
)
from raft_tpu_torch.distance.knn_fused import (DB_DTYPES, KnnIndex,
                                               pad_query_rows,
                                               prepare_knn_index,
                                               resolve_db_dtype)
from raft_tpu_torch.distance.knn_sharded import (ShardedFusedIndex,
                                                 knn_fused_shard,
                                                 knn_fused_sharded,
                                                 prepare_knn_index_shard,
                                                 prepare_knn_index_sharded)
from raft_tpu_torch.distance.pairwise import pairwise_distance
from raft_tpu_torch.distance.types import METRIC_NAMES, DistanceType

__all__ = ["ShardedKnnIndex", "fused_l2_nn", "fused_l2_nn_argmin", "knn",
           "knn_index_sharded", "knn_sharded", "prepare_index_sharded",
           "ShardedFusedIndex", "knn_fused_shard", "knn_fused_sharded",
           "prepare_knn_index_shard", "prepare_knn_index_sharded", "DB_DTYPES",
           "KnnIndex", "pad_query_rows", "prepare_knn_index",
           "resolve_db_dtype", "pairwise_distance", "DistanceType",
           "METRIC_NAMES"]
