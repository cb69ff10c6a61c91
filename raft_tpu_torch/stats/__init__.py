"""raft_tpu_torch.stats — statistics and model metrics of the port
(counterpart of ``raft_tpu.stats``; ref: cpp/include/raft/stats). The
histogram's Blocked strategy is K9; the embedding metrics reach K8
through ``pairwise_distance``."""

from raft_tpu_torch.stats.moments import (
    sum_stat,
    mean,
    mean_center,
    mean_add,
    vars_,
    stddev,
    meanvar,
    weighted_mean,
    cov,
    minmax,
)
from raft_tpu_torch.stats.histogram import (
    HistType,
    IdentityBinner,
    histogram,
    value_histogram,
)
from raft_tpu_torch.stats.metrics import (
    accuracy,
    r2_score,
    RegressionMetrics,
    regression_metrics,
    mean_squared_error,
)
from raft_tpu_torch.stats.cluster import (
    contingency_matrix,
    get_contingency_matrix_shape,
    rand_index,
    adjusted_rand_index,
    entropy,
    mutual_info_score,
    homogeneity_score,
    completeness_score,
    v_measure,
    kl_divergence,
)
from raft_tpu_torch.stats.embed import (
    silhouette_score,
    silhouette_score_batched,
    trustworthiness_score,
    neighborhood_recall,
)
from raft_tpu_torch.stats.model_select import (
    dispersion,
    IC_Type,
    information_criterion_batched,
)

__all__ = [
    "sum_stat", "mean", "mean_center", "mean_add", "vars_", "stddev",
    "meanvar", "weighted_mean", "cov", "minmax",
    "HistType", "IdentityBinner", "histogram", "value_histogram",
    "accuracy", "r2_score", "RegressionMetrics", "regression_metrics",
    "mean_squared_error",
    "contingency_matrix", "get_contingency_matrix_shape", "rand_index",
    "adjusted_rand_index", "entropy", "mutual_info_score",
    "homogeneity_score", "completeness_score", "v_measure", "kl_divergence",
    "silhouette_score", "silhouette_score_batched", "trustworthiness_score",
    "neighborhood_recall",
    "dispersion", "IC_Type", "information_criterion_batched",
]
