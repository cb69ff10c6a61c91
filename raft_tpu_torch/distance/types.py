"""Distance type vocabulary of the port (its own copy of
``raft_tpu/distance/types.py``; ref: the pre-cuVS
``raft::distance::DistanceType`` enum and pylibraft's metric strings)."""

from __future__ import annotations

import enum


class DistanceType(enum.Enum):
    L2Expanded = "l2_expanded"            # squared L2 via the product
    L2SqrtExpanded = "l2_sqrt_expanded"   # L2 via the product
    L2Unexpanded = "l2_unexpanded"        # squared L2 via direct diff
    L2SqrtUnexpanded = "l2_sqrt_unexpanded"
    InnerProduct = "inner_product"
    CosineExpanded = "cosine"
    CorrelationExpanded = "correlation"
    L1 = "l1"
    Linf = "linf"
    LpUnexpanded = "minkowski"
    Canberra = "canberra"
    HammingUnexpanded = "hamming"
    HellingerExpanded = "hellinger"
    JensenShannon = "jensen_shannon"
    KLDivergence = "kl_divergence"
    BrayCurtis = "braycurtis"
    RussellRaoExpanded = "russellrao"
    JaccardExpanded = "jaccard"
    DiceExpanded = "dice"


#: pylibraft-style metric-name strings → enum
METRIC_NAMES = {
    "euclidean": DistanceType.L2SqrtExpanded,
    "sqeuclidean": DistanceType.L2Expanded,
    "l2": DistanceType.L2SqrtExpanded,
    "inner_product": DistanceType.InnerProduct,
    "cosine": DistanceType.CosineExpanded,
    "correlation": DistanceType.CorrelationExpanded,
    "l1": DistanceType.L1,
    "cityblock": DistanceType.L1,
    "manhattan": DistanceType.L1,
    "linf": DistanceType.Linf,
    "chebyshev": DistanceType.Linf,
    "minkowski": DistanceType.LpUnexpanded,
    "canberra": DistanceType.Canberra,
    "hamming": DistanceType.HammingUnexpanded,
    "hellinger": DistanceType.HellingerExpanded,
    "jensenshannon": DistanceType.JensenShannon,
    "kl_divergence": DistanceType.KLDivergence,
    "braycurtis": DistanceType.BrayCurtis,
    "russellrao": DistanceType.RussellRaoExpanded,
    "jaccard": DistanceType.JaccardExpanded,
    "dice": DistanceType.DiceExpanded,
}
