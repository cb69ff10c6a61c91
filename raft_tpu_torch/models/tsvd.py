"""TruncatedSVD estimator of the port (counterpart of
``raft_tpu/models/tsvd.py``; ref: the linalg/tsvd.cuh pipeline)."""

from __future__ import annotations

from typing import Optional

from raft_tpu_torch.core.resources import DeviceResources
from raft_tpu_torch.linalg.pca import Solver, not_ported
from raft_tpu_torch.linalg.tsvd import (ParamsTSVD, TSVDModel, tsvd_fit,
                                        tsvd_inverse_transform,
                                        tsvd_transform)


class TruncatedSVD:
    """``res`` fixes the device of numpy inputs; ``mesh`` (the
    rows-sharded fit) is not in the port yet and raises."""

    def __init__(self, n_components: int, solver: Solver = Solver.COV_EIG_DC,
                 mesh=None, mesh_axis: str = "x",
                 res: Optional[DeviceResources] = None):
        if mesh is not None:
            not_ported("TruncatedSVD: mesh=")
        self.res = res
        self.prms = ParamsTSVD(n_components=n_components, algorithm=solver)
        self.model: Optional[TSVDModel] = None

    def fit(self, X) -> "TruncatedSVD":
        self.model = tsvd_fit(self.res, X, self.prms)
        return self

    def transform(self, X):
        return tsvd_transform(self.res, X, self.model)

    def fit_transform(self, X):
        return self.fit(X).transform(X)

    def inverse_transform(self, T):
        return tsvd_inverse_transform(self.res, T, self.model)

    @property
    def components_(self):
        return self.model.components

    @property
    def explained_variance_(self):
        return self.model.explained_var

    @property
    def explained_variance_ratio_(self):
        return self.model.explained_var_ratio

    @property
    def singular_values_(self):
        return self.model.singular_vals
