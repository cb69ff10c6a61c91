"""PCA estimator of the port (counterpart of ``raft_tpu/models/pca.py``;
ref: the cuML-style PCA over linalg/pca.cuh, params linalg/
pca_types.hpp; the estimator's shape follows scikit-learn)."""

from __future__ import annotations

from typing import Optional

from raft_tpu_torch.core.resources import DeviceResources
from raft_tpu_torch.linalg.pca import (ParamsPCA, PCAModel, Solver,
                                       pca_fit, pca_fit_distributed,
                                       pca_inverse_transform, pca_transform)


class PCA:
    """``res`` fixes the device of numpy inputs; without it a fit runs
    where X's tensor lies, or on cuda. ``mesh`` makes ``fit`` the
    rows-sharded fit over ``mesh[mesh_axis]`` (``pca_fit_distributed``)."""

    def __init__(self, n_components: int, whiten: bool = False,
                 solver: Solver = Solver.COV_EIG_DC, mesh=None,
                 mesh_axis: str = "x", res: Optional[DeviceResources] = None):
        self.mesh, self.mesh_axis = mesh, mesh_axis
        self.res = res
        self.prms = ParamsPCA(n_components=n_components, whiten=whiten,
                              algorithm=solver)
        self.model: Optional[PCAModel] = None

    def fit(self, X) -> "PCA":
        if self.mesh is not None:
            self.model = pca_fit_distributed(self.res, X, self.prms,
                                             self.mesh, self.mesh_axis)
            return self
        self.model = pca_fit(self.res, X, self.prms)
        return self

    def transform(self, X):
        return pca_transform(self.res, X, self.model, self.prms)

    def fit_transform(self, X):
        return self.fit(X).transform(X)

    def inverse_transform(self, T):
        return pca_inverse_transform(self.res, T, self.model, self.prms)

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

    @property
    def mean_(self):
        return self.model.mu

    @property
    def noise_variance_(self):
        return self.model.noise_vars
