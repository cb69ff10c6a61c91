"""raft_tpu_torch.linalg — dense linear algebra of the port: QR,
eigensolvers, the SVD family, randomized SVD, least squares, the Cholesky
rank-1 update, PCA and truncated SVD. (ref: cpp/include/raft/linalg.) The
reference's elementwise, reduction, norm, matrix-vector, reduce-by-key,
BLAS, transpose, init and contraction modules are not in the port yet
(ROADMAP queue 1, item 13)."""

from raft_tpu_torch.linalg.types import NormType
from raft_tpu_torch.linalg.qr import qr_get_q, qr_get_qr
from raft_tpu_torch.linalg.eig import eig_dc, eig_dc_selective, eig_jacobi
from raft_tpu_torch.linalg.svd import (evaluate_svd_by_percentage, svd_eig,
                                       svd_jacobi, svd_qr,
                                       svd_qr_transpose_right_vec,
                                       svd_reconstruction)
from raft_tpu_torch.linalg.rsvd import (randomized_svd, rsvd_fixed_rank,
                                        rsvd_fixed_rank_symmetric, rsvd_perc)
from raft_tpu_torch.linalg.lstsq import (lstsq_eig, lstsq_qr, lstsq_svd_jacobi,
                                         lstsq_svd_qr)
from raft_tpu_torch.linalg.cholesky import cholesky_r1_update
from raft_tpu_torch.linalg.pca import (ParamsPCA, PCAModel, Solver,
                                       pca_fit, pca_fit_distributed,
                                       pca_inverse_transform, pca_transform)
from raft_tpu_torch.linalg.tsvd import (ParamsTSVD, TSVDModel, tsvd_fit,
                                        tsvd_fit_distributed,
                                        tsvd_inverse_transform,
                                        tsvd_transform)

__all__ = [
    "NormType", "qr_get_q", "qr_get_qr", "eig_dc", "eig_dc_selective",
    "eig_jacobi", "svd_qr", "svd_qr_transpose_right_vec", "svd_eig",
    "svd_jacobi", "svd_reconstruction", "evaluate_svd_by_percentage",
    "randomized_svd", "rsvd_fixed_rank", "rsvd_fixed_rank_symmetric",
    "rsvd_perc", "lstsq_svd_qr", "lstsq_svd_jacobi", "lstsq_eig", "lstsq_qr",
    "cholesky_r1_update", "ParamsPCA", "PCAModel", "Solver", "pca_fit",
    "pca_fit_distributed", "pca_transform", "pca_inverse_transform",
    "ParamsTSVD", "TSVDModel", "tsvd_fit", "tsvd_fit_distributed",
    "tsvd_transform", "tsvd_inverse_transform",
]
