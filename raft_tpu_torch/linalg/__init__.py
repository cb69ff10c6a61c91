"""raft_tpu_torch.linalg — dense linear algebra of the port: elementwise
maps, reductions, norms, matrix-vector ops, reduce-by-key, BLAS, transpose,
init, the tiled contraction, QR, eigensolvers, the SVD family, randomized
SVD, least squares, the Cholesky rank-1 update, PCA and truncated SVD.
(ref: cpp/include/raft/linalg.)"""

from raft_tpu_torch.linalg.types import Apply, NormType
from raft_tpu_torch.linalg.map import (binary_op, map, map_offset,
                                       ternary_op, unary_op,
                                       write_only_unary_op)
from raft_tpu_torch.linalg.eltwise import (
    add, add_scalar, divide, divide_scalar, eltwise_add, eltwise_divide,
    eltwise_divide_check_zero, eltwise_multiply, eltwise_sub, multiply,
    multiply_scalar, power, power_scalar, scalar_add, scalar_multiply, sqrt,
    subtract, subtract_scalar)
from raft_tpu_torch.linalg.reduce import (coalesced_reduction, map_reduce,
                                          map_then_reduce,
                                          mean_squared_error, reduce,
                                          strided_reduction)
from raft_tpu_torch.linalg.norm import (col_norm, norm, normalize, row_norm,
                                        row_normalize)
from raft_tpu_torch.linalg.matrix_vector import (
    binary_add, binary_div, binary_div_skip_zero, binary_mult,
    binary_mult_skip_zero, binary_sub, matrix_vector_op, matrix_vector_op2)
from raft_tpu_torch.linalg.reduce_by_key import (reduce_cols_by_key,
                                                 reduce_rows_by_key)
from raft_tpu_torch.linalg.blas import axpy, dot, gemm, gemv
from raft_tpu_torch.linalg.transpose import transpose, transpose_inplace
from raft_tpu_torch.linalg.init import range_fill
from raft_tpu_torch.linalg.contractions import KernelPolicy, tiled_contraction
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
    "Apply", "NormType", "map", "map_offset", "unary_op",
    "write_only_unary_op", "binary_op", "ternary_op", "add", "subtract",
    "multiply", "divide", "power", "sqrt", "add_scalar", "subtract_scalar",
    "multiply_scalar", "divide_scalar", "power_scalar", "scalar_add",
    "scalar_multiply", "eltwise_add", "eltwise_sub", "eltwise_multiply",
    "eltwise_divide", "eltwise_divide_check_zero", "reduce",
    "coalesced_reduction", "strided_reduction", "map_then_reduce",
    "map_reduce", "mean_squared_error", "norm", "row_norm", "col_norm",
    "normalize", "row_normalize", "matrix_vector_op", "matrix_vector_op2",
    "binary_mult", "binary_mult_skip_zero", "binary_div",
    "binary_div_skip_zero", "binary_add", "binary_sub", "reduce_rows_by_key",
    "reduce_cols_by_key", "gemm", "gemv", "axpy", "dot", "transpose",
    "transpose_inplace", "range_fill", "KernelPolicy", "tiled_contraction", "qr_get_q", "qr_get_qr", "eig_dc", "eig_dc_selective",
    "eig_jacobi", "svd_qr", "svd_qr_transpose_right_vec", "svd_eig",
    "svd_jacobi", "svd_reconstruction", "evaluate_svd_by_percentage",
    "randomized_svd", "rsvd_fixed_rank", "rsvd_fixed_rank_symmetric",
    "rsvd_perc", "lstsq_svd_qr", "lstsq_svd_jacobi", "lstsq_eig", "lstsq_qr",
    "cholesky_r1_update", "ParamsPCA", "PCAModel", "Solver", "pca_fit",
    "pca_fit_distributed", "pca_transform", "pca_inverse_transform",
    "ParamsTSVD", "TSVDModel", "tsvd_fit", "tsvd_fit_distributed",
    "tsvd_transform", "tsvd_inverse_transform",
]
