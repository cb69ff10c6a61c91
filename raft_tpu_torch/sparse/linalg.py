"""Sparse linear algebra of the port.

(Counterpart of ``raft_tpu/sparse/linalg.py``; ref: cpp/include/raft/
sparse/linalg/ — spmm.hpp:42, sddmm.hpp:43, masked_matmul.cuh:47,92,
detail/add.cuh, degree.cuh, detail/norm.cuh, normalize, transpose
(csr2csc), detail/symmetrize.cuh, laplacian.cuh:20,32,60,93.)

COO/CSR operands take the general path: gathers and ``index_add_`` (the
reference's segment sums), except SDDMM, whose kernel K7 takes an f32
COO/CSR structure on the card as it is. The prepared layouts of
``sparse/tiled.py`` take the kernels: ``TiledELL`` → K6a/K6c,
``TiledPairsSpmv`` → K6b, ``TiledPairs`` → K7 (``ops/spmv.py``,
``ops/sddmm.py``). The reference's
sharded operand (``sparse/sharded.py``, ``ShardedTiledELL``) waits for the
port's sharded slice: the ``mesh=`` entry points raise
``NotImplementedError``.

Every function moves a COO/CSR operand that is not on a device yet onto
the device of its tensors, or ``cuda`` (``core/sparse_types.to_device``).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from raft_tpu_torch.core.bitset import BitmapView, BitsetView
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix, to_device
from raft_tpu_torch.linalg.types import NormType
from raft_tpu_torch.sparse.convert import lexsort_rows_cols, sorted_coo_to_csr
from raft_tpu_torch.sparse.tiled import (TiledELL, TiledPairs,
                                         TiledPairsSpmv, tile_csr,
                                         tile_csr_pairs, tile_pairs)

Sparse = Union[COOMatrix, CSRMatrix]


def _as_coo_parts(A: Sparse):
    """(rows, cols, values, shape) of A, on its device."""
    A = to_device(A)
    if isinstance(A, CSRMatrix):
        return A.row_ids(), A.indices, A.values, A.shape
    return A.rows, A.cols, A.values, A.shape


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int):
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, seg.long(), vals)


def spmv(res, A, x) -> torch.Tensor:
    """y = A @ x. (ref: cusparseSpMV wrappers; the Lanczos hot loop's
    matvec — sparse/solver/detail/lanczos.cuh:263-271.)

    ``A`` may be COO/CSR (gather + ``index_add_``), a :class:`TiledELL`
    (K6a) or a :class:`TiledPairsSpmv` (K6b); prepare the layouts once
    with :func:`prepare_spmv` for repeated matvecs."""
    from raft_tpu_torch.ops import spmv as k6

    if isinstance(A, TiledPairsSpmv):
        return k6.spmv_pair_tiled(A, x)
    if isinstance(A, TiledELL):
        return k6.spmv_tiled(A, x)
    rows, cols, vals, shape = _as_coo_parts(A)
    x = torch.as_tensor(x).to(device=vals.device, dtype=vals.dtype)
    return _segment_sum(vals * x[cols.long()], rows, shape[0])


def prepare_spmv(A: Sparse, C: int = 512, R: int = 256, E: int = 2048,
                 layout: str = "ell", device=None):
    """One-time conversion of a sparse matrix to a kernel layout, on its
    device (``device``, else its tensors', else cuda); the result is
    accepted by :func:`spmv` and the Lanczos/spectral solvers.

    ``layout="ell"`` (default) builds the :class:`TiledELL` operand (K6a,
    also :func:`spmm`'s K6c); ``layout="pairs"`` the
    :class:`TiledPairsSpmv` operand (K6b), a win only for block-clustered
    structures (every (row tile, col tile) bucket pads to E slots)."""
    if layout == "pairs":
        return tile_csr_pairs(A, C=C, R=R, E=E, device=device)
    if layout != "ell":
        raise ValueError(f"prepare_spmv: layout must be 'pairs' or "
                         f"'ell', got {layout!r}")
    return tile_csr(A, C=C, R=R, E=E, device=device)


def spmm(res, A, B, alpha=1.0, beta=0.0, C=None) -> torch.Tensor:
    """C = alpha A @ B + beta C for dense B. (ref: sparse/linalg/
    spmm.hpp:42.) A COO/CSR ``A`` keeps its dtype; a :class:`TiledELL`
    runs K6c in f32."""
    from raft_tpu_torch.ops import spmv as k6

    if isinstance(A, TiledPairsSpmv):
        raise TypeError(
            "spmm: got a pair-tiled SpMV operand; prepare with "
            "prepare_spmv(A, layout='ell') for multi-vector products")
    if isinstance(A, TiledELL):
        out = alpha * k6.spmm_tiled(A, B)
    else:
        rows, cols, vals, shape = _as_coo_parts(A)
        B = torch.as_tensor(B).to(device=vals.device, dtype=vals.dtype)
        out = alpha * _segment_sum(vals[:, None] * B[cols.long()], rows,
                                   shape[0])
    if C is not None and beta != 0.0:
        out = out + beta * torch.as_tensor(C).to(out.device, out.dtype)
    return out


def prepare_sddmm(structure: Sparse, R: int = 256, C: int = 512,
                  E: int = 2048, device=None) -> TiledPairs:
    """The reference's one-time conversion of a sparsity structure to the
    pair-tiled layout of its SDDMM kernel; accepted by :func:`sddmm` (as
    ``structure``) and :func:`masked_matmul` (as ``prepared``). K7 reads
    only the structure's entries, so on the card an f32 COO/CSR structure
    needs no preparation."""
    return tile_pairs(structure, R=R, C=C, E=E, device=device)


def sddmm(res, A, B, structure, alpha=1.0, beta=0.0) -> Sparse:
    """Sampled dense-dense matmul: C_ij = alpha·(A @ B)_ij + beta·C_ij at
    the nonzero positions of ``structure`` only; A is [m×k], B is [k×n].
    (ref: sparse/linalg/sddmm.hpp:43.)

    A COO/CSR ``structure`` keeps its dtype: in f32 on the card (d ≤
    512) it takes K7 over its entries, else the gather path. A
    :class:`TiledPairs` (the reference's prepared operand, accepted for
    parity) takes K7 (f32) over its structure; it has no values, so beta
    must be 0, and its result is a COO matrix in the structure's original
    entry order."""
    from raft_tpu_torch.ops import sddmm as k7

    if isinstance(structure, TiledPairs):
        expects(beta == 0.0, "sddmm: TiledPairs carries no values "
                "(beta must be 0)")
        vals = alpha * k7.sddmm_tiled(structure, A, B)
        return COOMatrix(structure.rows, structure.cols, vals,
                         structure.shape)
    structure = to_device(structure)
    rows, cols, vals, shape = _as_coo_parts(structure)
    A = torch.as_tensor(A).to(device=vals.device)
    B = torch.as_tensor(B).to(device=vals.device)
    expects(A.shape[0] == shape[0] and B.shape[1] == shape[1],
            "sddmm: shape mismatch")
    if vals.device.type == "cuda" and vals.dtype == A.dtype == B.dtype \
            == torch.float32 and A.shape[1] <= k7.MAX_D:
        prod = k7.sddmm_entries(A, B, rows.to(torch.int32).contiguous(),
                                cols.to(torch.int32).contiguous())
    else:
        prod = (A[rows.long(), :] * B[:, cols.long()].T).sum(1)
    new_vals = alpha * prod + (beta * vals if beta != 0.0 else 0.0)
    return structure.with_values(new_vals.to(vals.dtype))


def masked_matmul(res, A, B, mask: "BitmapView | BitsetView", alpha=1.0,
                  beta=0.0, prepared=None) -> Sparse:
    """C = alpha·(A @ Bᵀ) ∘ mask, result sparse (A [m×k], B [n×k]).
    (ref: sparse/linalg/masked_matmul.cuh:47,92.) ``prepared`` — the
    :func:`prepare_sddmm` layout of the mask's structure — reuses that
    structure for repeated products over one mask (beta must be 0)."""
    from raft_tpu_torch.sparse.convert import bitmap_to_csr, bitset_to_csr

    dev = mask.words.device
    A = torch.as_tensor(A).to(dev)
    B = torch.as_tensor(B).to(dev)
    if prepared is not None:
        return sddmm(res, A, B.T, prepared, alpha=alpha, beta=beta)
    if isinstance(mask, BitmapView):
        structure = bitmap_to_csr(mask)
    else:
        structure = bitset_to_csr(mask, n_repeat=A.shape[0])
    return sddmm(res, A, B.T, structure, alpha=alpha, beta=beta)


def add(res, A: Sparse, B: Sparse, dedup: bool = False) -> CSRMatrix:
    """Sparse + sparse on the union structure. (ref: sparse/linalg/
    add.cuh.) ``dedup=True`` prunes duplicate slots to the canonical
    structural nnz (see :func:`_coalesce_to_csr`)."""
    ra, ca, va, shape_a = _as_coo_parts(A)
    rb, cb, vb, shape_b = _as_coo_parts(B)
    expects(shape_a == shape_b, "sparse add: shape mismatch")
    return _coalesce_to_csr(torch.cat([ra, rb.to(ra.device)]),
                            torch.cat([ca, cb.to(ca.device)]),
                            torch.cat([va, vb.to(va.device, va.dtype)]),
                            shape_a, dedup=dedup)


def _coalesce_to_csr(rows, cols, vals, shape, dedup: bool = False
                     ) -> CSRMatrix:
    """Sum duplicate (row, col) entries into sorted CSR; duplicate slots
    become explicit zeros unless ``dedup`` (see
    :func:`_device_coalesce_sorted`)."""
    r, c, v, keep = _device_coalesce_sorted(rows, cols, vals, shape[1])
    if dedup and r.shape[0]:
        r, c, v = r[keep], c[keep], v[keep]
    return sorted_coo_to_csr(COOMatrix(r, c, v, shape))


def _device_coalesce_sorted(rows, cols, vals, n_cols: int):
    """Sort by (row, col), sum each duplicate run into its first slot and
    zero the rest (``raft_tpu/sparse/linalg.py:290``): the output nnz
    equals the input nnz, so duplicate slots become explicit zeros — exact
    for every summing consumer, while structural counts (``nnz``,
    :func:`degree`) keep the slots, as the reference's do. Also returns the
    run-first mask (the slots an exact dedup keeps)."""
    if vals.shape[0] == 0:
        return rows, cols, vals, torch.ones(0, dtype=torch.bool,
                                            device=vals.device)
    order = lexsort_rows_cols(rows, cols, n_cols)
    r, c, v = rows[order], cols[order], vals[order]
    first = torch.ones(r.shape[0], dtype=torch.bool, device=r.device)
    first[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    seg = torch.cumsum(first, 0) - 1
    sums = _segment_sum(v, seg, v.shape[0])
    v_out = torch.where(first, sums[seg], torch.zeros_like(v))
    return r, c, v_out, first


def degree(res, A: Sparse) -> torch.Tensor:
    """Per-row nonzero count. (ref: sparse/linalg/degree.cuh
    ``coo_degree``)"""
    rows, _, _, shape = _as_coo_parts(A)
    return torch.bincount(rows.long(), minlength=shape[0]).to(torch.int32)


def row_norm(res, A: Sparse, norm_type: NormType = NormType.L2
             ) -> torch.Tensor:
    """Per-row norms of the values (L2 returns the sum of squares, like
    the reference). (ref: sparse/linalg/detail/norm.cuh)"""
    rows, _, vals, shape = _as_coo_parts(A)
    if norm_type == NormType.L1:
        return _segment_sum(vals.abs(), rows, shape[0])
    if norm_type == NormType.L2:
        return _segment_sum(vals * vals, rows, shape[0])
    out = torch.full((shape[0],), float("-inf"), dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce_(0, rows.long(), vals.abs(), "amax",
                               include_self=False)


def row_normalize(res, A: Sparse, norm_type: NormType = NormType.L1
                  ) -> Sparse:
    """Scale each row to unit norm. (ref: sparse/linalg/normalize.cuh)"""
    A = to_device(A)
    rows, _, vals, _ = _as_coo_parts(A)
    norms = row_norm(res, A, norm_type)
    if norm_type == NormType.L2:
        norms = torch.sqrt(norms)
    per_val = norms[rows.long()]
    safe = torch.where(per_val == 0, torch.ones_like(per_val), per_val)
    return A.with_values(torch.where(per_val == 0, torch.zeros_like(vals),
                                     vals / safe))


def transpose(res, A: CSRMatrix) -> CSRMatrix:
    """CSR transpose (csr2csc). (ref: sparse/linalg/transpose.cuh)"""
    from raft_tpu_torch.sparse.convert import coo_to_csr

    rows, cols, vals, shape = _as_coo_parts(A)
    return coo_to_csr(COOMatrix(cols, rows, vals, (shape[1], shape[0])))


def symmetrize(res, A: Sparse, dedup: bool = False) -> CSRMatrix:
    """A + Aᵀ on the union structure. (ref: sparse/linalg/detail/
    symmetrize.cuh)"""
    rows, cols, vals, shape = _as_coo_parts(A)
    expects(shape[0] == shape[1], "symmetrize: square input required")
    return _coalesce_to_csr(torch.cat([rows, cols]), torch.cat([cols, rows]),
                            torch.cat([vals, vals]), shape, dedup=dedup)


def compute_graph_laplacian(res, A: Sparse, dedup: bool = False
                            ) -> CSRMatrix:
    """L = D − A (out-degree Laplacian; A's diagonal is ignored and one
    diagonal entry is added per row — ref: sparse/linalg/laplacian.cuh:
    20,32). Duplicate entries coalesce into explicit zeros, so ``L.nnz``
    and :func:`degree` count the input's duplicate slots, as the
    reference's do; ``dedup=True`` gives the canonical structural nnz."""
    rows, cols, vals, shape = _as_coo_parts(A)
    expects(shape[0] == shape[1], "The graph Laplacian can only be "
            "computed on a square adjacency matrix")
    masked = torch.where(rows != cols, vals, torch.zeros_like(vals))
    deg = _segment_sum(masked, rows, shape[0])
    diag = torch.arange(shape[0], dtype=rows.dtype, device=rows.device)
    return _coalesce_to_csr(torch.cat([rows, diag]),
                            torch.cat([cols.to(rows.dtype), diag]),
                            torch.cat([-masked, deg]), shape, dedup=dedup)


def laplacian_normalized(res, A: Sparse
                         ) -> Tuple[CSRMatrix, torch.Tensor]:
    """Normalized Laplacian D^(−1/2) L D^(−1/2) and the scaled diagonal
    D^(−1/2) (zero degrees mapped to 1 first, the reference's zero_to_one).
    (ref: sparse/linalg/laplacian.cuh:60,93)"""
    L = compute_graph_laplacian(res, A)
    diag = diagonal(res, L)
    safe = torch.where(diag == 0, torch.ones_like(diag), diag)
    d_inv_sqrt = 1.0 / torch.sqrt(safe)
    rows, cols, vals, _ = _as_coo_parts(L)
    scaled = vals * d_inv_sqrt[rows.long()] * d_inv_sqrt[cols.long()]
    return L.with_values(scaled), d_inv_sqrt


def diagonal(res, A: Sparse) -> torch.Tensor:
    """The main diagonal (duplicates summed). (ref: sparse/matrix/detail/
    diagonal.cuh)"""
    rows, cols, vals, shape = _as_coo_parts(A)
    return _segment_sum(torch.where(rows == cols, vals,
                                    torch.zeros_like(vals)), rows, shape[0])
