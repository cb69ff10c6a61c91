"""pylibraft-compatible API of the port (counterpart of
``raft_tpu/compat/pylibraft.py``; ref: python/pylibraft/pylibraft —
``DeviceResources`` (common/handle.pyx:21-123), the deprecated ``Handle``
(:125), ``@auto_sync_handle`` (:196), ``device_ndarray``
(common/device_ndarray.py:16-157), ``sparse.linalg.eigsh``
(sparse/linalg/lanczos.pyx:100), ``svds`` (sparse/linalg/svds.pyx:73),
``random.rmat`` (random/rmat_rectangular_generator.pyx)).

A pylibraft user switches imports to ``raft_tpu_torch.compat`` and keeps
their code. Device arrays are torch tensors, on the card unless asked for
the CPU.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.resources import (DeviceResources, as_tensor,
                                           ensure_resources, resolve_device)
from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix

Handle = DeviceResources  # (ref: common/handle.pyx:125, deprecated name)


def auto_sync_handle(fn):
    """The default handle when none is given, and the handle's device
    synchronised before returning: pylibraft's synchronous call contract.
    (ref: common/handle.pyx:196 ``@auto_sync_handle``)"""

    @functools.wraps(fn)
    def wrapper(*args, handle: Optional[DeviceResources] = None, **kwargs):
        handle = ensure_resources(handle)
        out = fn(*args, handle=handle, **kwargs)
        handle.sync()
        return out

    return wrapper


class device_ndarray:  # noqa: N801 — pylibraft spelling
    """A device buffer with numpy semantics, backed by a torch tensor on
    the card (or on ``device``). (ref: common/device_ndarray.py:16)"""

    def __init__(self, np_arr, device=None):
        self._array = as_tensor(np_arr, resolve_device(device, np_arr))

    @classmethod
    def empty(cls, shape, dtype=np.float32, order="C", device=None):
        return cls(np.empty(shape, dtype=dtype, order=order), device)

    @classmethod
    def zeros(cls, shape, dtype=np.float32, device=None):
        return cls(np.zeros(shape, dtype=dtype), device)

    @classmethod
    def ones(cls, shape, dtype=np.float32, device=None):
        return cls(np.ones(shape, dtype=dtype), device)

    @property
    def shape(self):
        return tuple(self._array.shape)

    @property
    def dtype(self):
        return self._array.dtype

    @property
    def ndim(self):
        return self._array.ndim

    @property
    def __cuda_array_interface__(self):
        """The tensor's own (raises AttributeError off the card)."""
        return self._array.__cuda_array_interface__

    def copy_to_host(self) -> np.ndarray:
        """(ref: device_ndarray.copy_to_host)"""
        return self._array.detach().cpu().numpy()

    def to_torch(self) -> torch.Tensor:
        return self._array

    def __array__(self, dtype=None, copy=None):
        host = self.copy_to_host()
        return host.astype(dtype) if dtype is not None else host

    def __repr__(self):
        return f"device_ndarray(shape={self.shape}, dtype={self.dtype})"


def _unwrap(x, device):
    return x.to_torch() if isinstance(x, device_ndarray) else as_tensor(
        x, device)


class ai_wrapper:  # noqa: N801 — pylibraft spelling
    """An object speaking numpy's ``__array_interface__`` (or the buffer
    protocol): shape, dtype and contiguity, and a zero-copy CPU tensor.
    (ref: pylibraft/common/ai_wrapper.py)"""

    def __init__(self, obj):
        self._np = np.asarray(obj)

    @property
    def shape(self):
        return self._np.shape

    @property
    def dtype(self):
        return self._np.dtype

    @property
    def c_contiguous(self) -> bool:
        return bool(self._np.flags["C_CONTIGUOUS"])

    def to_torch(self) -> torch.Tensor:
        return torch.from_numpy(self._np)


class cai_wrapper:  # noqa: N801 — pylibraft spelling
    """A device array: a torch tensor or ``device_ndarray`` as it is, an
    object speaking dlpack or ``__cuda_array_interface__`` without a copy,
    anything else through a host copy. (ref: pylibraft/common/
    cai_wrapper.py)"""

    def __init__(self, obj):
        if isinstance(obj, device_ndarray):
            self._t = obj.to_torch()
        elif isinstance(obj, torch.Tensor):
            self._t = obj
        elif hasattr(obj, "__dlpack__"):
            self._t = torch.from_dlpack(obj)
        elif hasattr(obj, "__cuda_array_interface__"):
            self._t = torch.as_tensor(obj, device="cuda")
        else:
            self._t = torch.from_numpy(np.array(obj))

    @property
    def shape(self):
        return tuple(self._t.shape)

    @property
    def dtype(self):
        return self._t.dtype

    @property
    def c_contiguous(self) -> bool:
        return self._t.is_contiguous()

    def to_torch(self) -> torch.Tensor:
        return self._t


def _sparse_operand(A, device):
    """scipy sparse → COO on ``device``; the port's COO/CSR pass."""
    if isinstance(A, (COOMatrix, CSRMatrix)):
        return A
    if hasattr(A, "tocoo"):
        coo = A.tocoo()
        return COOMatrix(torch.as_tensor(coo.row, dtype=torch.int32),
                         torch.as_tensor(coo.col, dtype=torch.int32),
                         torch.as_tensor(coo.data.astype(np.float32)),
                         coo.shape).to(device)
    return None


def eigsh(A, k: int = 6, which: str = "LM", v0=None, ncv: Optional[int] = None,
          maxiter: Optional[int] = None, tol: float = 0.0, seed: int = 42,
          handle: Optional[DeviceResources] = None):
    """scipy.sparse.linalg.eigsh-compatible Lanczos: (eigenvalues,
    eigenvectors). (ref: sparse/linalg/lanczos.pyx:100 — which="LM",
    maxiter=None → 10·n, tol=0 → the machine epsilon of the operand's
    dtype; takes scipy sparse, the port's COO/CSR, a device_ndarray or a
    dense matrix.)"""
    from raft_tpu_torch.sparse.solver import (LANCZOS_WHICH,
                                              LanczosSolverConfig,
                                              lanczos_compute_eigenpairs)

    handle = ensure_resources(handle)
    op = _sparse_operand(A, handle.device)
    if op is None:
        op = _unwrap(A, handle.device)
    n = op.shape[0]
    if maxiter is None:
        maxiter = 10 * n                   # (ref: lanczos.pyx:174-175)
    dtype = op.values.dtype if isinstance(op, (COOMatrix, CSRMatrix)) \
        else op.dtype
    if not dtype.is_floating_point:
        dtype = torch.float32
    config = LanczosSolverConfig(
        n_components=k, max_iterations=maxiter, ncv=ncv,
        tolerance=tol if tol > 0 else float(torch.finfo(dtype).eps),
        which=LANCZOS_WHICH[which.upper()], seed=seed)
    vals, vecs = lanczos_compute_eigenpairs(handle, op, config, v0=v0)
    handle.sync()
    return vals, vecs


def svds(A, k: int, n_oversamples: int = 10, n_power_iters: int = 2,
         seed: int = 42, handle: Optional[DeviceResources] = None):
    """Sparse randomized SVD: (U, S, V). (ref: sparse/linalg/
    svds.pyx:73)"""
    from raft_tpu_torch.sparse.solver import SvdsConfig, randomized_svds

    handle = ensure_resources(handle)
    out = randomized_svds(handle, _sparse_operand(A, handle.device),
                          SvdsConfig(n_components=k,
                                     n_oversamples=n_oversamples,
                                     n_power_iters=n_power_iters,
                                     seed=seed))
    handle.sync()
    return out


def rmat(out, theta, r_scale: int, c_scale: int, seed: int = 12345,
         handle: Optional[DeviceResources] = None):
    """R-MAT edges with pylibraft's signature: fills ``out`` [n_edges, 2]
    (a device_ndarray or tensor, or an edge count) in place and returns
    it. (ref: random/rmat_rectangular_generator.pyx ``rmat``)"""
    from raft_tpu_torch.random.rmat import rmat_rectangular_gen

    handle = ensure_resources(handle)
    n_edges = out.shape[0] if hasattr(out, "shape") else int(out)
    src, dst = rmat_rectangular_gen(handle, seed, n_edges, r_scale, c_scale,
                                    theta=theta)
    result = torch.stack([src, dst], dim=1)
    handle.sync()
    if isinstance(out, device_ndarray):
        out.to_torch().copy_(result)
        return out
    if isinstance(out, torch.Tensor):
        return out.copy_(result)
    return result
