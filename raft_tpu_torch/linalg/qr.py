"""QR decomposition of the port (counterpart of ``raft_tpu/linalg/qr.py``;
ref: cpp/include/raft/linalg/qr.cuh ``qrGetQ`` / ``qrGetQR`` over cuSOLVER
geqrf/orgqr, which ``torch.linalg.qr`` calls on the card)."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.resources import float_operands, input_device


def qr_get_q(res, A):
    """The reduced Q factor. (ref: qr.cuh ``qrGetQ``)"""
    return qr_get_qr(res, A)[0]


def qr_get_qr(res, A):
    """The reduced (Q, R) factorization. (ref: qr.cuh ``qrGetQR``)"""
    A, = float_operands(input_device(res, A), A)
    return torch.linalg.qr(A, mode="reduced")
