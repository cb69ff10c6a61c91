"""Regression dataset generator of the port (counterpart of
``raft_tpu/random/make_regression.py``; ref: cpp/include/raft/random/
make_regression.cuh): X Gaussian (or of a low effective rank), a
coefficient vector whose first ``n_informative`` rows are U(0, 100) and
the rest 0, y = X·w + bias + noise."""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.random.rng_state import as_generator, target_device


def make_regression(res, state, n_samples: int, n_features: int,
                    n_informative: Optional[int] = None, n_targets: int = 1,
                    bias: float = 0.0, noise: float = 0.0,
                    effective_rank: Optional[int] = None,
                    tail_strength: float = 0.5, dtype=torch.float32,
                    device=None):
    """Returns (X [n_samples, n_features], y, coef); y is [n_samples] and
    coef [n_features] when ``n_targets`` is 1. Draws X, then (low rank)
    the rotation, then w, then the noise from one generator.
    (ref: make_regression.cuh ``make_regression``)"""
    dev = target_device(res, device, state)
    gen = as_generator(state, res, dev)
    if n_informative is None:
        n_informative = n_features
    n_informative = min(n_informative, n_features)
    X = torch.randn((n_samples, n_features), generator=gen, device=dev,
                    dtype=dtype)
    if effective_rank is not None:
        # low-rank covariance: X ← X·(Q diag(s) Qᵀ), s decaying from 1
        # (ref: detail/make_regression's low-rank path)
        rank = min(effective_rank, n_features)
        i = torch.arange(n_features, device=dev, dtype=dtype)
        s = ((1 - tail_strength) * torch.exp(-((i / rank) ** 2))
             + tail_strength * torch.exp(-i / (10.0 * rank)))
        q, _ = torch.linalg.qr(torch.randn((n_features, n_features),
                                           generator=gen, device=dev,
                                           dtype=dtype))
        X = X @ (q * s[None, :]) @ q.T
    w = 100.0 * torch.rand((n_features, n_targets), generator=gen,
                           device=dev, dtype=dtype)
    w[n_informative:] = 0
    y = X @ w + bias
    if noise > 0:
        y = y + noise * torch.randn(y.shape, generator=gen, device=dev,
                                    dtype=dtype)
    if n_targets == 1:
        return X, y[:, 0], w[:, 0]
    return X, y, w
