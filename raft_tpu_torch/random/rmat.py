"""R-MAT rectangular graph generator of the port.

(Counterpart of ``raft_tpu/random/rmat.py``; ref: cpp/include/raft/random/
rmat_rectangular_generator.cuh.) Each edge picks one of four quadrants per
scale level with probabilities (a, b, c, d), per-level thetas supported.

Split in two: :func:`rmat_from_uniforms` is the pure map from one uniform
per (edge, level) to (src, dst), so a parity test can feed it the
reference's uniforms (a ``torch.Generator`` cannot reproduce threefry's
bits); :func:`rmat_rectangular_gen` draws those uniforms from a
``torch.Generator`` on the target device, edge chunk by edge chunk, so the
[n_edges, levels] f32 uniforms never exist at once (5.9 GB at Graph500
scale 22).
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.random.rng_state import as_generator, target_device

#: edges drawn per step of :func:`rmat_rectangular_gen`
EDGE_CHUNK = 1 << 23


def _theta(theta, a: float, b: float, c: float, max_scale: int,
           device) -> torch.Tensor:
    if theta is None:
        d = 1.0 - a - b - c
        expects(d >= -1e-6, "rmat: a+b+c must be <= 1")
        t = torch.tensor([a, b, c, max(d, 0.0)], dtype=torch.float32)
        return t.repeat(max_scale, 1).to(device)
    return torch.as_tensor(theta, dtype=torch.float32).reshape(
        max_scale, 4).to(device)


def rmat_from_uniforms(u, theta, r_scale: int, c_scale: int,
                       dtype=torch.int32) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """(src, dst) of the edges whose per-level uniforms are ``u``
    [n_edges, max(r_scale, c_scale)] under the per-level quadrant
    probabilities ``theta`` [levels, 4]: level ℓ's quadrant is the number
    of cumulative bounds below u[:, ℓ], its high bit a row bit and its low
    bit a column bit, each dimension taking its own first ``scale`` levels
    MSB-first (the reference's arithmetic, ``rmat.py:56-72``)."""
    u = torch.as_tensor(u)
    theta = torch.as_tensor(theta, dtype=torch.float32).to(u.device)
    cum = torch.cumsum(theta, dim=1)                       # [levels, 4]
    quad = (u[:, :, None] > cum[None, :, :]).sum(-1).clamp(0, 3)
    levels = u.shape[1]

    def accumulate(bits, scale):
        w = torch.zeros(levels, dtype=torch.int64, device=u.device)
        w[:scale] = 2 ** torch.arange(scale - 1, -1, -1, device=u.device)
        return (bits * w[None, :]).sum(1).to(dtype)

    return accumulate(quad >> 1, r_scale), accumulate(quad & 1, c_scale)


def rmat_rectangular_gen(res, state, n_edges: int, r_scale: int,
                         c_scale: int, theta=None, a: float = 0.57,
                         b: float = 0.19, c: float = 0.19,
                         dtype=torch.int32, device=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_edges`` edges of a 2^r_scale × 2^c_scale R-MAT graph, (src,
    dst). ``theta``: a flat [4·max(r_scale, c_scale)] per-level quadrant
    probability array (the reference's layout) or None for (a, b, c, d)
    at every level. ``state``: an int seed, an ``RngState``, a
    ``torch.Generator`` on the target device, or None for the handle's
    generator; ``device`` defaults
    to the handle's, else cuda. (ref: rmat_rectangular_generator.cuh
    ``rmat_rectangular_gen``)"""
    dev = target_device(res, device)
    gen = as_generator(state, res, dev)
    max_scale = max(r_scale, c_scale)
    th = _theta(theta, a, b, c, max_scale, dev)
    src = torch.empty(n_edges, dtype=dtype, device=dev)
    dst = torch.empty(n_edges, dtype=dtype, device=dev)
    for e0 in range(0, n_edges, EDGE_CHUNK):
        n = min(EDGE_CHUNK, n_edges - e0)
        u = torch.rand((n, max_scale), generator=gen, device=dev)
        src[e0:e0 + n], dst[e0:e0 + n] = rmat_from_uniforms(
            u, th, r_scale, c_scale, dtype)
    return src, dst
