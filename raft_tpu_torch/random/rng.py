"""Device RNG distributions of the port (counterpart of
``raft_tpu/random/rng.py``; ref: cpp/include/raft/random/rng.cuh,
random/detail/rng_impl.cuh, sample_without_replacement.cuh, permute.cuh).

Every function takes a stream argument (an ``RngState``, a
``torch.Generator``, an int seed, or None for the handle's generator) and
draws on the handle's device (or ``device``; cuda by default). A
``torch.Generator`` cannot reproduce the reference's threefry bits, so the
distributions agree with the reference's in law, not bit for bit; the one
exception is ``uniform`` on a ``GeneratorType.PCG`` state, which is the
reference's PCG32 stream bit for bit (:func:`pcg32_uniform`).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import as_tensors
from raft_tpu_torch.random.rng_state import (GeneratorType, RngState,
                                             as_generator, target_device)

_MULT = 6364136223846793005
_MASK64 = (1 << 64) - 1
#: PCG32 outputs computed per vectorised step of :func:`pcg32_uint32`
_PCG_BLOCK = 1 << 16


def pcg32_uint32(seed: int, n: int, stream: int = 0) -> np.ndarray:
    """n outputs of the PCG32 XSH-RR stream (``pcg_basic.c``'s
    ``pcg32_srandom_r(seed, stream)`` then ``pcg32_random_r``; ref:
    thirdparty/pcg/pcg_basic.c, ``GenPC`` in random/rng_state.hpp).

    Vectorised by LCG jump-ahead in numpy uint64 (which wraps mod 2⁶⁴): a
    block's states are Mⁱ·s₀ + cᵢ, with c₀ = 0 and cᵢ₊₁ = M·cᵢ + inc."""
    inc = ((int(stream) << 1) | 1) & _MASK64
    s0 = ((inc + int(seed)) * _MULT + inc) & _MASK64   # srandom's two steps
    B = max(1, min(int(n), _PCG_BLOCK))
    mult = np.uint64(_MULT)
    a = np.full(B, mult, np.uint64)
    a[0] = 1
    c = np.zeros(B, np.uint64)
    with np.errstate(over="ignore"):
        a = np.cumprod(a, dtype=np.uint64)                      # Mⁱ
        c[1:] = np.cumsum(a[:-1], dtype=np.uint64) * np.uint64(inc)  # cᵢ
        out = np.empty(int(n), np.uint32)
        start = np.uint64(s0)
        for i0 in range(0, int(n), B):
            old = a * start + c                # the block's states
            xs = (((old >> np.uint64(18)) ^ old) >> np.uint64(27)).astype(
                np.uint32)
            rot = (old >> np.uint64(59)).astype(np.uint32)
            word = (xs >> rot) | (xs << ((np.uint32(32) - rot)
                                         & np.uint32(31)))
            m = min(B, int(n) - i0)
            out[i0:i0 + m] = word[:m]
            start = old[-1] * mult + np.uint64(inc)
    return out


def pcg32_uniform(seed: int, n: int, stream: int = 0) -> np.ndarray:
    """Uniform [0, 1) f32 from the PCG32 stream: the top 24 bits of each
    output times 2⁻²⁴, as the reference's native library computes them."""
    bits = pcg32_uint32(seed, n, stream)
    return (bits >> np.uint32(8)).astype(np.float32) * np.float32(
        1.0 / 16777216.0)


def _draw(res, state, device):
    dev = target_device(res, device, state)
    return as_generator(state, res, dev), dev


def _unit(shape, gen, dev, dtype, low: float = 0.0):
    """Uniform draws in (low, 1): ``torch.rand``'s [0, 1) with its zeros
    lifted to ``low`` (the reference's ``minval=tiny``)."""
    u = torch.rand(tuple(shape), generator=gen, device=dev, dtype=dtype)
    return u.clamp_min(low) if low > 0 else u


def uniform(res, state, shape, low=0.0, high=1.0, dtype=torch.float32,
            device=None):
    """[low, high). (ref: rng.cuh ``uniform``) An ``RngState`` of
    ``GeneratorType.PCG`` draws the reference's PCG32 stream on the host
    and moves it to the device: the same bits as the reference."""
    dev = target_device(res, device, state)
    if isinstance(state, RngState) and state.type == GeneratorType.PCG:
        u = pcg32_uniform(state.seed, math.prod(shape),
                          stream=state.base_subsequence)
        u = torch.from_numpy(u.reshape(tuple(shape))).to(device=dev,
                                                         dtype=dtype)
        return u * (high - low) + low
    u = torch.rand(tuple(shape), generator=as_generator(state, res, dev),
                   device=dev, dtype=dtype)
    out = u * (high - low) + low
    # the affine map can round a draw just below 1 up to ``high``
    top = torch.nextafter(torch.tensor(high, dtype=dtype),
                          torch.tensor(low, dtype=dtype)).item()
    return out.clamp_max(top)


def uniform_int(res, state, shape, low, high, dtype=torch.int32,
                device=None):
    """[low, high). (ref: rng.cuh ``uniformInt``)"""
    gen, dev = _draw(res, state, device)
    return torch.randint(int(low), int(high), tuple(shape), generator=gen,
                         device=dev, dtype=dtype)


def normal(res, state, shape, mu=0.0, sigma=1.0, dtype=torch.float32,
           device=None):
    """(ref: rng.cuh ``normal``)"""
    gen, dev = _draw(res, state, device)
    return mu + sigma * torch.randn(tuple(shape), generator=gen, device=dev,
                                    dtype=dtype)


def normal_int(res, state, shape, mu, sigma, dtype=torch.int32,
               device=None):
    """A rounded normal (half to even). (ref: rng.cuh ``normalInt``)"""
    return torch.round(normal(res, state, shape, mu, sigma,
                              device=device)).to(dtype)


def normal_table(res, state, n_rows, mu_vec, sigma_vec=None, sigma=1.0,
                 dtype=torch.float32, device=None):
    """Column j ~ N(mu_vec[j], sigma_vec[j]) (or ``sigma``).
    (ref: rng.cuh ``normalTable``)"""
    gen, dev = _draw(res, state, device)
    mu_vec, sigma_vec = as_tensors(None, mu_vec, sigma_vec, device=dev)
    z = torch.randn((int(n_rows), mu_vec.shape[0]), generator=gen,
                    device=dev, dtype=dtype)
    s = sigma_vec.to(dtype)[None, :] if sigma_vec is not None else sigma
    return mu_vec.to(dtype)[None, :] + z * s


def fill(res, state, shape, value, dtype=torch.float32, device=None):
    """(ref: rng.cuh ``fill``)"""
    return torch.full(tuple(shape), value, dtype=dtype,
                      device=target_device(res, device, state))


def lognormal(res, state, shape, mu=0.0, sigma=1.0, dtype=torch.float32,
              device=None):
    """(ref: rng.cuh ``lognormal``)"""
    return torch.exp(normal(res, state, shape, mu, sigma, dtype, device))


def gumbel(res, state, shape, mu=0.0, beta=1.0, dtype=torch.float32,
           device=None):
    """mu − beta·log(−log u). (ref: rng.cuh ``gumbel``)"""
    gen, dev = _draw(res, state, device)
    u = _unit(shape, gen, dev, dtype, torch.finfo(dtype).tiny)
    return mu + beta * -torch.log(-torch.log(u))


def logistic(res, state, shape, mu=0.0, scale=1.0, dtype=torch.float32,
             device=None):
    """mu + scale·log(u / (1 − u)). (ref: rng.cuh ``logistic``)"""
    gen, dev = _draw(res, state, device)
    u = _unit(shape, gen, dev, dtype, torch.finfo(dtype).tiny)
    return mu + scale * (torch.log(u) - torch.log1p(-u))


def exponential(res, state, shape, lambda_=1.0, dtype=torch.float32,
                device=None):
    """Rate ``lambda_``: −log(1 − u) / lambda_. (ref: rng.cuh
    ``exponential``)"""
    gen, dev = _draw(res, state, device)
    return -torch.log1p(-_unit(shape, gen, dev, dtype)) / lambda_


def rayleigh(res, state, shape, sigma=1.0, dtype=torch.float32, device=None):
    """sigma·√(−2 log u). (ref: rng.cuh ``rayleigh``)"""
    gen, dev = _draw(res, state, device)
    u = _unit(shape, gen, dev, dtype, torch.finfo(dtype).tiny)
    return sigma * torch.sqrt(-2.0 * torch.log(u))


def laplace(res, state, shape, mu=0.0, scale=1.0, dtype=torch.float32,
            device=None):
    """mu − scale·sign(v)·log(1 − |v|), v uniform on (−1, 1).
    (ref: rng.cuh ``laplace``)"""
    gen, dev = _draw(res, state, device)
    v = 2.0 * _unit(shape, gen, dev, dtype, torch.finfo(dtype).eps) - 1.0
    return mu - scale * torch.sign(v) * torch.log1p(-v.abs())


def cauchy(res, state, shape, mu=0.0, scale=1.0, dtype=torch.float32,
           device=None):
    """mu + scale·tan(π(u − ½)). (ref: rng.cuh ``cauchy``)"""
    gen, dev = _draw(res, state, device)
    u = _unit(shape, gen, dev, dtype, torch.finfo(dtype).tiny)
    return mu + scale * torch.tan(math.pi * (u - 0.5))


def bernoulli(res, state, shape, prob=0.5, device=None):
    """bool draws, True with probability ``prob``. (ref: rng.cuh
    ``bernoulli``)"""
    gen, dev = _draw(res, state, device)
    return torch.rand(tuple(shape), generator=gen, device=dev) < prob


def scaled_bernoulli(res, state, shape, prob=0.5, scale=1.0,
                     dtype=torch.float32, device=None):
    """Draws in {−scale, +scale} with P(−scale) = prob, as the reference
    (detail/rng_device.cuh: ``res < prob ? -scale : scale``)."""
    b = bernoulli(res, state, shape, prob, device)
    return torch.where(b, torch.tensor(-scale, dtype=dtype, device=b.device),
                       torch.tensor(scale, dtype=dtype, device=b.device))


def discrete(res, state, shape, weights, dtype=torch.int32, device=None):
    """Categories drawn by unnormalised weights; a weight ≤ 0 is never
    drawn. (ref: rng.cuh ``discrete``)"""
    gen, dev = _draw(res, state, device)
    w, = as_tensors(None, weights, device=dev)
    w = w.to(torch.float32)
    p = torch.where(w > 0, w, torch.zeros_like(w))
    n = math.prod(shape)
    draws = torch.multinomial(p, n, replacement=True, generator=gen)
    return draws.reshape(tuple(shape)).to(dtype)


def permute(res, state, matrix=None, n: Optional[int] = None, device=None):
    """A random row permutation: (perm int32, the permuted rows or None).
    (ref: random/permute.cuh)"""
    expects(matrix is not None or n is not None, "permute: need matrix or n")
    if matrix is not None:
        matrix, = as_tensors(res, matrix, device=device)
        device, n = matrix.device, matrix.shape[0]
    gen, dev = _draw(res, state, device)
    perm = torch.randperm(int(n), generator=gen, device=dev)
    out = matrix[perm] if matrix is not None else None
    return perm.to(torch.int32), out


def sample_without_replacement(res, state, population: int, n_samples: int,
                               weights=None, dtype=torch.int32, device=None):
    """Indices sampled without replacement, by weight when ``weights`` is
    given (Gumbel top-k, as the reference; a weight ≤ 0 is never drawn
    while enough positive weights remain). (ref: random/
    sample_without_replacement.cuh)"""
    expects(n_samples <= population,
            "sample_without_replacement: n_samples %d > population %d",
            n_samples, population)
    gen, dev = _draw(res, state, device)
    if weights is None:
        return torch.randperm(int(population), generator=gen,
                              device=dev)[:n_samples].to(dtype)
    w, = as_tensors(None, weights, device=dev)
    w = w.to(torch.float32)
    u = _unit((population,), gen, dev, torch.float32,
              torch.finfo(torch.float32).tiny)
    g = torch.where(w > 0, torch.log(w), torch.full_like(w, -math.inf)) \
        - torch.log(-torch.log(u))
    return torch.topk(g, n_samples).indices.to(dtype)
