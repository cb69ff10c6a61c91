"""Unexpanded pairwise distances (K8): wrapper, plain twin and launch count.

Counterpart of ``raft_tpu/ops/unexpanded_pallas.py``. The TPU kernel
``unexpanded_pairwise_tiled`` (``:261``, ``pallas_call`` at ``:241``)
becomes the hand-written Hopper kernel in ``csrc/unexpanded.cu``; see that
file for the design.

The contract (the reference's ``_unexp_terms``/``_unexp_finalize``,
``raft_tpu/distance/pairwise.py:195-241``): out[i, j] is the finalized
sum (Linf: maximum) over the features k of a per-feature term of
(x[i, k], y[j, k]), for the ten metrics of :data:`SUPPORTED`. Computation
is in f64 when an input is f64 and in f32 otherwise, the reference's
accumulator rule with x64 on. ``d = 0`` gives zeros.

Precision. Kernel and twin form every term with the same IEEE operations
(``logf``/``powf``/``sqrtf`` exact to their documented ulp, no fast math)
and sum the d terms in different orders: Linf and Hamming agree to the
bit, the others to ``(d + 2)·2⁻²⁴·Σ_k |term_k|`` per entry before the
finalize, plus the ulp of ``logf`` (KL, JS) or ``powf`` (Lp) per term.
Non-finite inputs follow IEEE in both; the Linf fold propagates NaN as
``jnp.max`` does.

The wrapper dispatches on the tensors' device: CPU tensors take the twin,
CUDA tensors launch the kernel or raise. There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from raft_tpu_torch.core.error import DeviceError
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.ops import _build

#: the metrics K8 serves, in the order of the kernel's metric codes
#: (``enum Metric`` in ``csrc/unexpanded.cu``)
SUPPORTED = (
    DistanceType.L1,
    DistanceType.Linf,
    DistanceType.L2Unexpanded,
    DistanceType.L2SqrtUnexpanded,
    DistanceType.LpUnexpanded,
    DistanceType.Canberra,
    DistanceType.HammingUnexpanded,
    DistanceType.BrayCurtis,
    DistanceType.KLDivergence,
    DistanceType.JensenShannon,
)
#: features folded per step of the twin (the reference's ``dc``)
_DC = 16

# kernel launches since import (or since a caller reset them)
LAUNCHES = 0

_FN = None


def _operands(x, y, t: DistanceType):
    if t not in SUPPORTED:
        raise ValueError(f"unexpanded_pairwise_tiled: {t} is an expanded "
                         "metric")
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1] \
            or x.device != y.device:
        raise ValueError(
            f"unexpanded_pairwise_tiled: need x [n, d], y [m, d] on one "
            f"device, got {tuple(x.shape)} on {x.device}, {tuple(y.shape)} "
            f"on {y.device}")
    dt = torch.float64 if torch.float64 in (x.dtype, y.dtype) \
        else torch.float32
    return x.to(dt).contiguous(), y.to(dt).contiguous()


def unexpanded_pairwise_tiled(x, y, t: DistanceType, p: float = 2.0,
                              workspace: int = 1 << 30) -> torch.Tensor:
    """[n, m] distances of metric ``t`` between the rows of x [n, d] and
    y [m, d] (``p``: the Minkowski exponent). On CUDA tensors K8 runs;
    on CPU tensors the twin, with ``workspace`` bytes for its chunk
    temporary."""
    x, y = _operands(x, y, t)
    if x.device.type == "cpu":
        return unexpanded_pairwise_tiled_ref(x, y, t, p, workspace)
    return _launch(x, y, t, p)


def _launch(x, y, t: DistanceType, p: float) -> torch.Tensor:
    global LAUNCHES
    if x.device.type != "cuda":
        raise DeviceError(f"unexpanded_pairwise_tiled: no kernel for "
                          f"device {x.device}")
    n, d = x.shape
    m = y.shape[0]
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if n == 0 or m == 0:
        return out
    if d == 0:
        return out.zero_()
    with torch.cuda.device(x.device):
        rc = _launcher()(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), n, m, d,
            SUPPORTED.index(t), float(p), int(x.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise DeviceError(f"unexpanded_pairwise_tiled: launch failed with "
                          f"CUDA error {rc}")
    LAUNCHES += 1
    return out


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.load("unexpanded").unexpanded_launch
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [vp, vp, vp, ll, ll, ci, ci, ctypes.c_double, ci, vp]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _kl(a, b):
    """The reference's ``_kl_term``: a ≤ 0 gives 0, b ≤ 0 < a gives
    a·log 1."""
    r = torch.where((a > 0) & (b > 0), a / torch.where(b > 0, b, 1.0), 1.0)
    return torch.where(a > 0, a * torch.log(r), 0.0)


def _terms(xs, ys, t: DistanceType, p: float):
    """Per-feature term(s) of broadcastable (xs, ys): one per accumulator
    (Bray–Curtis has two)."""
    diff = xs - ys
    if t in (DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded):
        return (diff * diff,)
    if t in (DistanceType.L1, DistanceType.Linf):
        return (diff.abs(),)
    if t == DistanceType.LpUnexpanded:
        return (diff.abs() ** p,)
    if t == DistanceType.Canberra:
        denom = xs.abs() + ys.abs()
        return (torch.where(denom == 0, 0.0,
                            diff.abs() / torch.where(denom == 0, 1.0,
                                                     denom)),)
    if t == DistanceType.HammingUnexpanded:
        return ((xs != ys).to(diff.dtype),)
    if t == DistanceType.BrayCurtis:
        return (diff.abs(), (xs + ys).abs())
    if t == DistanceType.KLDivergence:
        return (_kl(xs, ys),)
    mid = 0.5 * (xs + ys)                              # Jensen–Shannon
    return (_kl(xs, mid) + _kl(ys, mid),)


def _finalize(accs, t: DistanceType, p: float, d: int):
    a = accs[0]
    if t == DistanceType.L2SqrtUnexpanded:
        return a.sqrt()
    if t == DistanceType.LpUnexpanded:
        return a ** (1.0 / p)
    if t == DistanceType.HammingUnexpanded:
        # a true division (a Python scalar divisor becomes a product by
        # its reciprocal on the card)
        return a / a.new_tensor(float(d))
    if t == DistanceType.BrayCurtis:
        return a / accs[1].clamp_min(1e-30)
    if t == DistanceType.JensenShannon:
        return (0.5 * a).clamp_min(0.0).sqrt()
    return a


def _chunks(x, y, workspace: int):
    """(rows, xs, ys): row tiles ``rows`` of x against all of y, in feature
    chunks of 16 (xs [tile, 1, dc], ys [1, m, dc]), the [tile, m, dc] term
    temporary (×3 for intermediates) under ``workspace`` bytes."""
    n, d = x.shape
    m = y.shape[0]
    dc = min(_DC, d)
    tile = max(1, min(n, workspace // (m * dc * 3 * x.element_size())))
    for r0 in range(0, n, tile):
        rows = slice(r0, r0 + tile)
        for k0 in range(0, d, dc):
            yield rows, x[rows, None, k0:k0 + dc], y[None, :, k0:k0 + dc]


def unexpanded_pairwise_tiled_ref(x, y, t: DistanceType, p: float = 2.0,
                                  workspace: int = 1 << 30) -> torch.Tensor:
    """Plain PyTorch twin of :func:`unexpanded_pairwise_tiled`, a port of
    the reference's ``_unexpanded_jit``: row tiles of x folded over
    feature chunks of 16 into [n, m] accumulators (:func:`_chunks`). The
    CPU path and the kernel's on-card oracle."""
    x, y = _operands(x, y, t)
    n, d = x.shape
    n_acc = 2 if t == DistanceType.BrayCurtis else 1
    accs = [x.new_zeros((n, y.shape[0])) for _ in range(n_acc)]
    if d == 0:
        return accs[0]
    for rows, xs, ys in _chunks(x, y, workspace):
        for acc, tm in zip(accs, _terms(xs, ys, t, p)):
            if t == DistanceType.Linf:
                torch.maximum(acc[rows], tm.amax(2), out=acc[rows])
            else:
                acc[rows] += tm.sum(2)
    return _finalize(accs, t, p, d)


def error_bound(x, y, t: DistanceType, p: float, ref,
                workspace: int = 1 << 30) -> torch.Tensor:
    """Per-entry bound on |kernel − twin| given the twin's output ``ref``
    (the module doc's contract): E = (d + 2 + U)·u·Σ_k |term_k| on the
    sum (u the unit roundoff; U = 2 for KL's logf, 4 for JS's two over
    the Σ of each part's |·|, 10 for Lp's powf against the twin's pow),
    carried through the finalize: ``E / max(ref, √E)`` plus a rounding
    of ``ref`` under a square root, ``2·ref·E/(p·Σ)`` plus ``powf``'s
    ulp under the p-th root, ``(2d + 8)·u·ref`` for Bray–Curtis's
    quotient of two sums of non-negative terms; 0 for Linf and Hamming,
    which agree to the bit. Non-finite entries are left to the caller."""
    x, y = _operands(x, y, t)
    ref = torch.as_tensor(ref, device=x.device).to(x.dtype)
    d = x.shape[1]
    u = 2.0 ** -53 if x.dtype == torch.float64 else 2.0 ** -24
    if t in (DistanceType.Linf, DistanceType.HammingUnexpanded) or d == 0:
        return torch.zeros_like(ref)
    if t == DistanceType.BrayCurtis:
        return (2 * d + 8) * u * ref.abs()
    S = torch.zeros_like(ref)
    for rows, xs, ys in _chunks(x, y, workspace):
        if t == DistanceType.JensenShannon:
            mid = 0.5 * (xs + ys)
            part = _kl(xs, mid).abs() + _kl(ys, mid).abs()
        else:
            part = _terms(xs, ys, t, p)[0].abs()
        S[rows] += part.sum(2)
    tiny = torch.finfo(x.dtype).tiny
    U = {DistanceType.KLDivergence: 2, DistanceType.JensenShannon: 4,
         DistanceType.LpUnexpanded: 10}.get(t, 0)
    E = (d + 2 + U) * u * S
    if t == DistanceType.L2SqrtUnexpanded:
        return E / torch.maximum(ref, E.sqrt()).clamp_min(tiny) \
            + 2 * u * ref
    if t == DistanceType.JensenShannon:
        h = 0.5 * E
        return h / torch.maximum(ref, h.sqrt()).clamp_min(tiny) \
            + 2 * u * ref
    if t == DistanceType.LpUnexpanded:
        return 2.0 * ref * E / (p * S).clamp_min(tiny) + 10 * u * ref
    return E
