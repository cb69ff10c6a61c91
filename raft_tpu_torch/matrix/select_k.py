"""Batched top-k selection (counterpart of ``raft_tpu/matrix/select_k.py``;
ref: cpp/include/raft/matrix/select_k.cuh:75).

Semantics kept from the reference: batched rows, optional input indices
(default 0..len-1 per row), ``select_min``, sorted output.

Algorithms. ``XLA_TOPK`` — ``jax.lax.top_k``'s selection (:func:`_topk_
select`): IEEE total order, exact ties at the lower position, a −NaN first
and a +NaN last for ``select_min`` (the mirror otherwise), so values and
ids are the reference's bit for bit. ``SLOTTED`` — the certified slot
fold (``select_k_slotted``: K3 on rows of 4,096 or more). ``CHUNKED`` —
the exact per-chunk top-k and merge (``select_k_chunked``). The reference
names keep dispatching to the algorithms that play their roles: ``RADIX``
→ CHUNKED, ``BITONIC`` → SLOTTED. An explicit request outside its
algorithm's envelope warns (``RuntimeWarning``) and answers with
``XLA_TOPK``; under AUTO that fallback is silent. ``APPROX`` has no
approximate counterpart in PyTorch: the exact answer meets any recall
target. AUTO picks ``XLA_TOPK``: the reference's table of measured
timings is TPU data, and the port has none of its own yet.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.kvp import (flip_sign, select_smallest,
                                     smallest_by_key)
from raft_tpu_torch.core.resources import ensure_resources
from raft_tpu_torch.matrix.select_k_chunked import (chunked_envelope,
                                                    select_k_chunked)
from raft_tpu_torch.matrix.select_k_slotted import (select_k_slotted,
                                                    slotted_envelope)
from raft_tpu_torch.matrix.select_k_types import (SelectAlgo,
                                                  f32_comparable_keys)
from raft_tpu_torch.observability.spans import instrument
from raft_tpu_torch.resilience.faults import fault_point


def _algo_in_envelope(algo: SelectAlgo, length: int, k: int,
                      dtype=None) -> bool:
    """Whether (length, k, dtype) is inside ``algo``'s envelope — the
    predicates whose violation makes the implementations raise."""
    if algo in (SelectAlgo.SLOTTED, SelectAlgo.CHUNKED):
        if dtype is not None and not f32_comparable_keys(dtype):
            return False
    if algo == SelectAlgo.SLOTTED:
        return k <= slotted_envelope(length, k)[2]
    if algo == SelectAlgo.CHUNKED:
        return chunked_envelope(length)
    return True


def choose_select_k_algorithm(n_rows: int, length: int, k: int,
                              dtype=None) -> SelectAlgo:
    """AUTO's choice (see the module docstring)."""
    return SelectAlgo.XLA_TOPK


def _topk_select(in_val, in_idx, k: int, select_min: bool):
    """``jax.lax.top_k`` as the reference calls it: the k largest of
    ``−in_val`` (of ``in_val`` when not ``select_min``) in IEEE total
    order, exact ties at the lower position. For a float that is the k
    smallest (largest) in total order, a sign flip reversing it bit for
    bit: f32 goes through :func:`select_smallest` (one f32 top-k; rows
    with a tie across the cut or a NaN are selected again by the key) of
    the values or of their sign-flipped bits, other floats through their
    own key. No float is negated arithmetically: on the card and for
    16-bit types on the CPU that need not flip a NaN's or a zero's sign.
    An integer ``−in_val`` is ranked as the reference negates it, its wrap
    included. Values are gathered as bits."""
    if in_val.dtype == torch.float32:
        _, pos = select_smallest(in_val if select_min else flip_sign(in_val),
                                 k)
    elif in_val.dtype.is_floating_point:
        _, pos = smallest_by_key(in_val, k, descending=not select_min)
    else:
        _, pos = smallest_by_key(-in_val if select_min else in_val, k,
                                 descending=True)
    if in_val.dtype.is_floating_point:
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            in_val.element_size()]
        out_val = torch.gather(in_val.view(bits), 1, pos).view(in_val.dtype)
    else:
        out_val = torch.gather(in_val, 1, pos)
    return out_val, torch.gather(in_idx, 1, pos)


@instrument("matrix.select_k")
def select_k(res, in_val, in_idx=None, k: int = 1, select_min: bool = True,
             sorted: bool = True,  # noqa: A002
             algo: SelectAlgo = SelectAlgo.AUTO,
             recall_target: float = 0.95
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select the k smallest (or largest) entries per row.

    Returns ``(out_val [batch, k], out_idx [batch, k])``. ``in_val`` runs
    where it lies when it is a tensor, else on the handle's device."""
    fault_point("select_k")
    if isinstance(in_val, torch.Tensor):
        dev = in_val.device
    else:
        dev = ensure_resources(res).device
        in_val = torch.as_tensor(in_val, device=dev)
    expects(in_val.ndim == 2, "select_k: in_val must be [batch, len]")
    batch, length = in_val.shape
    expects(0 < k <= length, "select_k: k=%d out of range for len=%d", k,
            length)
    if in_idx is None:
        in_idx = torch.arange(length, dtype=torch.int32,
                              device=dev).expand(batch, length)
    else:
        in_idx = torch.as_tensor(in_idx, device=dev)
        expects(tuple(in_idx.shape) == tuple(in_val.shape),
                "select_k: in_idx shape mismatch")
    explicit = algo != SelectAlgo.AUTO
    if not explicit:
        algo = choose_select_k_algorithm(batch, length, k, in_val.dtype)
    if algo in (SelectAlgo.RADIX, SelectAlgo.BITONIC):
        algo = (SelectAlgo.CHUNKED if algo == SelectAlgo.RADIX
                else SelectAlgo.SLOTTED)
    if algo in (SelectAlgo.SLOTTED, SelectAlgo.CHUNKED):
        if _algo_in_envelope(algo, length, k, in_val.dtype):
            impl = (select_k_slotted if algo == SelectAlgo.SLOTTED
                    else select_k_chunked)
            return impl(in_val, in_idx, k, select_min)
        if explicit:
            # silently answering with another algorithm would invalidate
            # a benchmark or test of the named one
            warnings.warn(
                f"select_k: explicit algo={algo.name} outside its envelope "
                f"(len={length}, k={k}, dtype={in_val.dtype}); falling "
                f"back to XLA_TOPK", RuntimeWarning, stacklevel=2)
    return _topk_select(in_val, in_idx, k, select_min)
