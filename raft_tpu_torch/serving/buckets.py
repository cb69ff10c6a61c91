"""The bucket ladder: the small fixed set of batch shapes a server pads to.

Counterpart of ``raft_tpu/serving/buckets.py``, with the same results on
the same specs. Every batch the serving engine dispatches is padded up to
one of a few row counts, each warmed at start-up, topped by the fused
pipeline's query block ``Qb`` by default; smaller rungs keep a near-empty
queue from paying a full ``Qb`` of pad rows.

``RAFT_TPU_SERVING_BUCKETS`` — comma-separated row counts (each rounded
up to a multiple of 8, sorted, deduplicated; at most :data:`MAX_BUCKETS`
rungs). An unusable spec falls back to the default ladder, logged: a bad
config never breaks serving.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

from raft_tpu_torch.core import env

_log = logging.getLogger(__name__)

#: quantum every bucket rounds up to
ROW_QUANTUM = 8
#: ladder length cap: each rung is warmed per snapshot
MAX_BUCKETS = 8

BUCKETS_ENV = "RAFT_TPU_SERVING_BUCKETS"


def default_bucket_ladder(qb: int) -> Tuple[int, ...]:
    """The built-in ladder for a query block ``qb``: qb/16, qb/4, qb,
    each rounded up to the row quantum, deduplicated."""
    qb = max(ROW_QUANTUM, int(qb))
    out = []
    for b in (qb // 16, qb // 4, qb):
        b = max(ROW_QUANTUM, -(-b // ROW_QUANTUM) * ROW_QUANTUM)
        if b not in out:
            out.append(b)
    return tuple(sorted(out))


def _degrade(spec: str, reason: str, qb: int) -> Tuple[int, ...]:
    _log.warning("%s=%r is invalid (%s) — using the default bucket ladder",
                 BUCKETS_ENV, spec, reason)
    return default_bucket_ladder(qb)


def bucket_ladder(qb: int, spec: Optional[str] = None) -> Tuple[int, ...]:
    """The ladder from ``spec`` (or ``RAFT_TPU_SERVING_BUCKETS``),
    validated and normalized — ascending multiples of
    :data:`ROW_QUANTUM`, at most :data:`MAX_BUCKETS` rungs — or
    :func:`default_bucket_ladder` when it is absent or unusable."""
    spec = (env.raw(BUCKETS_ENV) or "") if spec is None else spec
    spec = spec.strip()
    if not spec:
        return default_bucket_ladder(qb)
    try:
        raw = [int(tok) for tok in spec.replace(";", ",").split(",")
               if tok.strip()]
    except ValueError as e:
        return _degrade(spec, f"not integers: {e}", qb)
    if not raw:
        return _degrade(spec, "empty ladder", qb)
    if any(b <= 0 for b in raw):
        return _degrade(spec, "buckets must be positive", qb)
    out = []
    for b in raw:
        b = -(-b // ROW_QUANTUM) * ROW_QUANTUM
        if b not in out:
            out.append(b)
    out.sort()
    if len(out) > MAX_BUCKETS:
        return _degrade(spec, f"more than {MAX_BUCKETS} rungs", qb)
    return tuple(out)


def bucket_for(n_rows: int, ladder: Sequence[int]) -> Optional[int]:
    """Smallest bucket that fits ``n_rows``, or None past the top rung."""
    for b in ladder:
        if n_rows <= b:
            return b
    return None
