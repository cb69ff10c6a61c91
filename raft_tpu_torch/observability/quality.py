"""Certificate and PQ-rung counters the IVF-PQ chooser reads.

Counterpart of three functions of ``raft_tpu/observability/quality.py``:
``record_certificate`` (``:137``), ``record_pq_rungs`` (``:185``) and
``measured_rerun_frac`` (``:220``), as plain host counters per call site.
The reference also feeds a metrics registry and a timeline from them; the
port keeps only the numbers (Prometheus, the explain plane and the SLO
engine are ROADMAP item 14). :func:`clear` resets everything (tests).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

_lock = threading.Lock()
# site -> [queries checked, queries that failed, reruns]
_certs: Dict[str, List[int]] = {}
# site -> [queries, certified, widened, exact reruns]
_pq_tally: Dict[str, List[int]] = {}


def record_certificate(site: str, n_queries: int, n_fail: int,
                       rerun: bool = False) -> None:
    """Count one certificate evaluation batch at ``site``: the queries
    checked, those that failed, and whether the batch reran. (The
    reference's pool-width, fixup-row and label arguments feed its
    registry and timeline, which are not ported.)"""
    with _lock:
        c = _certs.setdefault(site, [0, 0, 0])
        c[0] += max(0, int(n_queries))
        c[1] += max(0, int(n_fail))
        c[2] += int(bool(rerun))


def record_pq_rungs(site: str, certified: int, widened: int,
                    exact_rerun: int) -> None:
    """Count how many queries each rung of the PQ certification ladder
    resolved in one batch: the base pool, a widened pool, or the exact
    rerun."""
    n = [max(0, int(v)) for v in (certified, widened, exact_rerun)]
    if not sum(n):
        return
    with _lock:
        t = _pq_tally.setdefault(site, [0, 0, 0, 0])
        t[0] += sum(n)
        for i, v in enumerate(n):
            t[1 + i] += v


def measured_rerun_frac(site: str, min_checks: int = 64
                        ) -> Optional[float]:
    """The exact-rerun fraction measured at ``site`` in this process, or
    None until at least ``min_checks`` queries have walked the ladder."""
    with _lock:
        t = _pq_tally.get(site)
        if t is None or t[0] < max(1, int(min_checks)):
            return None
        return t[3] / t[0]


def certificate_counts(site: str) -> Dict[str, int]:
    """The counters of ``site``: ``checks``, ``fails``, ``reruns`` and the
    PQ rungs ``certified``, ``widened``, ``exact_rerun``."""
    with _lock:
        c = _certs.get(site, [0, 0, 0])
        t = _pq_tally.get(site, [0, 0, 0, 0])
        return {"checks": c[0], "fails": c[1], "reruns": c[2],
                "certified": t[1], "widened": t[2], "exact_rerun": t[3]}


def clear() -> None:
    """Reset every counter."""
    with _lock:
        _certs.clear()
        _pq_tally.clear()
