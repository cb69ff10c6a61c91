"""Recovery policies: bounded retry, and the degradation records.

Counterpart of the retry and record half of
``raft_tpu/resilience/policy.py``:

- **Retry** (:func:`run_with_policy`): re-run the same work a bounded
  number of times with optional backoff — right for transient device
  errors and for nth-call injected faults. Every retry is counted
  (``raft_tpu_recovery_retries_total{site}``) and emitted as a ``retry``
  timeline event; exhaustion is counted and re-raises the last error. A
  :class:`~raft_tpu_torch.core.error.DeadlineExceededError` is never
  retried: a deadline is the caller's global budget, not a transient.
- **Degradation records** (:func:`record_degradation`): every step a
  path takes below its configured rung (the serving engine's
  ``shed:overload``, the IVF schedules' fall-backs) is counted under
  ``raft_tpu_degradations_total{site,action}`` and emitted as a
  ``degradation`` event; :func:`degradation_count` and
  :func:`degradation_reasons` read them back.

The reference's fused OOM ladder (``fused_degradation_ladder``) walks
TPU grid orders, and its merge ladder (``degrade_merge``) belongs to the
sharded merge; neither is ported (ROADMAP items 15 and 7).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from raft_tpu_torch.core import env
from raft_tpu_torch.core.error import (DeadlineExceededError, DeviceError,
                                       OutOfMemoryError)

RETRIES = "raft_tpu_recovery_retries_total"
EXHAUSTED = "raft_tpu_recovery_exhausted_total"
DEGRADATIONS = "raft_tpu_degradations_total"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded-retry parameters for one site."""

    max_retries: int = 2
    backoff_s: float = 0.0
    backoff_mult: float = 2.0
    retry_on: Tuple[type, ...] = (OutOfMemoryError, DeviceError)


DEFAULT_POLICY = RetryPolicy()

# site (or site prefix before the first dot) → policy
DEFAULT_POLICIES: Dict[str, RetryPolicy] = {
    "runtime": RetryPolicy(max_retries=2),
}


class PolicyTable:
    """Per-site recovery policies. Lookup falls back site → the site's
    first dotted prefix → :data:`DEFAULT_POLICY`; ``RAFT_TPU_RETRY_MAX``
    caps ``max_retries`` globally (0: every failure surfaces on the
    first attempt)."""

    def __init__(self, overrides: Optional[Dict[str, RetryPolicy]] = None):
        self._policies: Dict[str, RetryPolicy] = dict(DEFAULT_POLICIES)
        if overrides:
            self._policies.update(overrides)

    def set_policy(self, site: str, policy: RetryPolicy) -> None:
        self._policies[site] = policy

    def policy_for(self, site: str) -> RetryPolicy:
        pol = self._policies.get(site)
        if pol is None:
            pol = self._policies.get(site.split(".")[0], DEFAULT_POLICY)
        cap = env.get("RAFT_TPU_RETRY_MAX")
        if cap is not None:
            pol = dataclasses.replace(pol, max_retries=max(0, int(cap)))
        return pol


_global_table: Optional[PolicyTable] = None
_table_lock = threading.Lock()


def get_policy_table() -> PolicyTable:
    """The process-default policy table."""
    global _global_table
    with _table_lock:
        if _global_table is None:
            _global_table = PolicyTable()
        return _global_table


def _registry():
    from raft_tpu_torch.observability.metrics import get_registry

    return get_registry()


def record_retry(site: str, error: BaseException,
                 attempt: int = 0) -> None:
    """Count one retry at ``site`` (never raises)."""
    try:
        from raft_tpu_torch.observability.timeline import emit_retry

        reg = _registry()
        reg.counter(RETRIES, {"site": site},
                    help="Recovery retries, by site").inc()
        reg.emit({"type": "retry", "site": site, "attempt": attempt,
                  "error": f"{type(error).__name__}: {error}"[:200]})
        emit_retry(site, attempt, f"{type(error).__name__}: {error}")
    except Exception:
        pass


def record_exhausted(site: str) -> None:
    """Count one retry budget run out at ``site`` (never raises)."""
    try:
        _registry().counter(
            EXHAUSTED, {"site": site},
            help="Recovery attempts that ran out of retries").inc()
    except Exception:
        pass


def record_degradation(site: str, action: str) -> None:
    """Count one degradation step. ``action`` is a stable
    machine-readable label like ``shed:overload``; also emitted as a
    ``degradation`` timeline event and logged."""
    try:
        from raft_tpu_torch.observability.timeline import emit_degradation

        reg = _registry()
        reg.counter(DEGRADATIONS, {"site": site, "action": action},
                    help="Graceful-degradation ladder steps taken").inc()
        reg.emit({"type": "degradation", "site": site, "action": action})
        emit_degradation(site, action)
    except Exception:
        pass
    from raft_tpu_torch.core.logger import log_warn

    log_warn("resilience: degrading %s (%s)", site, action)


def degradation_count(registry=None) -> float:
    """Total degradation steps recorded in ``registry`` (default: the
    process-global one)."""
    reg = registry if registry is not None else _registry()
    return sum(m.value for m in reg.collect()
               if getattr(m, "name", None) == DEGRADATIONS)


def degradation_reasons(registry=None) -> list:
    """The recorded degradation steps as ``"site:action x<count>"``
    strings, sorted."""
    reg = registry if registry is not None else _registry()
    out = []
    for metric in reg.collect():
        if getattr(metric, "name", None) != DEGRADATIONS or \
                metric.value <= 0:
            continue
        labels = getattr(metric, "labels", {}) or {}
        out.append(f"{labels.get('site', '?')}:"
                   f"{labels.get('action', '?')} x{metric.value:g}")
    return sorted(out)


def run_with_policy(site: str, fn: Callable[[int], object],
                    policy: Optional[RetryPolicy] = None,
                    on_retry: Optional[Callable] = None):
    """Run ``fn(attempt)`` under ``policy``: exceptions matching
    ``retry_on`` are retried up to ``max_retries`` with backoff, and
    exhaustion re-raises the last one. Deadline errors always propagate
    at once. A CUDA out-of-memory error (``torch.cuda.
    OutOfMemoryError``) counts as :class:`OutOfMemoryError`."""
    if policy is None:
        policy = get_policy_table().policy_for(site)
    attempt = 0
    delay = policy.backoff_s
    while True:
        try:
            try:
                return fn(attempt)
            except MemoryError as e:
                raise OutOfMemoryError(f"{site}: {e}") from e
            except RuntimeError as e:
                if "out of memory" not in str(e).lower():
                    raise
                raise OutOfMemoryError(f"{site}: {e}") from e
        except DeadlineExceededError:
            raise
        except policy.retry_on as e:
            attempt += 1
            if attempt > policy.max_retries:
                record_exhausted(site)
                raise
            record_retry(site, e, attempt)
            from raft_tpu_torch.core.logger import log_warn

            log_warn("resilience: %s failed (%s: %s) — retry %d/%d",
                     site, type(e).__name__, str(e)[:120], attempt,
                     policy.max_retries)
            if on_retry is not None:
                on_retry(attempt, e)
            if delay > 0:
                time.sleep(delay)
                delay *= policy.backoff_mult
