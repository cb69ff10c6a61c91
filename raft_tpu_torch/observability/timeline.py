"""Typed timeline emitters: the flight-recorder event vocabulary.

Counterpart of the emitters of ``raft_tpu/observability/timeline.py``.
Every subsystem that takes part in the timeline calls one helper here,
so event shapes stay the reference's and the disabled fast path stays a
single boolean test: no helper computes an argument before checking
``recorder.enabled``.

Emitters → :data:`raft_tpu_torch.observability.flight.KNOWN_EVENT_KINDS`:

- :func:`emit_span` (``span``) — from ``spans._record``: complete
  events carrying begin + duration, bytes in/out and the range stack.
- :func:`emit_fault` / :func:`emit_retry` / :func:`emit_degradation`
  (``fault`` / ``retry`` / ``degradation``) — from
  :mod:`raft_tpu_torch.resilience`.
- :func:`emit_deadline` (``deadline``) — a scope armed or fired.
- :func:`emit_marker` (``marker``), :func:`emit_quality` (``quality``),
  :func:`emit_flow` (``flow``), :func:`emit_serving` (``serving``),
  :func:`emit_explain` (``explain``), :func:`emit_alert` (``alert``),
  :func:`emit_stall` (``stall``), :func:`emit_epilogue` (``epilogue``).

The reference's model-vs-measured drift ledger (``DriftLedger``,
``record_drift``) belongs to its benchmark fixture and is not ported.
"""

from __future__ import annotations

import time
from typing import List, Optional

from raft_tpu_torch.observability.flight import get_flight_recorder


def _now() -> float:
    return time.perf_counter()


# ------------------------------------------------------------- emitters
def emit_span(name: str, parent: str, seconds: float, bytes_in: int,
              bytes_out: int, error: bool,
              stack: Optional[List[str]] = None) -> None:
    """One completed instrumented span (ph=X, begin = now − seconds)."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("span", name, ts=_now() - seconds, dur=seconds, ph="X",
               stack=stack, range=parent, bytes_in=bytes_in,
               bytes_out=bytes_out, error=error)


def emit_fault(site: str, kind: str) -> None:
    """One injected fault firing at ``site``."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("fault", site, fault_kind=kind)


def emit_retry(site: str, attempt: int, error: str) -> None:
    """One bounded-retry attempt."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("retry", site, attempt=attempt, error=error[:200])


def emit_degradation(site: str, action: str) -> None:
    """One graceful-degradation ladder rung (policy.record_degradation)."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("degradation", site, action=action)


def emit_deadline(label: str, seconds: Optional[float], fired: bool,
                  stack: Optional[List[str]] = None) -> None:
    """A deadline scope armed (``fired=False``) or converting a hang
    into DeadlineExceededError (``fired=True``)."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("deadline", label, stack=stack, budget_seconds=seconds,
               fired=fired)


def emit_marker(name: str, **args) -> None:
    """Free-form instant (benchmark phase boundaries etc.)."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("marker", name, **args)


def emit_quality(site: str, **args) -> None:
    """One quality-plane incident (``quality`` kind): a nonzero batch
    of certificate failures, the fixup tier that absorbed them, or an
    IVF q8 exact-scan rerun — result-quality anomalies land on the same
    timeline as the perf events around them (emitted by
    :mod:`raft_tpu_torch.observability.quality`)."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("quality", site, **args)


def emit_flow(step: str, rid: int, ph: str = "t",
              outcome: Optional[str] = None, **args) -> None:
    """One per-request flow point (``flow`` kind, Chrome flow-event
    phases): ``ph="s"`` starts request ``rid``'s flow at enqueue,
    ``ph="t"`` steps it through batch assembly / dispatch / requeue on
    the batcher thread, ``ph="f"`` terminates it at completion.
    ``outcome`` annotates the terminus (``ok`` / ``shed`` / ``expired``
    / ``deadline`` / ``reject`` / ``error``). All points share the
    constant event name — Chrome binds flows on (cat, name, id), so
    one request renders as one connected arrow chain across lanes; the
    step label rides in args."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    if outcome is not None:
        args["outcome"] = outcome
    rec.record("flow", "request", ph=ph, flow_id=int(rid), step=step,
               **args)


def emit_serving(event: str, **args) -> None:
    """One serving-engine lifecycle event (``serving`` kind). ``event``
    names the step — ``enqueue`` (request admitted, with queue depth),
    ``flush`` (a coalesced micro-batch dispatched, with bucket/rows),
    ``shed`` (overload admission rejection), ``swap`` (index snapshot
    generation change), ``warmup`` (a bucket's warm-up dispatch at
    engine start), ``reject`` (request larger than the bucket ladder),
    ``mutate`` (an upsert/delete applied on the batcher) — so a
    Perfetto trace shows the queue → batch → dispatch pipeline next to
    the deadline and fault events around it."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("serving", event, lane="serving", **args)


def emit_explain(site: str, rid: int, **args) -> None:
    """One per-query explain record (``explain`` kind): the decision
    trail of a sampled live search — chosen plane with its downgrade
    reasons, probed lists, pool width, per-query certificate margins,
    fixup/rerun outcome and per-stage timings — emitted by
    :mod:`raft_tpu_torch.observability.explain` when a capture finalizes, so
    the trace shows WHY a request resolved the way it did next to the
    dispatch/flow events of the same request id."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("explain", site, rid=rid, **args)


def emit_alert(slo: str, severity: str, state: str, **args) -> None:
    """One SLO burn-rate alert transition (``alert`` kind): ``state``
    is ``firing`` (both burn windows over threshold) or ``resolved``
    (recovery cleared it) — emitted by
    :mod:`raft_tpu_torch.observability.slo` so pages line up on the same
    timeline as the sheds/deadlines that caused them."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("alert", slo, severity=severity, state=state,
               lane="slo", **args)


def emit_stall(source: str, **args) -> None:
    """One hang-watchdog stall detection (``stall`` kind): ``source``
    names the silent heartbeat (``serving-batcher``) or the overdue
    request set — emitted by :mod:`raft_tpu_torch.observability.watchdog`
    alongside the thread-stack dump it writes into the blackbox, so a
    postmortem can tell a hang from a violent crash."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("stall", source, lane="watchdog", **args)


def emit_epilogue(reason: str, **args) -> None:
    """The clean-shutdown marker (``epilogue`` kind) the blackbox
    records last: a blackbox file whose newest record is NOT an
    epilogue was a violent death (:mod:`raft_tpu_torch.observability
    .blackbox` reconstructs the verdict from exactly this)."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("epilogue", reason, lane="lifecycle", **args)
