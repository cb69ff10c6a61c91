"""The per-query explain plane: why did this search resolve this way?

Counterpart of ``raft_tpu/observability/explain.py``. The certificate
counters say how often certificates fail; this module keeps, for a
deterministic hash-sampled fraction of live searches
(``RAFT_TPU_EXPLAIN_FRAC``, the engine's ``explain_frac=``, or one
request's ``submit(explain=True)``), the decision record: the plane and
its parameters, the probed lists, the per-query certificate margins, the
fixup or rerun outcome and the stage timings, in a bounded ring
(``/explainz``, :func:`explain_records`).

- **Nothing allocated when off.** Capture state lives in a
  ``threading.local``; every hook (:func:`note`, :func:`note_margin`,
  :func:`stage`) is one attribute fetch and a None check when no capture
  is active (``stage`` returns a shared null context).
- **Margins stay on the card until finalize.** The certificate margin
  (``bound − (θ + err)``, per query) is held as a tensor reference
  during capture and copied to the host only when the record finalizes,
  after the batch's results were already copied for its response; the
  search path computes it only while a capture is active.
- **Deterministic sampling.** :func:`want` uses the shadow sampler's
  Knuth multiplicative hash on the request id, so both packages sample
  the same requests.

Finalized records feed the ring, an ``explain`` flight event each
(:func:`~raft_tpu_torch.observability.timeline.emit_explain`), and the
``raft_tpu_certificate_margin`` histogram per site.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from raft_tpu_torch.core import env
from raft_tpu_torch.observability.metrics import get_registry, tracing_enabled
from raft_tpu_torch.observability.quality import _sample_hash
from raft_tpu_torch.observability.timeline import emit_explain

#: per-site certificate-margin distribution (bound − θ − err; negative
#: = certificate failed, the fixup ran). Buckets span the failure tail
#: through the comfortable-pass region — the evidence ROADMAP item 2's
#: adaptive-bounds work reads.
MARGIN_HISTOGRAM = "raft_tpu_certificate_margin"
MARGIN_BUCKETS = (-100.0, -10.0, -1.0, -0.1, -0.01, 0.0,
                  0.01, 0.1, 1.0, 10.0, 100.0, 1000.0)

#: explain-ring capacity: bounded like every other evidence ring here
#: (flight recorder, latency deque) — old records fall off the back.
RING_CAPACITY = 256

EXPLAIN_FRAC_ENV = "RAFT_TPU_EXPLAIN_FRAC"

_tls = threading.local()


def _host(m) -> np.ndarray:
    """A noted margin (a tensor on any device, or an array) as float64
    numpy."""
    if hasattr(m, "detach"):
        import torch

        return m.detach().to("cpu", torch.float64).numpy()
    return np.asarray(m, np.float64)


def explain_frac_default() -> float:
    """The fleet-default capture fraction (``RAFT_TPU_EXPLAIN_FRAC``,
    clamped to [0, 1]); the engine constructor's ``explain_frac=``
    wins."""
    try:
        return max(0.0, min(1.0, float(env.get(EXPLAIN_FRAC_ENV))))
    except (TypeError, ValueError):
        return 0.0


def want(rid: int, frac: float) -> bool:
    """Deterministic per-request sampling decision (Knuth hash — the
    same coin the shadow sampler flips, so a request sampled for
    explain on one run is sampled on every run)."""
    if frac <= 0.0:
        return False
    return frac >= 1.0 or _sample_hash(rid) < frac


class _NullCtx:
    """Shared no-op context manager — what :func:`stage` returns when
    no capture is active (one object for the whole process: the
    disabled path allocates nothing)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class _StageTimer:
    __slots__ = ("_cap", "_name", "_t0")

    def __init__(self, cap: "ExplainCapture", name: str):
        self._cap = cap
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        st = self._cap.stages
        st[self._name] = st.get(self._name, 0.0) + dt
        return False


class ExplainCapture:
    """One in-flight explain record: a scratch dict the search path
    annotates through :func:`note`/:func:`note_margin`/:func:`stage`
    while active, finalized into an immutable record dict afterwards.
    Single-threaded by construction — it is installed in the capturing
    thread's ``threading.local`` and never shared."""

    __slots__ = ("rids", "data", "stages", "margins", "t0")

    def __init__(self, rids: List[int]):
        self.rids = list(rids)
        self.data: Dict = {}
        self.stages: Dict[str, float] = {}
        #: (site, device-or-host array) pairs — resolved at finalize
        self.margins: List = []
        self.t0 = time.perf_counter()

    def note(self, **kv) -> None:
        for key, value in kv.items():
            prev = self.data.get(key)
            if prev is None:
                self.data[key] = value
            elif isinstance(prev, list):
                prev.append(value)
            elif prev != value:
                self.data[key] = [prev, value]

    def finalize(self, outcome: str = "ok", **kv) -> Optional[Dict]:
        """Resolve the noted margins (ONE host transfer each — the
        batch already synchronized for its response), observe the
        margin histograms, build the record, push it to the ring and
        emit the ``explain`` flight event. Never raises."""
        try:
            record: Dict = {
                "ts": time.time(),
                "rids": self.rids,
                "outcome": outcome,
                "wall_s": round(time.perf_counter() - self.t0, 6),
            }
            record.update(self.data)
            record.update({k: v for k, v in kv.items() if v is not None})
            if self.stages:
                record["stages"] = {k: round(v, 6)
                                    for k, v in self.stages.items()}
            if self.margins:
                record["margins"] = margins = {}
                reg = get_registry()
                for site, m in self.margins:
                    arr = _host(m).ravel()
                    if arr.size == 0:
                        continue
                    arr = arr[np.isfinite(arr)]
                    if arr.size == 0:
                        continue
                    hist = reg.histogram(
                        MARGIN_HISTOGRAM, {"site": site},
                        help="Per-query certificate margin "
                             "(bound - theta - err; negative = fixup)",
                        buckets=MARGIN_BUCKETS)
                    for v in arr:
                        hist.observe(float(v))
                    entry = margins.setdefault(
                        site, {"n": 0, "min": float("inf"),
                               "n_negative": 0})
                    entry["n"] += int(arr.size)
                    entry["min"] = float(min(entry["min"], arr.min()))
                    entry["n_negative"] += int((arr < 0.0).sum())
            _ring().append(record)
            emit_explain(str(record.get("plane", "search")),
                         rid=self.rids[0] if self.rids else 0,
                         outcome=outcome,
                         riders=len(self.rids),
                         margin_min=min(
                             (m["min"] for m in
                              record.get("margins", {}).values()),
                             default=None))
            return record
        except Exception:
            return None


# -- the active-capture hooks (the search paths call these) -------------
def active() -> Optional[ExplainCapture]:
    """The calling thread's active capture, or None — THE disabled-mode
    fast path: one attribute fetch."""
    return getattr(_tls, "capture", None)


def note(**kv) -> None:
    """Annotate the active capture (no-op without one). Repeated keys
    with differing values collect into a list — a chunked search notes
    each chunk's resolution without losing any."""
    cap = getattr(_tls, "capture", None)
    if cap is None:
        return
    cap.note(**kv)


def note_margin(site: str, margin) -> None:
    """Attach one per-query certificate-margin array (a device tensor is
    held by reference and copied only at finalize) to the active
    capture. No-op without one."""
    cap = getattr(_tls, "capture", None)
    if cap is None:
        return
    cap.margins.append((site, margin))


def stage(name: str):
    """Context manager timing one pipeline stage (coarse/fine/rescore/
    merge/dispatch) into the active capture; the shared null context
    when none is active."""
    cap = getattr(_tls, "capture", None)
    return _NULL_CTX if cap is None else _StageTimer(cap, name)


def begin_capture(rids) -> Optional[ExplainCapture]:
    """Install a capture for the calling thread (the engine calls this
    right before dispatching a batch with sampled riders). Returns None
    — and installs nothing — when tracing is globally disabled or a
    capture is already active (no nesting: the outer record owns the
    request)."""
    if not tracing_enabled():
        return None
    if getattr(_tls, "capture", None) is not None:
        return None
    cap = ExplainCapture(rids if isinstance(rids, (list, tuple))
                         else [rids])
    _tls.capture = cap
    return cap


def end_capture(cap: Optional[ExplainCapture], outcome: str = "ok",
                **kv) -> Optional[Dict]:
    """Uninstall ``cap`` and finalize it into the ring. Tolerates
    ``cap=None`` (the begin that returned None) so call sites stay
    branch-free."""
    if cap is None:
        return None
    if getattr(_tls, "capture", None) is cap:
        _tls.capture = None
    return cap.finalize(outcome=outcome, **kv)


# -- the record ring ----------------------------------------------------
# a bare deque(maxlen=...): append and list() are atomic under the GIL,
# and records are only ever appended whole — no lock needed for the
# bounded-evidence-ring semantics every other surface here uses
_ring_obj: collections.deque = collections.deque(maxlen=RING_CAPACITY)


def _ring() -> collections.deque:
    return _ring_obj


def explain_records(outcome: Optional[str] = None,
                    limit: Optional[int] = None) -> List[Dict]:
    """Snapshot of the ring, NEWEST first, optionally filtered by
    outcome (``ok`` / ``error`` / ``deadline`` — the ``/explainz``
    query surface)."""
    records = list(_ring_obj)
    records.reverse()
    if outcome is not None:
        records = [r for r in records if r.get("outcome") == outcome]
    if limit is not None:
        records = records[:max(0, int(limit))]
    return [dict(r) for r in records]


def clear_records() -> None:
    """Drop the ring (tests)."""
    _ring_obj.clear()
