"""Quality-of-results telemetry: certificate counters, deferred records
and the online recall shadow sampler.

Counterpart of ``raft_tpu/observability/quality.py``:

- **Certificate / fixup counters** — every certified result path (the
  serving entry ``runtime.knn_query``, ``distance.knn_fused``, the IVF
  certificates in ``ann``) reports how many queries it checked, how many
  failed the certificate and paid the exact fixup or rerun, and how wide
  its exact-rescore pool was: into the metrics registry, onto the
  timeline (a ``quality`` event per nonzero failure batch) and into the
  plain per-site counters :func:`certificate_counts` reads.
- **Deferred recording** — :func:`record_pending` queues one batch's
  stats and :func:`drain` records them the next time anyone looks
  (``statusz``, :func:`quality_block`), so the dispatch path pays one
  deque append. The port's certified pipeline already reads its failure
  count on the host (it decides the fixup), so the count queued here is
  that int and nothing new is read from the card.
- **Online recall shadow-sampling** — :class:`ShadowSampler` re-runs a
  fraction of live serving requests against the exact oracle on a
  background thread, keeps a rolling ``recall@k`` gauge, and emits a
  ``drift`` flight event and a breach count when the rolling recall
  drops below a floor.

Env knobs: ``RAFT_TPU_SERVING_SHADOW_FRAC`` (fraction of live requests
shadow sampled, default 0 = off), ``RAFT_TPU_SERVING_SHADOW_FLOOR``
(rolling-recall floor, default 0.95), ``RAFT_TPU_DISABLE_QUALITY`` (turn
the registry and timeline side of this plane off; the plain counters the
IVF-PQ chooser reads keep counting).
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from raft_tpu_torch.observability.metrics import get_registry, tracing_enabled

# ---- the quality slice of the metric vocabulary -----------------------
#: queries whose certificate was evaluated, per site
CERT_CHECKS = "raft_tpu_certificate_checks_total"
#: queries that FAILED the certificate and paid the exact fixup
CERT_FIXUPS = "raft_tpu_certificate_fixups_total"
#: fixup batch sizes — the static tier (16/128/512/1024 or the full
#: fallback) that absorbed each nonzero failure batch
FIXUP_ROWS = "raft_tpu_certificate_fixup_rows"
#: exact-rescore candidate-pool widths (C = k + pad clamped to the pool)
RESCORE_POOL = "raft_tpu_rescore_pool_width"
#: IVF chunks whose q8 certificate failure forced an exact f32-scan rerun
IVF_RERUNS = "raft_tpu_ivf_cert_rerun_total"
#: per-rung outcomes of the PQ certification ladder
#: (rung ∈ certified / widened / exact_rerun)
PQ_RUNGS = "raft_tpu_pq_cert_rung_total"
#: running per-site fraction of PQ queries that escalated past the
#: widen rungs to the full exact rerun (the BENCH_ANN cert_rerun_frac,
#: live)
PQ_RERUN_FRAC = "raft_tpu_pq_cert_rerun_frac"
#: shadow-sampled requests re-scored against the oracle
SHADOW_SAMPLES = "raft_tpu_serving_shadow_samples_total"
#: shadow candidates dropped because the sampler queue was full
SHADOW_DROPPED = "raft_tpu_serving_shadow_dropped_total"
#: rolling recall@k of shadow-sampled responses vs the oracle
SHADOW_RECALL = "raft_tpu_serving_shadow_recall"
#: rolling-recall drops below the floor (each emits a drift event)
SHADOW_BREACHES = "raft_tpu_serving_shadow_breaches_total"

#: power-of-two-ish count buckets for fixup batch sizes / pool widths
#: (DEFAULT_TIME_BUCKETS are seconds — wrong unit for row counts)
COUNT_BUCKETS: Tuple[float, ...] = (
    1., 2., 4., 8., 16., 32., 64., 128., 256., 512., 1024., 2048., 4096.)

DEFAULT_SHADOW_FLOOR = 0.95

#: the shadow scorer takes up to this many queued samples into one oracle
#: call, waiting up to SHADOW_BATCH_WAIT_S for them to arrive: one scan of
#: the index scores them all, where one call a sample would add a full
#: index scan per sample to the card's load
SHADOW_BATCH_MAX = 16
SHADOW_BATCH_WAIT_S = 0.1

# plain per-site counters, kept whatever the tracing switches say:
# site -> [queries checked, queries that failed, reruns] and
# site -> [queries, certified, widened, exact reruns]
_lock = threading.Lock()
_certs: Dict[str, List[int]] = {}
_pq_tally: Dict[str, List[int]] = {}
SHADOW_FRAC_ENV = "RAFT_TPU_SERVING_SHADOW_FRAC"
SHADOW_FLOOR_ENV = "RAFT_TPU_SERVING_SHADOW_FLOOR"


def quality_enabled() -> bool:
    """One switch for the whole quality plane: follows the global
    tracing kill switch, plus its own opt-out."""
    return (tracing_enabled()
            and not os.environ.get("RAFT_TPU_DISABLE_QUALITY"))


def shadow_frac_default() -> float:
    """The env-configured shadow-sampling fraction (0 = off)."""
    try:
        return max(0.0, min(1.0, float(
            os.environ.get(SHADOW_FRAC_ENV, "0") or 0.0)))
    except (TypeError, ValueError):
        return 0.0


def shadow_floor_default() -> float:
    try:
        return float(os.environ.get(SHADOW_FLOOR_ENV,
                                    DEFAULT_SHADOW_FLOOR))
    except (TypeError, ValueError):
        return DEFAULT_SHADOW_FLOOR


# ---------------------------------------------------------- recording
def fixup_tier_for(n_fail: int, fix_tiers: Sequence[int],
                   n_queries: int) -> int:
    """The fixup batch size the tiered cascade dispatched for ``n_fail``
    failures (the reference's tiered cascade: the smallest eligible
    tier covering the count, else the full fallback over all
    ``n_queries``). The port's fixup runs in budgeted chunks; the tier
    is reported in the reference's terms so both packages fill the same
    histogram buckets."""
    if n_fail <= 0:
        return 0
    for t in sorted(int(t) for t in fix_tiers):
        if n_fail <= t and t < n_queries:
            return t
    return int(n_queries)


def record_certificate(site: str, n_queries: int, n_fail: int,
                       pool_width: Optional[int] = None,
                       fixup_rows: Optional[int] = None,
                       rerun: bool = False, **meta) -> None:
    """Host-side record of one certificate evaluation batch: the plain
    per-site counters, and (with the quality plane on) the registry and
    a ``quality`` timeline event. Never raises into the result path."""
    with _lock:
        c = _certs.setdefault(site, [0, 0, 0])
        c[0] += max(0, int(n_queries))
        c[1] += max(0, int(n_fail))
        c[2] += int(bool(rerun))
    if not quality_enabled():
        return
    try:
        reg = get_registry()
        labels = {"site": site}
        reg.counter(CERT_CHECKS, labels,
                    help="Queries whose exactness certificate was "
                         "evaluated").inc(max(0, int(n_queries)))
        reg.counter(CERT_FIXUPS, labels,
                    help="Queries that failed the certificate and paid "
                         "the exact fixup").inc(max(0, int(n_fail)))
        if pool_width:
            reg.histogram(RESCORE_POOL, labels,
                          help="Exact-rescore candidate-pool widths",
                          buckets=COUNT_BUCKETS).observe(int(pool_width))
        if fixup_rows:
            reg.histogram(FIXUP_ROWS, labels,
                          help="Static fixup-tier batch sizes "
                               "dispatched for failed queries",
                          buckets=COUNT_BUCKETS).observe(int(fixup_rows))
        if rerun:
            reg.counter(IVF_RERUNS, labels,
                        help="IVF q8 chunks rerun through the exact "
                             "f32 scan after a certificate failure"
                        ).inc()
        if n_fail:
            from raft_tpu_torch.observability.timeline import emit_quality

            emit_quality(site, n_fail=int(n_fail),
                         n_queries=int(n_queries),
                         fixup_rows=fixup_rows, rerun=bool(rerun),
                         **meta)
    except Exception:
        pass


def record_pq_rungs(site: str, certified: int, widened: int,
                    exact_rerun: int) -> None:
    """Host-side record of one PQ certification-ladder batch: how many
    queries each rung resolved (``certified`` = base ADC pool cleared
    the bound, ``widened`` = a 2x/4x re-ADC pool cleared it,
    ``exact_rerun`` = escalated to the full exact scan). Keeps the plain
    tally (the chooser's evidence), and with the quality plane on the
    per-rung counters and the running ``raft_tpu_pq_cert_rerun_frac``
    gauge. Never raises into the result path."""
    n = [max(0, int(v)) for v in (certified, widened, exact_rerun)]
    total = sum(n)
    if not total:
        return
    with _lock:
        t = _pq_tally.setdefault(site, [0, 0, 0, 0])
        t[0] += total
        for i, v in enumerate(n):
            t[1 + i] += v
        frac = t[3] / t[0]
    if not quality_enabled():
        return
    try:
        reg = get_registry()
        for rung, v in zip(("certified", "widened", "exact_rerun"), n):
            if v > 0:
                reg.counter(PQ_RUNGS, {"site": site, "rung": rung},
                            help="PQ queries resolved per "
                                 "certification-ladder rung").inc(v)
        reg.gauge(PQ_RERUN_FRAC, {"site": site},
                  help="Running fraction of PQ queries escalating to "
                       "the full exact rerun").set(round(frac, 6))
    except Exception:
        pass


def measured_rerun_frac(site: str,
                        min_checks: int = 64) -> Optional[float]:
    """The process-measured exact-rerun fraction at ``site``, or None
    until at least ``min_checks`` queries have walked the ladder —
    the chooser's measured-beats-modeled evidence."""
    with _lock:
        t = _pq_tally.get(site)
        if t is None or t[0] < max(1, int(min_checks)):
            return None
        return t[3] / t[0]


def certificate_counts(site: str) -> Dict[str, int]:
    """The plain counters of ``site``: ``checks``, ``fails``, ``reruns``
    and the PQ rungs ``certified``, ``widened``, ``exact_rerun``."""
    with _lock:
        c = _certs.get(site, [0, 0, 0])
        t = _pq_tally.get(site, [0, 0, 0, 0])
        return {"checks": c[0], "fails": c[1], "reruns": c[2],
                "certified": t[1], "widened": t[2], "exact_rerun": t[3]}


# pending certificate stats whose failure count is still a device value:
# (site, n_fail_device, n_queries, pool_width, fix_tiers, meta)
_PENDING_CAP = 4096
_pending: collections.deque = collections.deque(maxlen=_PENDING_CAP)
_pending_lock = threading.Lock()


def record_pending(site: str, n_fail, n_queries: int,
                   pool_width: Optional[int] = None,
                   fix_tiers: Sequence[int] = (), **meta) -> None:
    """Queue one batch's certificate stats for :func:`drain`: one deque
    append on the dispatch path. ``n_fail`` is the failure count the
    certified pipeline has already read on the host (an int, or a
    host-side array that sums to it)."""
    if not quality_enabled():
        return
    with _pending_lock:
        _pending.append((site, n_fail, int(n_queries),
                         pool_width, tuple(fix_tiers), dict(meta)))


def drain() -> int:
    """Resolve every pending certificate record into the registry;
    returns how many were drained. Safe to call from any thread; a
    conversion failure drops that entry rather than raising."""
    n = 0
    while True:
        with _pending_lock:
            if not _pending:
                return n
            site, nf, nq, pw, tiers, meta = _pending.popleft()
        try:
            n_fail = int(np.sum(np.asarray(nf)))
        except Exception:
            continue
        # the port's fixup re-solves exactly the failed rows; a caller
        # that names a tier ladder gets the reference's tier accounting
        rows = (fixup_tier_for(n_fail, tiers, nq) if tiers
                else n_fail or None)
        record_certificate(site, nq, n_fail, pool_width=pw,
                           fixup_rows=rows, **meta)
        n += 1


def pending_count() -> int:
    with _pending_lock:
        return len(_pending)


def clear() -> None:
    """Drop pending (undrained) records and every plain counter
    (tests)."""
    with _pending_lock:
        _pending.clear()
    with _lock:
        _certs.clear()
        _pq_tally.clear()


# ------------------------------------------------------------ snapshot
def quality_block(registry=None, drain_first: bool = True
                  ) -> Optional[Dict]:
    """The ``quality`` block: per-site certificate checks / fixups /
    fixup_rate, rescore-pool width stats, and the shadow-recall gauges
    when a sampler ran. None when the process recorded no quality
    telemetry at all."""
    if drain_first:
        drain()
    reg = registry if registry is not None else get_registry()
    sites: Dict[str, Dict] = {}
    pools: Dict[str, Dict] = {}
    shadow: Dict[str, float] = {}
    for metric in reg.collect():
        site = metric.labels.get("site")
        if metric.name == CERT_CHECKS and site:
            sites.setdefault(site, {})["checks"] = int(metric.value)
        elif metric.name == CERT_FIXUPS and site:
            sites.setdefault(site, {})["fixups"] = int(metric.value)
        elif metric.name == IVF_RERUNS and site:
            sites.setdefault(site, {})["cert_reruns"] = int(metric.value)
        elif metric.name == PQ_RERUN_FRAC and site:
            sites.setdefault(site, {})["pq_rerun_frac"] = round(
                float(metric.value), 6)
        elif metric.name == PQ_RUNGS and site:
            sites.setdefault(site, {}).setdefault("pq_rungs", {})[
                metric.labels.get("rung", "?")] = int(metric.value)
        elif metric.name == RESCORE_POOL and site:
            cnt = metric.count
            pools[site] = {"count": cnt,
                           "mean": round(metric.sum / cnt, 2) if cnt
                           else 0.0}
        elif metric.name == SHADOW_RECALL:
            shadow["shadow_recall"] = round(float(metric.value), 4)
        elif metric.name == SHADOW_SAMPLES:
            shadow["shadow_samples"] = int(metric.value)
        elif metric.name == SHADOW_BREACHES:
            shadow["shadow_breaches"] = int(metric.value)
    if not sites and not shadow:
        return None
    checks = sum(s.get("checks", 0) for s in sites.values())
    fixups = sum(s.get("fixups", 0) for s in sites.values())
    for s in sites.values():
        c = s.get("checks", 0)
        s["fixup_rate"] = round(s.get("fixups", 0) / c, 6) if c else 0.0
    out: Dict = {
        "fixup_rate": round(fixups / checks, 6) if checks else 0.0,
        "certificate_checks": checks,
        "certificate_fixups": fixups,
        "sites": sites,
    }
    if pools:
        out["rescore_pool_widths"] = pools
    out.update(shadow)
    return out


# ------------------------------------------------- shadow recall sampler
def _sample_hash(rid: int) -> float:
    """Deterministic per-request uniform in [0, 1) (Knuth multiplicative
    hash): the sampling decision replays bit-identically across runs and
    across the two packages."""
    return ((int(rid) * 2654435761) & 0xFFFFFFFF) / 2.0 ** 32


def recall_at_k(served_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """Mean per-row |served ∩ true| / k (ids < 0 never count)."""
    served = np.asarray(served_ids)
    true = np.asarray(true_ids)
    if served.ndim == 1:
        served = served[None]
    if true.ndim == 1:
        true = true[None]
    k = true.shape[1]
    hits = [len(set(int(i) for i in served[r] if i >= 0)
                & set(int(i) for i in true[r]))
            for r in range(true.shape[0])]
    return float(np.mean(hits)) / max(1, k)


class ShadowSampler:
    """Online recall shadow-sampling for the serving engine.

    A sampled (request, served ids) pair is queued (bounded — overload
    DROPS samples, counted, rather than backing up into the serving
    path) and re-scored on a daemon thread, up to
    :data:`SHADOW_BATCH_MAX` queued samples to one oracle call:
    ``oracle(x) -> (vals, ids)`` is the exact plane for the engine's
    current snapshot, and answers each row of ``x`` on its own. Recall@k per sample feeds a rolling window; the window
    mean is the ``raft_tpu_serving_shadow_recall`` gauge, and a mean
    below ``floor`` (after ``min_samples``) emits a ``drift`` flight
    event + breach counter — quality drift surfaces on the same
    timeline as every other anomaly.
    """

    def __init__(self, oracle: Callable, k: int, frac: float,
                 floor: Optional[float] = None, window: int = 256,
                 max_queue: int = 64, min_samples: int = 4,
                 site: str = "serving.shadow", registry=None):
        self._oracle = oracle
        self.k = int(k)
        self.frac = max(0.0, min(1.0, float(frac)))
        self.floor = (shadow_floor_default() if floor is None
                      else float(floor))
        self.site = site
        self._reg = registry
        self._window: collections.deque = collections.deque(
            maxlen=max(1, int(window)))
        self._min_samples = max(1, int(min_samples))
        self._max_queue = max(1, int(max_queue))
        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._stop = False
        self._busy = False
        self._samples = 0
        self._dropped = 0
        self._breaches = 0
        self._errors = 0
        self._flushing = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ShadowSampler":
        if self._thread is None:
            self._stop = False
            self._thread = threading.Thread(target=self._loop,
                                            name="serving-shadow",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until every queued sample is scored (tests and the
        engine's stop; the live path never waits on the shadow)."""
        import time as _time

        t_end = _time.monotonic() + timeout
        with self._cond:
            self._flushing = True
            self._cond.notify_all()
            while ((self._queue or self._busy)
                   and _time.monotonic() < t_end):
                self._cond.wait(0.01)
            self._flushing = False
            return not self._queue and not self._busy

    # -- sampling ---------------------------------------------------------
    def want(self, rid: int) -> bool:
        """Deterministic sampling decision for request ``rid``."""
        return self.frac > 0.0 and _sample_hash(rid) < self.frac

    def submit(self, rid: int, x, served_ids) -> bool:
        """Queue one sampled request; False (and a drop count) when the
        queue is full — shadow work never backs up into serving."""
        with self._cond:
            if len(self._queue) >= self._max_queue:
                self._dropped += 1
                self._metric("counter", SHADOW_DROPPED,
                             "Shadow samples dropped (queue full)")
                return False
            self._queue.append((int(rid), np.asarray(x, np.float32),
                                np.asarray(served_ids)))
            self._cond.notify_all()
        return True

    # -- the scorer thread ------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait(0.05)
                if self._stop and not self._queue:
                    return
                # gather: let a few more samples arrive, so that one
                # oracle call (one scan of the index) scores them all
                t_end = time.monotonic() + SHADOW_BATCH_WAIT_S
                while (len(self._queue) < SHADOW_BATCH_MAX
                       and not (self._stop or self._flushing)
                       and time.monotonic() < t_end):
                    self._cond.wait(max(0.0, t_end - time.monotonic()))
                items = [self._queue.popleft() for _ in range(
                    min(SHADOW_BATCH_MAX, len(self._queue)))]
                self._busy = True
            try:
                self._score_batch(items)
            except Exception:
                # the oracle failed: counted (stats()' shadow_errors),
                # never raised into serving
                with self._cond:
                    self._errors += len(items)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def _score_batch(self, items) -> None:
        """Score queued samples with one oracle call over their rows
        (each query's exact answer does not depend on its batch)."""
        _, true_ids = self._oracle(np.concatenate([x for _, x, _ in items]))
        if hasattr(true_ids, "cpu"):
            true_ids = true_ids.cpu().numpy()
        true_ids = np.asarray(true_ids)
        off = 0
        for rid, x, served in items:
            self._score(rid, served, true_ids[off:off + x.shape[0]])
            off += x.shape[0]

    def _score(self, rid: int, served_ids: np.ndarray,
               true_ids: np.ndarray) -> None:
        r = recall_at_k(served_ids, true_ids)
        with self._cond:
            self._window.append(r)
            self._samples += 1
            rolling = float(np.mean(self._window))
            breach = (self._samples >= self._min_samples
                      and rolling < self.floor)
            if breach:
                self._breaches += 1
        self._metric("counter", SHADOW_SAMPLES,
                     "Shadow-sampled requests re-scored vs the oracle")
        self._metric("gauge", SHADOW_RECALL,
                     "Rolling recall@k of served vs oracle results",
                     value=rolling)
        if breach:
            self._metric("counter", SHADOW_BREACHES,
                         "Rolling shadow recall fell below the floor")
            try:
                from raft_tpu_torch.observability.flight import \
                    get_flight_recorder

                rec = get_flight_recorder()
                if rec.enabled:
                    # quality drift rides the same event kind as
                    # model-vs-measured drift: one timeline, one alarm
                    rec.record("drift", self.site, lane="serving",
                               recall=round(rolling, 4),
                               floor=self.floor, rid=int(rid),
                               measured=True)
            except Exception:
                pass

    def _metric(self, kind: str, name: str, help: str,
                value: Optional[float] = None) -> None:
        try:
            reg = self._reg if self._reg is not None else get_registry()
            if kind == "gauge":
                reg.gauge(name, help=help).set(float(value))
            else:
                reg.counter(name, help=help).inc()
        except Exception:
            pass

    # -- queries ----------------------------------------------------------
    def snapshot(self) -> Dict:
        with self._cond:
            rolling = (float(np.mean(self._window)) if self._window
                       else None)
            return {"shadow_frac": self.frac,
                    "shadow_floor": self.floor,
                    "shadow_samples": self._samples,
                    "shadow_dropped": self._dropped,
                    "shadow_breaches": self._breaches,
                    "shadow_errors": self._errors,
                    "shadow_recall": (round(rolling, 4)
                                      if rolling is not None else None)}
