"""Exporters: Prometheus text, JSON lines, summary table, Perfetto trace.

Counterpart of ``raft_tpu/observability/exporters.py``: three views of
one :class:`~raft_tpu_torch.observability.metrics.MetricsRegistry` plus
one of the flight recorder. The text is the reference's byte for byte on
the same metric calls.

- :func:`export_prometheus` — text exposition format v0.0.4,
  scrapeable as-is (the debugz ``/metricsz`` body). Histograms always
  carry the explicit cumulative ``le="+Inf"`` bucket (== ``_count``).
- :func:`export_jsonl` — one JSON object per line: first the buffered
  event stream (span ends and other events), then a snapshot line per
  metric.
- :func:`summary_table` — an aligned human-readable table.
- :func:`export_perfetto` — the flight-recorder ring as a Chrome
  trace-event object (open at https://ui.perfetto.dev): spans as
  complete slices, faults / retries / alerts as instants, per-request
  flows as arrows, lanes as named tracks (the debugz ``/flightz`` body).
- :func:`bench_results` — the newest ``benchmark`` event per name.
"""

from __future__ import annotations

import io
import json
import math
import os
from typing import Dict, Optional

from raft_tpu_torch.observability.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)


def _fmt_value(v: float) -> str:
    """Prometheus value rendering: integers without a trailing .0."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() else repr(f)


def _escape_label(v: str) -> str:
    """Label-value escaping per the text exposition format: backslash,
    double quote and newline (site names can carry paths — a literal
    backslash or an embedded newline would corrupt the scrape)."""
    return v.replace("\\", "\\\\").replace("\"", "\\\"").replace("\n", "\\n")


def _escape_help(v: str) -> str:
    """HELP-text escaping: the exposition format escapes backslash and
    newline ONLY (quotes are legal in help text). Without this a
    multi-line help string splits the ``# HELP`` line and the scraper
    rejects the whole page."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(labels: Dict[str, str], extra: Optional[Dict[str, str]] = None
               ) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    body = ",".join(f'{k}="{_escape_label(str(v))}"'
                    for k, v in sorted(merged.items()))
    return "{" + body + "}"


def export_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """Render the registry in Prometheus text exposition format v0.0.4."""
    reg = registry if registry is not None else get_registry()
    out = io.StringIO()
    seen_header = set()

    def header(name: str, kind: str) -> None:
        if name in seen_header:
            return
        seen_header.add(name)
        help_text = reg.help_of(name)
        if help_text:
            out.write(f"# HELP {name} {_escape_help(help_text)}\n")
        out.write(f"# TYPE {name} {kind}\n")

    for metric in reg.collect():
        if isinstance(metric, Counter):
            header(metric.name, "counter")
            out.write(f"{metric.name}{_label_str(metric.labels)} "
                      f"{_fmt_value(metric.value)}\n")
        elif isinstance(metric, Gauge):
            header(metric.name, "gauge")
            out.write(f"{metric.name}{_label_str(metric.labels)} "
                      f"{_fmt_value(metric.value)}\n")
        elif isinstance(metric, Histogram):
            header(metric.name, "histogram")
            cumulative = metric.cumulative_counts()
            bounds = [*metric.buckets, math.inf]
            for le, c in zip(bounds, cumulative):
                ls = _label_str(metric.labels, {"le": _fmt_value(le)})
                out.write(f"{metric.name}_bucket{ls} {c}\n")
            out.write(f"{metric.name}_sum{_label_str(metric.labels)} "
                      f"{_fmt_value(metric.sum)}\n")
            out.write(f"{metric.name}_count{_label_str(metric.labels)} "
                      f"{metric.count}\n")
    return out.getvalue()


def export_jsonl(registry: Optional[MetricsRegistry] = None,
                 events: bool = True) -> str:
    """One JSON object per line: buffered events (oldest first), then a
    ``{"type": "metric", ...}`` snapshot line per live metric."""
    reg = registry if registry is not None else get_registry()
    lines = []
    if events:
        for ev in list(reg.events):
            lines.append(json.dumps(ev, sort_keys=True, default=str))
    for metric in reg.collect():
        rec = {"type": "metric", "name": metric.name, "labels": metric.labels}
        if isinstance(metric, Counter):
            rec.update(kind="counter", value=metric.value)
        elif isinstance(metric, Gauge):
            rec.update(kind="gauge", value=metric.value)
        elif isinstance(metric, Histogram):
            rec.update(kind="histogram", sum=metric.sum, count=metric.count,
                       buckets=list(metric.buckets),
                       bucket_counts=metric.bucket_counts())
        lines.append(json.dumps(rec, sort_keys=True, default=str))
    return "\n".join(lines) + ("\n" if lines else "")


def summary_table(registry: Optional[MetricsRegistry] = None) -> str:
    """Aligned human-readable metric table. Histograms render
    count/mean/p50/p99/sum — the percentiles are bucket-interpolated
    estimates (:meth:`~raft_tpu_torch.observability.metrics.Histogram.
    percentile`), so latency histograms are actually readable in a
    ``statusz`` snapshot instead of just a sum/count pair."""
    reg = registry if registry is not None else get_registry()
    rows = []
    for metric in reg.collect():
        label_s = ",".join(f"{k}={v}" for k, v in sorted(metric.labels.items()))
        if isinstance(metric, Histogram):
            cnt = metric.count
            mean = metric.sum / cnt if cnt else 0.0
            p50, p99 = metric.percentile(50), metric.percentile(99)
            pct = (f" p50={p50:.6g} p99={p99:.6g}"
                   if p50 is not None else " p50=- p99=-")
            rows.append((metric.name, label_s,
                         f"count={cnt} mean={mean:.6g}{pct} "
                         f"sum={metric.sum:.6g}"))
        else:
            rows.append((metric.name, label_s, _fmt_value(metric.value)))
    if not rows:
        return "(no metrics recorded)\n"
    w0 = max(len(r[0]) for r in rows)
    w1 = max(len(r[1]) for r in rows)
    out = io.StringIO()
    out.write(f"{'metric'.ljust(w0)}  {'labels'.ljust(w1)}  value\n")
    out.write(f"{'-' * w0}  {'-' * w1}  {'-' * 5}\n")
    for name, label_s, val in rows:
        out.write(f"{name.ljust(w0)}  {label_s.ljust(w1)}  {val}\n")
    return out.getvalue()


#: event fields consumed by the trace-event envelope itself; everything
#: else a flight event carries rides in Perfetto's ``args`` pane.
#: ``flow_id`` becomes the trace event's ``id`` (flow binding key).
_PERFETTO_ENVELOPE = ("kind", "name", "ph", "ts", "dur", "lane",
                      "flow_id")


def export_perfetto(recorder=None) -> Dict:
    """Flight-recorder ring → Chrome trace-event JSON object.

    Every flight event becomes one trace event with the REQUIRED keys
    ``ph``/``ts``/``pid``/``tid``/``name`` (+ ``dur`` for complete
    slices); ``kind`` becomes the category (``cat``), the remaining
    fields the ``args`` dict. Timestamps are the recorder's monotonic
    seconds converted to microseconds (Perfetto's unit). Lanes (thread
    names, ``comms:<axis>``, shards) map to stable ``tid``s with a
    ``thread_name`` metadata event each, so Perfetto renders one named
    track per lane. Serializable as-is with ``json.dump``.
    """
    from raft_tpu_torch.observability.flight import get_flight_recorder

    rec = recorder if recorder is not None else get_flight_recorder()
    pid = os.getpid()
    lanes: Dict[str, int] = {}
    out = []
    for ev in rec.events():
        lane = str(ev.get("lane") or "main")
        tid = lanes.get(lane)
        if tid is None:
            tid = lanes[lane] = len(lanes) + 1
        ph = ev.get("ph", "i")
        te: Dict = {
            "name": str(ev.get("name", ev.get("kind", "?"))),
            "cat": str(ev.get("kind", "event")),
            "ph": ph,
            "ts": float(ev.get("ts", 0.0)) * 1e6,
            "pid": pid,
            "tid": tid,
        }
        if ph == "X":
            te["dur"] = max(float(ev.get("dur", 0.0)), 0.0) * 1e6
        elif ph == "i":
            te["s"] = "t"          # instant scoped to its thread track
        elif ph in ("s", "t", "f"):
            # flow events bind on (cat, name, id): the per-request
            # journey (enqueue → batch → dispatch → response) renders
            # as one connected arrow chain across lanes
            te["id"] = str(int(ev.get("flow_id", 0)))
            if ph == "f":
                te["bp"] = "e"     # bind the terminus to the enclosing
                #                    slice, Chrome's recommended mode
        args = {k: v for k, v in ev.items()
                if k not in _PERFETTO_ENVELOPE and v is not None}
        if args:
            te["args"] = args
        out.append(te)
    for lane, tid in sorted(lanes.items(), key=lambda kv: kv[1]):
        out.append({"name": "thread_name", "ph": "M", "ts": 0.0,
                    "pid": pid, "tid": tid, "args": {"name": lane}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def bench_results(registry: Optional[MetricsRegistry] = None) -> Dict[str, Dict]:
    """{bench name: latest ``benchmark``-event payload} of the
    registry's event log."""
    reg = registry if registry is not None else get_registry()
    out: Dict[str, Dict] = {}
    for ev in reg.events:
        if ev.get("type") == "benchmark":
            out[ev["bench"]] = {k: v for k, v in ev.items()
                                if k not in ("type", "bench")}
    return out
