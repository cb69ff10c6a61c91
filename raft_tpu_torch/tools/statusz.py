"""statusz — the one-page operator health snapshot of a serving process.

Counterpart of the reference repository's ``tools/statusz.py``
(:func:`render_statusz`), kept inside the port because the root
``tools`` package imports the JAX package. Rendered from the live
in-process observability surfaces, with the reference's sections:

- **quality**: certificate fixup rates per site, rescore-pool widths,
  and the online shadow recall gauge and breach count;
- **latency**: p50/p99 of every ``*_seconds`` histogram in the registry
  (bucket-interpolated), serving request latency included;
- **serving engine**: queue, batch and latency counters and
  ``builds_after_warmup``;
- **durability**: the WAL's sync mode, last and durable LSN and
  segments, the checkpoints (count, newest LSN and generation) of a
  durable engine's mutable index, and the process's last recovery;
- **SLO burn state**, the newest **explain** records, **forensics**
  (flight-ring drops, blackbox write stats, watchdog ticks and stalls,
  the prior run's crash verdict), **degradations**, the full registry
  summary table and the **flight tail**.

Served at debugz ``/statusz``.
"""

from __future__ import annotations

import io
from typing import Optional

_TAIL_DEFAULT = 16


def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "-"
    return f"{v * 1e3:.3f} ms" if v < 10 else f"{v:.3f} s"


def render_statusz(registry=None, recorder=None, engine=None,
                   tail: int = _TAIL_DEFAULT) -> str:
    """The health snapshot as one printable string. Never raises: a
    broken subsystem renders as a note, not a crash (this page is what
    an operator reads while things are broken)."""
    from raft_tpu_torch.observability import quality as q
    from raft_tpu_torch.observability.exporters import summary_table
    from raft_tpu_torch.observability.flight import get_flight_recorder
    from raft_tpu_torch.observability.metrics import Histogram, get_registry

    reg = registry if registry is not None else get_registry()
    rec = recorder if recorder is not None else get_flight_recorder()
    out = io.StringIO()
    out.write("raft_tpu_torch statusz\n======================\n\n")

    # ---- quality plane ------------------------------------------------
    out.write("quality (certificate / fixup / shadow recall)\n")
    out.write("---------------------------------------------\n")
    try:
        block = q.quality_block(registry=reg)
        if block is None:
            out.write("(no quality telemetry recorded yet)\n")
        else:
            out.write(f"fixup_rate      {block['fixup_rate']:.6f}  "
                      f"({block['certificate_fixups']} fixups / "
                      f"{block['certificate_checks']} checks)\n")
            for site, s in sorted(block.get("sites", {}).items()):
                extra = (f" reruns={s['cert_reruns']}"
                         if "cert_reruns" in s else "")
                out.write(f"  {site:<32} rate={s['fixup_rate']:.6f} "
                          f"fixups={s.get('fixups', 0)} "
                          f"checks={s.get('checks', 0)}{extra}\n")
            for site, p in sorted(
                    block.get("rescore_pool_widths", {}).items()):
                out.write(f"  {site:<32} rescore pool mean width "
                          f"{p['mean']:g} over {p['count']} batch(es)\n")
            if "shadow_recall" in block:
                out.write(f"shadow recall   {block['shadow_recall']:.4f}"
                          f" over {block.get('shadow_samples', 0)} "
                          f"sample(s), "
                          f"{block.get('shadow_breaches', 0)} "
                          f"breach(es)\n")
            else:
                out.write("shadow recall   (sampler off — set "
                          "RAFT_TPU_SERVING_SHADOW_FRAC)\n")
    except Exception as e:
        out.write(f"(quality section unavailable: {e})\n")

    # ---- latency percentiles ------------------------------------------
    out.write("\nlatency percentiles (registry histograms)\n")
    out.write("-----------------------------------------\n")
    try:
        any_h = False
        for metric in reg.collect():
            if not isinstance(metric, Histogram) or not metric.count:
                continue
            if not metric.name.endswith("_seconds"):
                continue
            any_h = True
            label_s = ",".join(f"{k}={v}" for k, v in
                               sorted(metric.labels.items()))
            name = metric.name + (f"{{{label_s}}}" if label_s else "")
            out.write(f"  {name:<48} p50={_fmt_s(metric.percentile(50))}"
                      f"  p99={_fmt_s(metric.percentile(99))}"
                      f"  n={metric.count}\n")
        if not any_h:
            out.write("(no time histograms recorded yet)\n")
    except Exception as e:
        out.write(f"(latency section unavailable: {e})\n")

    # ---- engine + degradations ----------------------------------------
    if engine is not None:
        out.write("\nserving engine\n--------------\n")
        try:
            st = engine.snapshot_stats()
            for key in ("queue_rows", "batches", "shed",
                        "expired_in_queue", "requeued", "p50_ms",
                        "p99_ms", "shadow_recall", "shadow_samples",
                        "generation", "builds_after_warmup"):
                if key in st and st[key] is not None:
                    v = st[key]
                    out.write(f"  {key:<18} "
                              f"{v:.4f}\n" if isinstance(v, float)
                              else f"  {key:<18} {v}\n")
        except Exception as e:
            out.write(f"(engine stats unavailable: {e})\n")
    # ---- durability & recovery ----------------------------------------
    out.write("\ndurability (WAL / checkpoints / recovery)\n")
    out.write("-----------------------------------------\n")
    try:
        plane = None
        if engine is not None:
            mut = getattr(engine, "mutable", None)
            plane = getattr(mut, "durability", None) if mut else None
        if plane is not None:
            st = plane.stats()
            out.write(f"wal sync={st.get('sync')}  "
                      f"last_lsn={st.get('last_lsn')}  "
                      f"durable_lsn={st.get('durable_lsn')}  "
                      f"segments={st.get('segments')}\n")
            out.write(f"checkpoints {st.get('checkpoints', 0)} "
                      f"(newest lsn={st.get('checkpoint_lsn', '-')}, "
                      f"gen={st.get('checkpoint_generation', '-')})\n")
        else:
            out.write("(no durability plane attached — "
                      "durable=False)\n")
        from raft_tpu_torch.mutable.checkpoint import last_recovery

        rec_info = last_recovery()
        if rec_info is not None:
            out.write(f"last recovery   {rec_info['seconds'] * 1e3:.1f}"
                      f" ms: {rec_info['replayed_records']} record(s) "
                      f"replayed over checkpoint "
                      f"lsn={rec_info['checkpoint_lsn']}, "
                      f"{rec_info['truncated_bytes']} torn byte(s) "
                      f"truncated\n")
        else:
            out.write("last recovery   (none this process)\n")
    except Exception as e:
        out.write(f"(durability section unavailable: {e})\n")

    # ---- SLO burn state ------------------------------------------------
    out.write("\nSLO burn state\n--------------\n")
    try:
        slo = getattr(engine, "slo", None) if engine is not None \
            else None
        if slo is None:
            out.write("(no SLO engine attached)\n")
        else:
            st = slo.status()
            out.write(f"healthy={st['healthy']}  "
                      f"covered={st['covered_s']:.1f}s\n")
            for obj in st.get("objectives", []):
                out.write(f"  {obj['slo']:<18} objective="
                          f"{obj['objective']:.4f}\n")
                for rung in obj.get("windows", []):
                    fast = rung.get("burn_fast")
                    slow = rung.get("burn_slow")
                    out.write(
                        f"    {rung['severity']:<8} "
                        f"fast={'-' if fast is None else f'{fast:.2f}'}"
                        f"  slow="
                        f"{'-' if slow is None else f'{slow:.2f}'}"
                        f"  x{rung['factor']:g}"
                        + ("  FIRING" if rung.get("firing") else "")
                        + "\n")
            for alert in st.get("active_alerts", []):
                out.write(f"  ALERT {alert['slo']}/{alert['severity']}"
                          f" burn={alert.get('burn_fast', 0):.2f}\n")
    except Exception as e:
        out.write(f"(SLO section unavailable: {e})\n")

    # ---- explain ring --------------------------------------------------
    out.write("\nexplain ring (newest records)\n")
    out.write("-----------------------------\n")
    try:
        from raft_tpu_torch.observability.explain import explain_records

        records = explain_records(limit=4)
        if not records:
            out.write("(no explain records — set RAFT_TPU_EXPLAIN_FRAC"
                      " or submit(explain=True))\n")
        for r in records:
            margins = r.get("margins", {})
            m_min = min((m["min"] for m in margins.values()),
                        default=None)
            out.write(f"  rid={r.get('rids', ['-'])[0]:<8} "
                      f"plane={r.get('plane', '?'):<9} "
                      f"outcome={r.get('outcome', '?'):<8} "
                      f"margin_min="
                      f"{'-' if m_min is None else f'{m_min:.4g}'}"
                      f"  wall={r.get('wall_s', 0) * 1e3:.1f}ms\n")
    except Exception as e:
        out.write(f"(explain section unavailable: {e})\n")

    # ---- forensics (blackbox / watchdog) -------------------------------
    out.write("\nforensics (blackbox / watchdog)\n")
    out.write("-------------------------------\n")
    try:
        from raft_tpu_torch.observability import blackbox as bb_mod
        from raft_tpu_torch.observability.flight import (FLIGHT_DROPPED,
                                                   sync_dropped_metric)

        dropped = sync_dropped_metric(rec)
        out.write(f"flight ring     seq={rec.seq} dropped={dropped} "
                  f"({FLIGHT_DROPPED})\n")
        bb = bb_mod.active()
        if bb is not None:
            st = bb.stats()
            out.write(f"blackbox        {st['path']}: "
                      f"{st['records']} record(s), "
                      f"{st['bytes_written']} bytes into "
                      f"{st['ring_bytes']}-byte ring, "
                      f"{st['append_seconds'] * 1e3:.2f} ms append "
                      f"time\n")
        else:
            out.write("blackbox        (off — set "
                      "RAFT_TPU_BLACKBOX_PATH)\n")
        wd = getattr(engine, "_watchdog", None) if engine is not None \
            else None
        if wd is not None:
            st = wd.stats()
            out.write(f"watchdog        interval={st['interval_s']:g}s "
                      f"ticks={st['ticks']} stalls={st['stalls']}"
                      + ("  STALL ACTIVE" if st["stall_active"]
                         else "") + "\n")
        else:
            out.write("watchdog        (off — set "
                      "RAFT_TPU_WATCHDOG_S)\n")
        report = getattr(engine, "crash_report", None) \
            if engine is not None else None
        if report is not None:
            out.write(f"prior run       verdict={report.get('verdict')}"
                      f" ({report.get('records')} record(s) recovered"
                      f" — see /crashz)\n")
    except Exception as e:
        out.write(f"(forensics section unavailable: {e})\n")

    out.write("\ndegradations\n------------\n")
    try:
        from raft_tpu_torch.resilience import degradation_count

        out.write(f"resilience ladder steps this process: "
                  f"{degradation_count()}\n")
    except Exception as e:
        out.write(f"(degradation count unavailable: {e})\n")

    # ---- registry summary ---------------------------------------------
    out.write("\nmetrics registry\n----------------\n")
    try:
        out.write(summary_table(reg))
    except Exception as e:
        out.write(f"(registry summary unavailable: {e})\n")

    # ---- flight tail ---------------------------------------------------
    out.write(f"\nflight tail (newest {tail} events)\n")
    out.write("----------------------------------\n")
    try:
        events = rec.tail(tail)
        if not events:
            out.write("(flight recorder empty)\n")
        for ev in events:
            extra = ev.get("step") or ev.get("action") or \
                ev.get("event") or ""
            out.write(f"  {ev.get('ts', 0.0):>12.6f}  "
                      f"{ev.get('kind', '?'):<11} "
                      f"{str(ev.get('name', '?')):<28} "
                      f"lane={ev.get('lane', '-')}"
                      + (f" [{extra}]" if extra else "") + "\n")
    except Exception as e:
        out.write(f"(flight tail unavailable: {e})\n")
    return out.getvalue()
