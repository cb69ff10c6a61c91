"""Typed accessors of the environment knobs the port reads.

Counterpart of ``raft_tpu/core/env.py``, holding only the knobs of the
ported paths, with the reference's names, types and defaults. Read them
through :func:`get` (typed, defaulted) or :func:`raw` (stripped string or
None); an undeclared name raises ``KeyError``. Unset or empty values mean
the default; an unparseable ``int``/``float`` or an unknown ``enum`` value
falls back to the default, as the reference's tolerant reads do.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

_UNSET = object()


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    type: str                  # str | int | float | path | enum
    default: object
    doc: str
    choices: Tuple[str, ...] = ()


KNOBS: Dict[str, Knob] = {}


def _knob(name: str, type: str, default, doc: str,
          choices: Tuple[str, ...] = ()) -> None:
    KNOBS[name] = Knob(name, type, default, doc, choices)


_knob("RAFT_TPU_DB_DTYPE", "enum", None,
      "fleet default database storage dtype for serving snapshot builds",
      choices=("int8", "bf16", "f32"))
_knob("RAFT_TPU_SERVING_BUCKETS", "str", None,
      "serving bucket ladder (comma-separated row counts)")
_knob("RAFT_TPU_SERVING_FLUSH_MS", "float", 2.0,
      "serving flush window for partial batches (ms)")
_knob("RAFT_TPU_SERVING_QUEUE_CAP", "int", 4096,
      "serving queue cap in query rows (admission sheds past it)")
_knob("RAFT_TPU_SERVING_DEADLINE_S", "float", None,
      "default per-request deadline budget (unset = none)")
_knob("RAFT_TPU_IVF_PQ_SCAN", "enum", "auto",
      "IVF-PQ schedule: the list-major ADC kernel over the codes slab, "
      "the uncompressed flat fine scan, or the cost-model crossover "
      "(read per call)",
      choices=("auto", "pq", "flat"))
_knob("RAFT_TPU_IVF_FINE_SCAN", "enum", "auto",
      "IVF-Flat fine-scan schedule for callers that pass none: the "
      "list-major kernel, the query-major gather, or the cost-model "
      "crossover (read per call)",
      choices=("auto", "query", "list"))
_knob("RAFT_TPU_ANN_PQ_BITS", "int", 8,
      "default code width for build_ivf_pq callers that pass none (4 or "
      "8 bits per subspace code)")
_knob("RAFT_TPU_ANN_PQ_MODE", "enum", "plain",
      "default build_ivf_pq quantizer mode: plain PQ, an OPQ learned "
      "rotation, or OPQ plus score-aware anisotropic codeword assignment",
      choices=("plain", "opq", "opq_aniso"))
_knob("RAFT_TPU_COMPACT_THRESHOLD", "int", 1024,
      "delta slots that trigger the background compaction fold")
_knob("RAFT_TPU_DELTA_CAP", "int", None,
      "delta slab capacity (default 2x threshold, 8-row quantum)")
_knob("RAFT_TPU_DURABLE_DIR", "path", None,
      "durability-plane directory for ServingEngine(durable=True)")
_knob("RAFT_TPU_WAL_SYNC", "enum", "batch",
      "WAL fsync policy", choices=("always", "batch", "none"))
_knob("RAFT_TPU_WAL_SEGMENT_MB", "float", 64.0,
      "WAL segment rotation size (MB)")
_knob("RAFT_TPU_ANN_PQ_WIDEN", "int", 4,
      "max widen factor for the PQ certificate middle rung (1 disables "
      "widening; >=2 allows the 512-slot re-ADC pool, >=4 the 1024-slot "
      "pool)")

# -- operations planes ---------------------------------------------------
_knob("RAFT_TPU_EXPLAIN_FRAC", "float", 0.0,
      "per-query explain-capture sampling fraction of live searches "
      "(0 = off; constructor explain_frac= wins)")
_knob("RAFT_TPU_DEBUGZ_PORT", "int", None,
      "start the debugz HTTP server on this localhost port at engine "
      "start (0 = ephemeral; unset = no server)")
_knob("RAFT_TPU_BLACKBOX_PATH", "path", None,
      "crash-durable blackbox ring file mirroring flight events "
      "(unset = forensics off)")
_knob("RAFT_TPU_BLACKBOX_BYTES", "int", 1048576,
      "blackbox ring size in bytes (min 16 KiB)")
_knob("RAFT_TPU_WATCHDOG_S", "float", None,
      "hang-watchdog tick interval in seconds (unset/0 = off)")
_knob("RAFT_TPU_FAULTS", "str", None,
      "fault-injection DSL: site:kind[@call=N][:p=F];...")
_knob("RAFT_TPU_FAULTS_SEED", "int", None,
      "seed for probabilistic fault triggers")
_knob("RAFT_TPU_FAULT_HANG_MAX_S", "float", 30.0,
      "safety cap on injected hang faults with no deadline armed")
_knob("RAFT_TPU_RETRY_MAX", "int", None,
      "global cap on per-site recovery retries (0 = fail fast)")


def knob(name: str) -> Knob:
    """The declaration of ``name`` (KeyError when undeclared)."""
    return KNOBS[name]


def raw(name: str) -> Optional[str]:
    """The stripped string value, or None when unset or empty."""
    knob(name)
    value = os.environ.get(name)
    if value is None:
        return None
    return value.strip() or None


def get(name: str, default=_UNSET):
    """The parsed value, or the declared default (``default=`` overrides
    it) when unset, empty or unparseable."""
    k = knob(name)
    fallback = k.default if default is _UNSET else default
    value = raw(name)
    if value is None:
        return fallback
    if k.type in ("str", "path"):
        return value
    if k.type == "enum":
        low = value.lower()
        return low if low in k.choices else fallback
    try:
        return int(value) if k.type == "int" else float(value)
    except ValueError:
        return fallback
