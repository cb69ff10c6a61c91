"""Fault injection: named sites, deterministic triggers, one env knob.

Counterpart of ``raft_tpu/resilience/faults.py``. Each path the port
serves through carries a named injection site, a ``fault_point("<site>")``
call (:data:`KNOWN_SITES`), so device errors, out-of-memory, timeouts,
hangs and corrupt or poisoned data can be simulated deterministically
without touching the code under test.

DSL (env ``RAFT_TPU_FAULTS``, read at import, or :func:`configure`)::

    site:kind[@call=N][:p=F] [; site:kind ...]

    RAFT_TPU_FAULTS="serving_flush:hang@call=40;wal_fsync:error:p=0.01"

- ``kind`` ∈ :data:`FAULT_KINDS`: ``oom`` raises
  :class:`InjectedOutOfMemory`; ``error`` raises
  :class:`InjectedDeviceError`; ``timeout`` raises
  :class:`InjectedTimeout` (a recoverable device failure, not a
  deadline); ``hang`` blocks in an interruptible poll loop until a
  :func:`raft_tpu_torch.resilience.deadline` scope converts it into
  ``DeadlineExceededError`` (a safety cap, ``RAFT_TPU_FAULT_HANG_MAX_S``,
  default 30 s, raises InjectedTimeout when nothing cancels it);
  ``corrupt`` / ``nan`` do not raise: ``fault_point`` returns the kind
  and the site applies it.
- triggers: a bare kind fires on every call; ``@call=N`` on exactly the
  Nth call to that site (1-based); ``p=F`` on each call with probability
  F, derandomized by hashing (site, kind, call index,
  ``RAFT_TPU_FAULTS_SEED``), so a seed replays the same schedule.

With no fault armed a site is one module-global boolean check.
Injections are counted (``raft_tpu_fault_injections_total{site,kind}``)
and emitted as ``fault`` timeline events. The SIGKILL crash matrix of
the durability tests wraps :func:`fault_point` to kill its process at
the Nth call to a site.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Dict, List, Optional, Tuple

from raft_tpu_torch.core import env
from raft_tpu_torch.core.error import DeviceError, OutOfMemoryError

FAULT_KINDS = ("oom", "error", "timeout", "hang", "corrupt", "nan")
#: kinds fault_point RETURNS (site applies them) instead of raising
DATA_KINDS = ("corrupt", "nan")

INJECTIONS = "raft_tpu_fault_injections_total"

#: site name → kinds that are meaningful there: the reference's sites
#: and kinds, less the five that belong to unported modules
#: (``autotune_fused``, ``autotune_sharded``, ``autotune_fine_scan`` and
#: ``tune_table_read``: the TPU tuners and their tables, ``tune/*``;
#: ``plan_cache_read``: the sparse layout plan cache). ``fault_point``
#: accepts any name; ``tests/test_torch_instrumented.py`` holds every
#: site the port calls to this table.
KNOWN_SITES: Dict[str, Tuple[str, ...]] = {
    # runtime: a kernel library build on a cache miss (ops/_build.py)
    # and the serving entry's dispatch (runtime.knn_query)
    "aot_compile": ("oom", "error"),
    "aot_dispatch": ("oom", "error", "nan"),
    # fused KNN, single-device and sharded
    "knn_fused": ("oom", "error"),
    # int8 quantization at build time: a failing quantize surfaces at
    # build, never as a silently-bf16 index
    "quantize_index": ("error",),
    "sharded_dispatch": ("oom", "error", "nan"),
    "merge_permute": ("oom", "error", "timeout", "hang"),
    "merge_allgather": ("oom", "error", "timeout", "hang"),
    # select / distance / sparse / solver hot paths
    "select_k": ("oom", "error"),
    "select_k_chunked": ("oom", "error"),
    "select_k_slotted": ("oom", "error"),
    "pairwise_distance": ("oom", "error"),
    "fused_l2nn": ("oom", "error"),
    "tile_csr": ("oom", "error"),
    "spmv_sharded": ("oom", "error"),
    "solve_lap": ("oom", "error"),
    # clustering and the IVF tier: the fit and each Lloyd iteration, the
    # IVF build and search
    "kmeans_fit": ("oom", "error"),
    "kmeans_iteration": ("error",),
    "ivf_build": ("oom", "error"),
    "ivf_search": ("oom", "error"),
    # the list-major fine scan (K4), the PQ codebook and OPQ trains, the
    # ADC scan (K5) and its widen rung: the reference degrades a failure
    # at fine_scan_list, pq_scan or pq_widen to another schedule; the
    # port raises it (no fallback hides a kernel)
    "fine_scan_list": ("error", "oom"),
    "pq_train": ("error",),
    "pq_scan": ("error", "oom"),
    "opq_train": ("error",),
    "pq_widen": ("error", "oom"),
    # host-side comms
    "host_collective": ("oom", "error", "timeout", "hang"),
    "host_barrier": ("error", "timeout", "hang"),
    "host_sync": ("error", "hang"),
    # serving engine: admission at enqueue, the batch flush (dispatch of
    # a coalesced micro-batch), and the background snapshot rebuild
    "serving_enqueue": ("error",),
    "serving_flush": ("oom", "error", "timeout", "hang"),
    "serving_snapshot": ("error",),
    # mutable index: delta ingest, tombstone apply, compaction fold
    "mutate_ingest": ("error",),
    "tombstone_apply": ("error",),
    "compact_fold": ("oom", "error"),
    # durability plane: WAL append and fsync, checkpoint write and the
    # CURRENT pointer commit
    "wal_append": ("error",),
    "wal_fsync": ("error",),
    "checkpoint_write": ("error",),
    "manifest_commit": ("error",),
}


class InjectedFault:
    """Marker mixin: tells an injected failure apart from a real one
    (tests assert on it; recovery code must not — recovery treats
    injected and real failures identically)."""


class InjectedOutOfMemory(OutOfMemoryError, InjectedFault):
    """Injected device-memory exhaustion."""


class InjectedDeviceError(DeviceError, InjectedFault):
    """Injected device failure (an ``error`` at a fault site)."""


class InjectedTimeout(DeviceError, InjectedFault):
    """Injected timeout — a recoverable device failure, deliberately not
    a DeadlineExceededError: a deadline is the caller's global budget
    and is never retried."""


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: site + kind + trigger (+ mutable call state)."""

    site: str
    kind: str
    nth_call: Optional[int] = None    # fire exactly on this call (1-based)
    probability: Optional[float] = None
    calls: int = 0
    fired: int = 0

    def should_fire(self, seed: int) -> bool:
        self.calls += 1
        if self.nth_call is not None:
            return self.calls == self.nth_call
        if self.probability is not None:
            h = hashlib.sha256(
                f"{self.site}|{self.kind}|{self.calls}|{seed}".encode()
            ).digest()
            draw = int.from_bytes(h[:8], "big") / float(1 << 64)
            return draw < self.probability
        return True


def parse_faults(spec: str) -> List[FaultSpec]:
    """Parse the fault DSL (see module doc). Raises ``ValueError`` on a
    malformed entry — callers that must not raise (the env loader)
    catch and log instead."""
    out: List[FaultSpec] = []
    for raw in spec.split(";"):
        entry = raw.strip()
        if not entry:
            continue
        tokens = [t.strip() for t in entry.split(":")]
        if len(tokens) < 2:
            raise ValueError(f"fault entry {entry!r}: want site:kind[...]")
        site = tokens[0]
        kind_tok = tokens[1]
        nth = None
        if "@" in kind_tok:
            kind_tok, _, mod = kind_tok.partition("@")
            if not mod.startswith("call="):
                raise ValueError(f"fault entry {entry!r}: unknown "
                                 f"modifier {mod!r} (want @call=N)")
            nth = int(mod[len("call="):])
            if nth < 1:
                raise ValueError(f"fault entry {entry!r}: call index "
                                 f"must be ≥ 1")
        kind = kind_tok.strip().lower()
        if kind not in FAULT_KINDS:
            raise ValueError(f"fault entry {entry!r}: kind {kind!r} not "
                             f"in {FAULT_KINDS}")
        prob = None
        for extra in tokens[2:]:
            if extra.startswith("p="):
                prob = float(extra[2:])
                if not (0.0 <= prob <= 1.0):
                    raise ValueError(f"fault entry {entry!r}: p must be "
                                     f"in [0, 1]")
            elif extra.startswith("call="):
                nth = int(extra[len("call="):])
            elif extra:
                raise ValueError(f"fault entry {entry!r}: unknown "
                                 f"modifier {extra!r}")
        out.append(FaultSpec(site=site, kind=kind, nth_call=nth,
                             probability=prob))
    return out


_lock = threading.Lock()
_active: Dict[str, List[FaultSpec]] = {}
_armed = False          # module-global fast flag — THE no-fault fast path
_seed = 0


def _install(specs: List[FaultSpec], seed: Optional[int]) -> None:
    global _armed, _seed
    with _lock:
        _active.clear()
        for s in specs:
            _active.setdefault(s.site, []).append(s)
        if seed is not None:
            _seed = int(seed)
        _armed = bool(_active)


def configure(spec: str, seed: Optional[int] = None) -> List[FaultSpec]:
    """Arm faults programmatically. Replaces the current set; raises on
    a malformed spec. Returns the installed specs (their call state is
    live: ``calls`` and ``fired``)."""
    specs = parse_faults(spec)
    _install(specs, seed)
    return specs


def clear() -> None:
    """Disarm all faults (back to the zero-overhead null-object mode)."""
    _install([], None)


def active() -> bool:
    """True when any fault is armed."""
    return _armed


def _load_env() -> None:
    spec = env.raw("RAFT_TPU_FAULTS") or ""
    seed = env.raw("RAFT_TPU_FAULTS_SEED")
    if not spec:
        return
    try:
        _install(parse_faults(spec), int(seed) if seed else None)
    except (ValueError, TypeError) as e:
        from raft_tpu_torch.core.logger import log_error

        log_error("RAFT_TPU_FAULTS=%r is malformed (%s) — NO faults "
                  "armed", spec, e)


_load_env()


def _count_injection(site: str, kind: str) -> None:
    try:
        from raft_tpu_torch.observability import get_registry
        from raft_tpu_torch.observability.timeline import emit_fault

        reg = get_registry()
        reg.counter(INJECTIONS, {"site": site, "kind": kind},
                    help="Injected faults, by site and kind").inc()
        reg.emit({"type": "fault", "site": site, "kind": kind})
        emit_fault(site, kind)
    except Exception:
        pass


def _hang(site: str) -> None:
    """Block until cancelled (a deadline scope or ``cancel``): the
    injectable hang. It polls the thread's token in
    :func:`raft_tpu_torch.core.interruptible.yield_`, which raises out of
    the loop; the safety cap keeps an unguarded hang from blocking
    forever."""
    from raft_tpu_torch.core import interruptible

    max_s = env.get("RAFT_TPU_FAULT_HANG_MAX_S")
    t0 = time.monotonic()
    while time.monotonic() - t0 < max_s:
        interruptible.yield_()
        time.sleep(0.001)
    raise InjectedTimeout(
        f"injected hang at {site!r} gave up after {max_s}s with no "
        f"cancellation — guard it with resilience.deadline(...)")


def fault_point(site: str) -> Optional[str]:
    """The per-site injection hook. Returns None on the (overwhelmingly
    common) pass-through; raises for ``oom``/``error``/``timeout``
    (and ``hang``, via cancellation); returns ``"corrupt"``/``"nan"``
    for the data-plane kinds so the site applies the corruption
    itself. Thread-safe; call/fire state is per armed spec."""
    if not _armed:
        return None
    with _lock:
        specs = _active.get(site)
        if not specs:
            return None
        firing = None
        for s in specs:
            if s.should_fire(_seed):
                s.fired += 1
                firing = s
                break
        if firing is None:
            return None
    kind = firing.kind
    _count_injection(site, kind)
    from raft_tpu_torch.core.logger import log_warn

    log_warn("fault injected: site=%s kind=%s (call %d)", site, kind,
             firing.calls)
    if kind == "oom":
        raise InjectedOutOfMemory(
            f"injected RESOURCE_EXHAUSTED at {site!r}")
    if kind == "error":
        raise InjectedDeviceError(f"injected INTERNAL error at {site!r}")
    if kind == "timeout":
        raise InjectedTimeout(f"injected timeout at {site!r}")
    if kind == "hang":
        _hang(site)
    return kind          # corrupt / nan — the site applies it
