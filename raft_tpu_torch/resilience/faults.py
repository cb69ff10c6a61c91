"""Fault-injection seam of the mutation and durability planes.

Counterpart of the part of ``raft_tpu/resilience/faults.py`` that those
planes call: ``fault_point(site)`` at the reference's seven sites
(:data:`KNOWN_SITES`), armed by :func:`configure` and disarmed by
:func:`clear`. Unarmed, a site is one module-global boolean check. Of the
reference's DSL (``site:kind[@call=N][:p=F]``) the port takes the
``error`` kind, firing on every call or on exactly the Nth
(``@call=N``), which is what the durability tests arm; an armed ``error``
raises :class:`InjectedDeviceError`. The other kinds, the probability
trigger, the ``RAFT_TPU_FAULTS`` env loader, the injection counters and
the degradation ladder are ROADMAP item 14.

The SIGKILL crash matrix (``tests/_torch_crash_worker.py``) wraps
:func:`fault_point` to kill its process at the Nth call to a site.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from raft_tpu_torch.core.error import DeviceError

#: site → kinds meaningful there (the reference's entries for these sites)
KNOWN_SITES: Dict[str, Tuple[str, ...]] = {
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

#: the kinds the port's seam arms
FAULT_KINDS = ("error",)


class InjectedDeviceError(DeviceError):
    """An injected ``error`` at a fault site."""


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: site, kind and trigger (with its call state)."""

    site: str
    kind: str
    nth_call: Optional[int] = None    # fire exactly on this call (1-based)
    calls: int = 0
    fired: int = 0

    def should_fire(self) -> bool:
        self.calls += 1
        return self.nth_call is None or self.calls == self.nth_call


def parse_faults(spec: str) -> List[FaultSpec]:
    """Parse ``site:error[@call=N]`` entries joined by ``;``. Raises
    ``ValueError`` on a malformed entry or a kind the port does not arm."""
    out: List[FaultSpec] = []
    for raw in spec.split(";"):
        entry = raw.strip()
        if not entry:
            continue
        tokens = [t.strip() for t in entry.split(":")]
        if len(tokens) != 2:
            raise ValueError(f"fault entry {entry!r}: want "
                             f"site:kind[@call=N]")
        site, kind_tok = tokens
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
        out.append(FaultSpec(site=site, kind=kind, nth_call=nth))
    return out


_lock = threading.Lock()
_active: Dict[str, List[FaultSpec]] = {}
_armed = False          # module-global flag: the unarmed fast path


def _install(specs: List[FaultSpec]) -> None:
    global _armed
    with _lock:
        _active.clear()
        for s in specs:
            _active.setdefault(s.site, []).append(s)
        _armed = bool(_active)


def configure(spec: str) -> List[FaultSpec]:
    """Arm faults (tests). Replaces the current set; raises on a malformed
    spec. Returns the installed specs (their call state is live)."""
    specs = parse_faults(spec)
    _install(specs)
    return specs


def clear() -> None:
    """Disarm every fault."""
    _install([])


def fault_point(site: str) -> None:
    """The per-site hook: a pass-through unless a fault is armed at
    ``site``, and then raises :class:`InjectedDeviceError` on the call
    its trigger names. Thread-safe."""
    if not _armed:
        return
    with _lock:
        specs = _active.get(site)
        if not specs:
            return
        firing = None
        for s in specs:
            if s.should_fire():
                s.fired += 1
                firing = s
                break
        if firing is None:
            return
    from raft_tpu_torch.core.logger import log_warn

    log_warn("fault injected: site=%s kind=%s (call %d)", site,
             firing.kind, firing.calls)
    raise InjectedDeviceError(f"injected INTERNAL error at {site!r}")
