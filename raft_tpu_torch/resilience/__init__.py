"""raft_tpu_torch.resilience — deadline scopes, and the fault-injection
seam of the mutation and durability planes (its DSL beyond the ``error``
kind, and the degradation plane, are telemetry, not ported)."""

from raft_tpu_torch.resilience.deadline import deadline, wait_event, yield_
from raft_tpu_torch.resilience.faults import (
    KNOWN_SITES,
    InjectedDeviceError,
    fault_point,
)

__all__ = ["KNOWN_SITES", "InjectedDeviceError", "deadline", "fault_point",
           "wait_event", "yield_"]
