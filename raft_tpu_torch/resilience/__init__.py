"""raft_tpu_torch.resilience — deadline scopes (the fault-injection and
degradation planes of the reference are telemetry, not ported)."""

from raft_tpu_torch.resilience.deadline import deadline, wait_event, yield_

__all__ = ["deadline", "wait_event", "yield_"]
