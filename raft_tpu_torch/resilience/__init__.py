"""raft_tpu_torch.resilience — deadline scopes, fault injection and the
retry and degradation records.

- :mod:`~raft_tpu_torch.resilience.deadline` — :func:`deadline` scopes
  that convert hangs into :class:`~raft_tpu_torch.core.error.
  DeadlineExceededError` through the thread's cancellation token.
- :mod:`~raft_tpu_torch.resilience.faults` — named injection sites armed
  by ``RAFT_TPU_FAULTS`` (the reference's DSL and kinds).
- :mod:`~raft_tpu_torch.resilience.policy` — bounded retry, the
  degradation records and the sharded merge's ladder.
"""

from raft_tpu_torch.core.error import DeadlineExceededError
from raft_tpu_torch.resilience.deadline import deadline, wait_event, yield_
from raft_tpu_torch.resilience.faults import (
    DATA_KINDS,
    FAULT_KINDS,
    INJECTIONS,
    KNOWN_SITES,
    FaultSpec,
    InjectedDeviceError,
    InjectedFault,
    InjectedOutOfMemory,
    InjectedTimeout,
    active as faults_active,
    clear as clear_faults,
    configure as configure_faults,
    fault_point,
    parse_faults,
)
from raft_tpu_torch.resilience.policy import (
    DEGRADATIONS,
    EXHAUSTED,
    MERGE_LADDER,
    RETRIES,
    PoisonedOutputError,
    PolicyTable,
    RetryPolicy,
    degradation_count,
    degradation_reasons,
    degrade_merge,
    get_policy_table,
    record_degradation,
    record_exhausted,
    record_retry,
    run_with_policy,
)

__all__ = [
    "DeadlineExceededError", "deadline", "wait_event", "yield_",
    "DATA_KINDS", "FAULT_KINDS", "INJECTIONS", "KNOWN_SITES", "FaultSpec",
    "InjectedDeviceError", "InjectedFault", "InjectedOutOfMemory",
    "InjectedTimeout", "faults_active", "clear_faults", "configure_faults",
    "fault_point", "parse_faults",
    "DEGRADATIONS", "EXHAUSTED", "MERGE_LADDER", "RETRIES",
    "PoisonedOutputError", "PolicyTable", "RetryPolicy",
    "degradation_count", "degradation_reasons", "degrade_merge",
    "get_policy_table",
    "record_degradation", "record_exhausted", "record_retry",
    "run_with_policy",
]
