"""raft_tpu_torch.core — handle and error vocabulary of the port."""

from raft_tpu_torch.core.error import (
    DeadlineExceededError,
    DeviceError,
    LogicError,
    RaftException,
    expects,
)
from raft_tpu_torch.core.kvp import KeyValuePair
from raft_tpu_torch.core.resources import (
    DeviceResources,
    device_resources,
    ensure_resources,
    resolve_device,
)

__all__ = [
    "DeadlineExceededError", "DeviceError", "LogicError", "RaftException", "expects",
    "KeyValuePair", "DeviceResources", "device_resources",
    "ensure_resources", "resolve_device",
]
