"""raft_tpu_torch.core — handle and error vocabulary of the port."""

from raft_tpu_torch.core.error import (
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
    "DeviceError", "LogicError", "RaftException", "expects",
    "KeyValuePair", "DeviceResources", "device_resources",
    "ensure_resources", "resolve_device",
]
