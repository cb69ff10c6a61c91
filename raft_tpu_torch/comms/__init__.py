"""raft_tpu_torch.comms — the comms vocabulary over in-process ranks and
torch.distributed process groups (counterpart of ``raft_tpu/comms``; the
host TCP point-to-point of its ``p2p`` module is not ported)."""

from raft_tpu_torch.comms.comms import (
    COMMS_BYTES,
    COMMS_CALLS,
    CollectiveError,
    ColorComms,
    DataType,
    LocalGroup,
    MeshComms,
    Op,
    ProcessGroupTransport,
    Status,
    get_type,
    status_from_exception,
)
from raft_tpu_torch.comms.host_comms import HostComms
from raft_tpu_torch.comms.session import (
    Comms,
    initialize_distributed,
    inject_comms_on_handle,
    local_handle,
    process_comms,
    shutdown_distributed,
)
from raft_tpu_torch.comms import test_battery
from raft_tpu_torch.comms.mpi import detect_mpi_environment, initialize_mpi_comms

__all__ = [
    "COMMS_BYTES", "COMMS_CALLS", "CollectiveError", "ColorComms",
    "DataType", "LocalGroup", "MeshComms", "Op", "ProcessGroupTransport",
    "Status", "get_type", "status_from_exception", "HostComms", "Comms",
    "initialize_distributed", "inject_comms_on_handle", "local_handle",
    "process_comms", "shutdown_distributed", "test_battery",
    "detect_mpi_environment", "initialize_mpi_comms",
]
