"""raft_tpu_torch.compat — the pylibraft-compatible surface of the port.
(ref: python/pylibraft: keep the names eigsh, svds, rmat, DeviceResources.)
"""

from raft_tpu_torch.compat.pylibraft import (DeviceResources, Handle,
                                             ai_wrapper, auto_sync_handle,
                                             cai_wrapper, device_ndarray,
                                             eigsh, rmat, svds)

__all__ = [
    "DeviceResources", "Handle", "auto_sync_handle", "device_ndarray",
    "ai_wrapper", "cai_wrapper", "eigsh", "svds", "rmat",
]
