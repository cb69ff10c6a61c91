"""Single-controller multi-device handle (the SNMG pattern).

Counterpart of ``raft_tpu/parallel/snmg.py`` (ref: core/
device_resources_snmg.hpp:36 ``device_resources_snmg``): one child
:class:`~raft_tpu_torch.core.resources.DeviceResources` a device, the
root rank, and the mesh with its host-side comms. ``devices`` defaults to
the visible CUDA devices (raising without a card); a device may repeat.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import DeviceResources


class DeviceResourcesSNMG(DeviceResources):
    """(ref: device_resources_snmg.hpp:36)"""

    def __init__(self, devices: Optional[Sequence] = None,
                 root_rank: int = 0, seed: int = 0):
        from raft_tpu_torch.comms.host_comms import HostComms
        from raft_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(None, devices)
        devs = mesh.device_list()
        expects(0 <= root_rank < len(devs), "SNMG: bad root rank")
        super().__init__(device=devs[root_rank], seed=seed)
        self._devices = devs
        self._children: List[DeviceResources] = [
            DeviceResources(device=d, seed=seed + i)
            for i, d in enumerate(devs)]
        self.root_rank = root_rank
        self.mesh = mesh
        self.comms = HostComms(mesh, "x")
        self.subcomms: Dict[str, object] = {}

    def get_comms(self):
        return self.comms

    def comms_initialized(self) -> bool:
        return self.comms is not None

    def get_subcomm(self, axis: str):
        return self.subcomms[axis]

    def device_resources(self, rank: int) -> DeviceResources:
        """Per-device child handle. (ref: snmg ``set_device``)"""
        return self._children[rank]

    def device_count(self) -> int:
        return len(self._devices)

    def is_root_rank(self, rank: int) -> bool:
        return rank == self.root_rank
