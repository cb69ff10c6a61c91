"""Host-side comms: the handle-injected communicator.

Counterpart of ``raft_tpu/comms/host_comms.py`` (ref: comms/
std_comms.hpp:60 ``build_comms_nccl_only``, the ``comms_t`` raft-dask
injects into each worker's handle). Host code calls a collective once for
all ranks: axis 0 of the input is the rank axis (its length the
communicator's size), each rank gets its row through :func:`~raft_tpu_
torch.parallel.spmd`, and the ranks' results come back stacked on axis
0, on the first rank's device. The host TCP point-to-point of the
reference (``isend``/``irecv``/``waitall``, its ``comms/p2p.py``) is not
ported; the device point-to-point is (:meth:`device_sendrecv`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from raft_tpu_torch.comms.comms import (Op, Status, status_from_exception)
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.resilience import fault_point


class HostComms:
    """Host-side comms over ``mesh[axis_name]``."""

    def __init__(self, mesh, axis_name: str = "x"):
        expects(axis_name in mesh.axis_names, "axis %r not in mesh",
                axis_name)
        self.mesh = mesh
        self.axis_name = axis_name
        self.size = mesh.shape[axis_name]

    def get_size(self) -> int:
        return self.size

    def get_rank_array(self):
        """[size, 1]: each rank's rank, a probe of the rank identity."""
        return self._run(lambda c, x: x + c.get_rank(),
                         torch.zeros((self.size, 1), dtype=torch.int32))

    def comm_split(self, other_axis: str) -> "HostComms":
        """(ref: comm_split → another axis of the mesh)"""
        return HostComms(self.mesh, other_axis)

    def sync_stream(self, *arrays, nothrow: bool = False) -> Status:
        """Wait for the devices' queued work (ref: std_comms::sync_stream).
        ``nothrow=True`` returns ``ABORT`` / ``ERROR`` instead of raising
        (the ``status_t`` contract)."""
        try:
            fault_point("host_sync")
            for d in {d for d in self.mesh.device_list()
                      if d.type == "cuda"}:
                torch.cuda.synchronize(d)
        except Exception as e:
            if nothrow:
                return status_from_exception(e)
            raise
        return Status.SUCCESS

    def barrier(self) -> None:
        """(ref: comms_iface::barrier)"""
        fault_point("host_barrier")
        self._run(lambda c, x: c.barrier(x),
                  torch.zeros((self.size,), dtype=torch.int32))

    # -- machinery ---------------------------------------------------------
    def _run(self, fn, x):
        """``fn(comms, row)`` on every rank, row = ``x[rank on the
        axis]``; the results stacked in axis order. Carries the
        ``host_collective`` fault site."""
        from raft_tpu_torch.parallel.mesh import rank_coords, spmd

        fault_point("host_collective")
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        expects(x.shape[0] == self.size,
                "HostComms: axis 0 (=%d) must equal comm size %d",
                x.shape[0], self.size)
        ax = self.mesh.axis_names.index(self.axis_name)
        coords = rank_coords(self.mesh)
        devs = self.mesh.device_list()
        args = [(x[c[ax]].to(d),) for c, d in zip(coords, devs)]
        outs = spmd(self.mesh, fn, args, axis=self.axis_name)
        first = {}
        for r, c in enumerate(coords):
            if all(v == 0 for i, v in enumerate(c) if i != ax):
                first[c[ax]] = r
        dev = devs[0]
        return torch.stack([torch.as_tensor(outs[first[i]]).to(dev)
                            for i in range(self.size)])

    # -- collectives (axis 0 = rank) ----------------------------------------
    def allreduce(self, x, op: Op = Op.SUM):
        return self._run(lambda c, s: c.allreduce(s, op), x)

    def bcast(self, x, root: int = 0):
        return self._run(lambda c, s: c.bcast(s, root), x)

    def reduce(self, x, root: int = 0, op: Op = Op.SUM):
        return self._run(lambda c, s: c.reduce(s, root, op), x)

    def allgather(self, x):
        return self._run(lambda c, s: c.allgather(s), x)

    def gather(self, x, root: int = 0):
        return self._run(lambda c, s: c.gather(s, root), x)

    def allgatherv(self, x, counts: Sequence[int]):
        counts = tuple(int(c) for c in counts)
        return self._run(lambda c, s: c.allgatherv(s, counts), x)

    def gatherv(self, x, counts: Sequence[int], root: int = 0):
        counts = tuple(int(c) for c in counts)
        return self._run(lambda c, s: c.gatherv(s, counts, root), x)

    def reducescatter(self, x, op: Op = Op.SUM):
        return self._run(lambda c, s: c.reducescatter(s, op), x)

    def device_sendrecv(self, x, shift: int = 1):
        return self._run(lambda c, s: c.device_sendrecv(s, shift), x)

    def device_multicast_sendrecv(self, x):
        return self._run(lambda c, s: c.device_multicast_sendrecv(s), x)
