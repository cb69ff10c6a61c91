"""The comms session: process-group bootstrap and handle injection.

Counterpart of ``raft_tpu/comms/session.py`` (ref: python/raft-dask/
raft_dask/common/comms.py:28 ``Comms``, :236 ``local_handle``, and
comms_utils.pyx ``inject_comms_on_handle``). The reference bootstraps
``jax.distributed``; the port bootstraps a ``torch.distributed`` process
group (:func:`initialize_distributed`): a ``TCPStore`` at the
coordinator's address is the rendezvous (NCCL's uniqueId broadcast, in
the reference's terms), NCCL carries CUDA tensors and gloo CPU tensors.
:func:`process_comms` is then this process's rank-local
:class:`~raft_tpu_torch.comms.comms.MeshComms` over the group, the same
vocabulary the in-process ranks of :func:`~raft_tpu_torch.parallel.spmd`
get. NCCL refuses two ranks on one device, so on one card the group runs
at world size 1; several ranks run with gloo on the CPU.

:class:`Comms` is the single-process session: a mesh over the given
devices and a handle with its :class:`HostComms` injected.
"""

from __future__ import annotations

import datetime
import uuid
from typing import Optional, Sequence, Tuple

import torch

from raft_tpu_torch.comms.comms import MeshComms, ProcessGroupTransport
from raft_tpu_torch.comms.host_comms import HostComms
from raft_tpu_torch.core.error import expects

_sessions: dict = {}


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout_s: float = 60.0) -> None:
    """Join the process group: ``coordinator_address`` is ``host:port`` of
    the ``TCPStore`` that process 0 serves, ``num_processes`` the world
    size, ``process_id`` this rank. ``backend`` defaults to
    ``"cpu:gloo,cuda:nccl"`` with a card and ``"gloo"`` without. Every
    collective and the rendezvous wait at most ``timeout_s``. A no-op
    without a coordinator (single process, as the reference's)."""
    import torch.distributed as dist

    if coordinator_address is None:
        return
    expects(num_processes is not None and process_id is not None,
            "initialize_distributed: pass num_processes and process_id")
    host, port = coordinator_address.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), int(num_processes),
                          is_master=int(process_id) == 0, timeout=timeout)
    if backend is None:
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   else "gloo")
    dist.init_process_group(backend, store=store, rank=int(process_id),
                            world_size=int(num_processes), timeout=timeout)


def process_comms(device=None, axis_name: str = "x") -> MeshComms:
    """This process's rank-local communicator over the default process
    group (see :func:`initialize_distributed`). ``device`` is where its
    collectives' tensors live: the current card by default; without a card
    it raises :class:`~raft_tpu_torch.core.error.DeviceError` (pass
    ``device="cpu"`` for a gloo group on the CPU)."""
    t = ProcessGroupTransport(None, device)
    return MeshComms(t, t.rank, axis_name)


def shutdown_distributed() -> None:
    """Leave the process group (no-op when none was joined)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class Comms:
    """Session building the communicator clique and injecting it into a
    handle (ref: raft_dask ``Comms.init``, comms.py:161)."""

    def __init__(self, devices: Optional[Sequence] = None,
                 axis_names: Tuple[str, ...] = ("x",),
                 mesh_shape: Optional[Tuple[int, ...]] = None,
                 verbose: bool = False):
        self.session_id = uuid.uuid4().hex[:16]
        self._devices = list(devices) if devices is not None else None
        self.axis_names = tuple(axis_names)
        self.mesh_shape = mesh_shape
        self.mesh = None
        self.handle = None
        self.nccl_initialized = False
        self.ucx_initialized = False

    def init(self, workers: Optional[Sequence] = None) -> None:
        """Build the mesh and its comms and inject them into a fresh
        handle (sub-communicators for the other mesh axes)."""
        from raft_tpu_torch.parallel.mesh import make_mesh
        from raft_tpu_torch.parallel.snmg import DeviceResourcesSNMG

        devs = list(workers) if workers is not None else self._devices
        if devs is None:
            devs = make_mesh().device_list()
        shape = (self.mesh_shape if self.mesh_shape is not None
                 else (len(devs),))
        expects(len(shape) == len(self.axis_names),
                "Comms.init: mesh shape %s for axes %s", shape,
                self.axis_names)
        self.mesh = make_mesh(dict(zip(self.axis_names, shape)), devs)
        handle = DeviceResourcesSNMG(devs)
        inject_comms_on_handle(handle, self.mesh, self.axis_names[0],
                               self.axis_names[1:])
        self.handle = handle
        self.nccl_initialized = True
        _sessions[self.session_id] = self

    def destroy(self) -> None:
        """(ref: comms.py:209 ``Comms.destroy``)"""
        _sessions.pop(self.session_id, None)
        self.mesh = None
        self.handle = None
        self.nccl_initialized = False

    @property
    def comms(self) -> HostComms:
        expects(self.handle is not None, "Comms not initialized")
        return self.handle.comms


def local_handle(session_id: str):
    """The session's injected handle (ref: comms.py:236)."""
    s = _sessions.get(session_id)
    return s.handle if s else None


def inject_comms_on_handle(handle, mesh, axis_name: str = "x",
                           subcomm_axes: Sequence[str] = ()) -> None:
    """Put ``mesh`` and its :class:`HostComms` on ``handle`` (``mesh``,
    ``comms`` and ``subcomms`` attributes; ref: comms_utils.pyx:248)."""
    handle.mesh = mesh
    handle.comms = HostComms(mesh, axis_name)
    handle.subcomms = {ax: HostComms(mesh, ax) for ax in subcomm_axes}
