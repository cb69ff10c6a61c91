"""The comms vocabulary of the port: RAFT's ``comms_t``, rank by rank.

Counterpart of ``raft_tpu/comms/comms.py`` (ref: cpp/include/raft/core/
comms.hpp: ``datatype_t``/``op_t``, ``comms_iface`` with size/rank/
comm_split/barrier/sync_stream, the collectives and device p2p).

The reference is single-controller SPMD: ``shard_map`` traces one program
for every device of a mesh and :class:`MeshComms` lowers to XLA
collectives inside it. PyTorch's idiom is one program per rank, so here a
:class:`MeshComms` is rank-local: the rank function holds one, calls a
collective with its own tensor and gets its own result. Two transports
carry it:

- **in-process ranks** (:class:`LocalGroup`): the rank threads that
  :func:`raft_tpu_torch.parallel.spmd` starts (one a mesh device; one
  card may host several, as the reference's virtual CPU devices share a
  CPU) meet at a rendezvous; a rank reads a peer's tensor after an event
  wait on its own CUDA stream;
- **a torch.distributed process group** (:class:`ProcessGroupTransport`):
  one process a rank, NCCL for CUDA tensors and gloo for CPU tensors (see
  :mod:`raft_tpu_torch.comms.session`).

Each transport has two primitives. ``exchange`` (every rank's tensor, in
rank order, on the caller's device; ``all_gather`` on a group) carries
the gathering and reducing collectives, which fold in rank order, so both
transports give the same bits for the same calls. ``sendrecv`` (point to
point; ``batch_isend_irecv`` on a group) carries the permutes, device
send/recv and ``reducescatter``: each rank moves only the blocks
addressed to it, so a tournament round costs one block a rank, as the
merge cost model prices it. A rank that raises fails the collectives of
every other rank of its group with :class:`CollectiveError` (a
:class:`~raft_tpu_torch.core.error.DeviceError`, which the sharded
merge's ladder catches); a rendezvous that waits past its timeout fails
the same way.

Each collective adds one to ``raft_tpu_comms_calls_total{collective,axis}``
and its per-rank payload to ``raft_tpu_comms_bytes_total`` (counted by
rank 0 of the group, once a call, as the reference counts once a traced
program).
"""

from __future__ import annotations

import enum
import threading
import time
from typing import List, Optional, Sequence, Tuple

import torch

from raft_tpu_torch.core.error import DeviceError, expects

COMMS_CALLS = "raft_tpu_comms_calls_total"
COMMS_BYTES = "raft_tpu_comms_bytes_total"

#: seconds a rank waits at a rendezvous for its peers
DEFAULT_TIMEOUT_S = 300.0


class DataType(enum.Enum):
    """(ref: core/comms.hpp ``datatype_t``)"""

    CHAR = "int8"
    UINT8 = "uint8"
    INT32 = "int32"
    UINT32 = "uint32"
    INT64 = "int64"
    UINT64 = "uint64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    BFLOAT16 = "bfloat16"


def get_type(x) -> DataType:
    """T → datatype_t. (ref: core/comms.hpp ``get_type<T>()``)"""
    return DataType(str(torch.as_tensor(x).dtype).replace("torch.", ""))


class Op(enum.Enum):
    """(ref: core/comms.hpp ``op_t``)"""

    SUM = "sum"
    PROD = "prod"
    MIN = "min"
    MAX = "max"


class Status(enum.Enum):
    """(ref: core/comms.hpp ``status_t``)"""

    SUCCESS = 0
    ERROR = 1
    ABORT = 2


class CollectiveError(DeviceError):
    """A collective that could not complete: a peer rank failed, or the
    rendezvous waited past its timeout."""


def status_from_exception(exc: BaseException) -> Status:
    """A failure seen while waiting on collective work, in ``status_t``
    terms (reference ``:62``): a cancellation or expired deadline is
    ``ABORT``, any other failure ``ERROR``."""
    from raft_tpu_torch.core.error import DeadlineExceededError
    from raft_tpu_torch.core.interruptible import InterruptedException

    if isinstance(exc, (DeadlineExceededError, InterruptedException)):
        return Status.ABORT
    return Status.ERROR


def _count(collective: str, x, axis_name: str) -> None:
    """One collective call and its payload into the metrics registry."""
    from raft_tpu_torch.observability.metrics import get_registry

    reg = get_registry()
    if not reg.enabled:
        return
    labels = {"collective": collective, "axis": str(axis_name)}
    reg.counter(COMMS_CALLS, labels, help="Collective calls").inc()
    if isinstance(x, torch.Tensor):
        reg.counter(COMMS_BYTES, labels,
                    help="Per-rank payload bytes entering collectives"
                    ).inc(x.numel() * x.element_size())


def _fold(parts: Sequence[torch.Tensor], op: Op) -> torch.Tensor:
    """Reduce ``parts`` in rank order."""
    out = parts[0].clone()
    for p in parts[1:]:
        if op == Op.SUM:
            out = out + p
        elif op == Op.PROD:
            out = out * p
        elif op == Op.MIN:
            out = torch.minimum(out, p)
        elif op == Op.MAX:
            out = torch.maximum(out, p)
        else:
            raise ValueError(f"unknown op {op!r}")
    return out


def reduce_parts(parts: Sequence[torch.Tensor], op: Op = Op.SUM,
                 axis_name: str = "x", device=None) -> torch.Tensor:
    """The single controller's allreduce: the ranks' partials (rank
    order) folded in rank order on ``device`` (default the first part's),
    the bits :meth:`MeshComms.allreduce` gives every rank. Counted as one
    allreduce."""
    dev = parts[0].device if device is None else torch.device(device)
    _count("allreduce", parts[0], axis_name)
    return _fold([t.to(dev) for t in parts], op)


# ------------------------------------------------------------ transports
def _to_wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` in a dtype every backend carries (gloo has no bool or
    bfloat16)."""
    x = x.contiguous()
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    if x.dtype == torch.bfloat16 and not x.is_cuda:
        return x.view(torch.int16)
    return x


def _from_wire(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if w.dtype == dtype:
        return w
    return w.to(torch.bool) if dtype == torch.bool else w.view(dtype)


class _Round:
    __slots__ = ("parts", "left")

    def __init__(self, size: int):
        self.parts: List = [None] * size
        self.left = size


class LocalGroup:
    """The rendezvous of the in-process ranks of one communicator line:
    rank r's n-th collective meets every other rank's n-th. Ranks may
    share a device. A rank waits only for the ranks it reads from, and
    copies only what it reads. :meth:`abort` (the runner calls it when a
    rank raises) fails every waiting and later collective."""

    def __init__(self, devices: Sequence[torch.device],
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        self.timeout_s = float(timeout_s)
        self._cond = threading.Condition()
        self._rounds: dict = {}
        self._seq = [0] * self.size
        self._error: Optional[Tuple[int, BaseException]] = None

    def abort(self, rank: int, exc: BaseException) -> None:
        with self._cond:
            if self._error is None:
                self._error = (rank, exc)
            self._cond.notify_all()

    def _raise_if_failed(self, rank: int) -> None:
        if self._error is not None:
            r, e = self._error
            if r == rank and isinstance(e, CollectiveError):
                raise e
            raise CollectiveError(
                f"collective failed: rank {r} of {self.size} raised "
                f"{type(e).__name__}: {e}")

    def _meet(self, rank: int, payload, srcs: Sequence[int]) -> list:
        """Post this rank's payload for its next round and return the
        (payload, event) of each rank of ``srcs`` in that round. The event
        marks the end of the poster's work on its stream."""
        seq = self._seq[rank]
        self._seq[rank] += 1
        dev = self.devices[rank]
        ev = None
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
        t_end = time.monotonic() + self.timeout_s
        with self._cond:
            self._raise_if_failed(rank)
            rd = self._rounds.get(seq)
            if rd is None:
                rd = self._rounds[seq] = _Round(self.size)
            rd.parts[rank] = (payload, ev)
            self._cond.notify_all()
            while self._error is None and any(rd.parts[s] is None
                                              for s in srcs):
                left = t_end - time.monotonic()
                if left <= 0:
                    n = sum(q is not None for q in rd.parts)
                    err = CollectiveError(
                        f"collective timed out after {self.timeout_s} s: "
                        f"{n} of {self.size} ranks arrived")
                    if self._error is None:
                        self._error = (rank, err)
                    self._cond.notify_all()
                    raise err
                self._cond.wait(left)
            self._raise_if_failed(rank)
            got = [rd.parts[s] for s in srcs]
            rd.left -= 1
            if rd.left == 0:
                del self._rounds[seq]
        return got

    def _take(self, rank: int, t: torch.Tensor, ev, copy: bool):
        """A peer's tensor on this rank's device, after the peer's work
        that made it; ``copy`` gives a tensor of this rank's own when the
        devices are the same."""
        dev = self.devices[rank]
        if ev is not None and dev.type == "cuda":
            # the producer's work first; and the producer's stream must
            # not reuse the memory before this stream reads it
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(ev)
            t.record_stream(stream)
        if t.device != dev:
            return t.to(dev)
        return t.clone() if copy else t

    def exchange(self, rank: int, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` in rank order, on this rank's device."""
        got = self._meet(rank, x, range(self.size))
        return [t if r == rank else self._take(rank, t, e, False)
                for r, (t, e) in enumerate(got)]

    def sendrecv(self, rank: int, sends: dict, recvs: dict) -> list:
        """Point to point: post ``sends`` (dst → tensor) and return, in
        the order of ``recvs`` (src → a tensor of the expected shape and
        dtype), what each src sent to this rank."""
        got = self._meet(rank, sends, list(recvs))
        out = []
        for s, (payload, e) in zip(recvs, got):
            expects(rank in payload, "sendrecv: rank %d expected a part "
                    "from rank %d, which sent none", rank, s)
            out.append(self._take(rank, payload[rank], e, True))
        return out

    def device_of(self, rank: int) -> torch.device:
        return self.devices[rank]


class ProcessGroupTransport:
    """The collectives over a ``torch.distributed`` process group: the
    gathering ones by ``all_gather``, the point-to-point ones by
    ``batch_isend_irecv`` (NCCL for CUDA tensors, gloo for CPU tensors).
    ``device`` defaults to the current card and, as every entry point's,
    raises :class:`DeviceError` without one. A peer that fails surfaces as
    the backend's error, re-raised as :class:`CollectiveError`."""

    def __init__(self, group=None, device=None):
        import torch.distributed as dist

        from raft_tpu_torch.core.resources import resolve_device

        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def device_of(self, rank: int) -> torch.device:
        return self.device

    def exchange(self, rank: int, x: torch.Tensor) -> List[torch.Tensor]:
        import torch.distributed as dist

        wire = _to_wire(x)
        outs = [torch.empty_like(wire) for _ in range(self.size)]
        try:
            dist.all_gather(outs, wire, group=self.group)
        except Exception as e:
            raise CollectiveError(
                f"process-group all_gather failed: {type(e).__name__}: "
                f"{e}") from e
        return [_from_wire(o, x.dtype) for o in outs]

    def _peer(self, r: int) -> int:
        import torch.distributed as dist

        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def sendrecv(self, rank: int, sends: dict, recvs: dict) -> list:
        """:meth:`LocalGroup.sendrecv` over the group: one isend a
        destination, one irecv a source, in one batch; a rank's part for
        itself is copied locally."""
        import torch.distributed as dist

        ops, bufs = [], {}
        for dst, t in sends.items():
            if dst != rank:
                ops.append(dist.P2POp(dist.isend, _to_wire(t),
                                      self._peer(dst), self.group))
        for src, like in recvs.items():
            if src != rank:
                bufs[src] = torch.empty_like(_to_wire(like))
                ops.append(dist.P2POp(dist.irecv, bufs[src],
                                      self._peer(src), self.group))
        try:
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
        except Exception as e:
            raise CollectiveError(
                f"process-group send/recv failed: {type(e).__name__}: "
                f"{e}") from e
        return [sends[rank].clone() if src == rank
                else _from_wire(bufs[src], like.dtype)
                for src, like in recvs.items()]


# ------------------------------------------------------------- MeshComms
class MeshComms:
    """The rank-local communicator over one mesh axis (reference
    ``:104``): ``transport`` carries the collectives, ``rank`` is this
    rank's index along ``axis_name``. ``splits`` maps the mesh's other
    axes to this rank's communicators along them (:meth:`comm_split`)."""

    def __init__(self, transport, rank: int, axis_name: str = "x",
                 splits: Optional[dict] = None):
        self.transport = transport
        self.rank = int(rank)
        self.size = int(transport.size)
        self.axis_name = axis_name
        self._splits = splits if splits is not None else {}

    # -- topology ---------------------------------------------------------
    def get_size(self) -> int:
        """(ref: comms_iface::get_size)"""
        return self.size

    def get_rank(self) -> int:
        """(ref: comms_iface::get_rank)"""
        return self.rank

    def comm_split(self, other_axis: str,
                   size: Optional[int] = None) -> "MeshComms":
        """The communicator along another axis of the mesh: the ranks that
        share this rank's coordinates on every other axis (reference
        ``:135``; ref: comms_iface::comm_split on a 2-D grid)."""
        expects(other_axis in self._splits,
                "comm_split: axis %r is not an axis of this rank's mesh",
                other_axis)
        return self._splits[other_axis]

    def comm_split_color(self, color: int, key: Optional[int] = None
                         ) -> "ColorComms":
        """Arbitrary-color split (ref: core/comms.hpp:123 ``comm_split``):
        ranks of equal ``color`` form a clique, ordered by (key, rank)."""
        return ColorComms(self, color, key)

    def barrier(self, token=None):
        """(ref: comms_iface::barrier) Returns the sum of the ranks'
        tokens (0 without one), as the reference's psum does."""
        t = (torch.zeros((), dtype=torch.int32, device=self.device)
             if token is None else torch.as_tensor(token))
        return _fold(self.exchange(t), Op.SUM)

    def sync_stream(self, *arrays) -> Status:
        """Wait for this rank's queued work (ref: comms_iface::
        sync_stream)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return Status.SUCCESS

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.transport.device_of(self.rank)

    def exchange(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` in rank order, on this rank's device: the one
        primitive the collectives are built from."""
        return self.transport.exchange(self.rank, x)

    def _counted(self, name: str, x):
        if self.rank == 0:
            _count(name, x, self.axis_name)

    # -- collectives -------------------------------------------------------
    def allreduce(self, x, op: Op = Op.SUM):
        """(ref: comms_iface::allreduce)"""
        self._counted("allreduce", x)
        return _fold(self.exchange(x), op)

    def bcast(self, x, root: int = 0):
        """Root's ``x`` on every rank. (ref: comms_iface::bcast)"""
        self._counted("bcast", x)
        return self.exchange(x)[root].clone()

    def reduce(self, x, root: int = 0, op: Op = Op.SUM):
        """Root gets the reduction; every other rank gets its input back,
        as the reference's in-place reduce leaves it (reference
        ``:171``)."""
        self._counted("reduce", x)
        full = _fold(self.exchange(x), op)
        return full if self.rank == root else x

    def allgather(self, x):
        """[size, ...]: every rank's ``x``. (ref: comms_iface::allgather)"""
        self._counted("allgather", x)
        return torch.stack(self.exchange(x))

    def allgatherv(self, x, counts: Sequence[int]):
        """Rank r's first ``counts[r]`` rows, concatenated; every rank
        passes ``x`` padded to max(counts). (ref: comms_iface::
        allgatherv)"""
        self._counted("allgatherv", x)
        parts = self.exchange(x)
        return torch.cat([parts[i][:counts[i]] for i in range(len(counts))])

    def gather(self, x, root: int = 0):
        """Root gets [size, ...]; the other ranks zeros of that shape.
        (ref: comms_iface::gather)"""
        self._counted("gather", x)
        out = torch.stack(self.exchange(x))
        return out if self.rank == root else torch.zeros_like(out)

    def gatherv(self, x, counts: Sequence[int], root: int = 0):
        """(ref: comms_iface::gatherv)"""
        self._counted("gatherv", x)
        parts = self.exchange(x)
        out = torch.cat([parts[i][:counts[i]] for i in range(len(counts))])
        return out if self.rank == root else torch.zeros_like(out)

    def reducescatter(self, x, op: Op = Op.SUM):
        """Rank r's block of rows of the sum (axis 0 splits into size
        blocks): every rank sends block j to rank j, and each folds the
        blocks it receives in rank order. (ref: comms_iface::
        reducescatter)"""
        expects(op == Op.SUM, "reducescatter: SUM only (like psum_scatter)")
        expects(x.shape[0] % self.size == 0,
                "reducescatter: %d rows do not split over %d ranks",
                x.shape[0], self.size)
        self._counted("reducescatter", x)
        c = x.shape[0] // self.size
        blocks = {j: x[j * c:(j + 1) * c] for j in range(self.size)}
        mine = blocks[self.rank]
        return _fold(self.transport.sendrecv(
            self.rank, blocks, {j: mine for j in range(self.size)}), op)

    # -- device p2p ---------------------------------------------------------
    def _permute(self, x, dst):
        """Send ``x`` where ``dst`` says and receive from the rank that
        targets this one; only those tensors move. An int ``dst`` is a
        ring shift; with (src, dst) pairs, the last pair naming a
        destination is the one it receives."""
        if isinstance(dst, int):
            to = [(self.rank + dst) % self.size]
            frm = (self.rank - dst) % self.size
        else:
            src_of = {d: s for s, d in dst}
            to = [d for d, s in src_of.items() if s == self.rank]
            frm = src_of.get(self.rank)
        got = self.transport.sendrecv(self.rank, {d: x for d in to},
                                      {} if frm is None else {frm: x})
        return torch.zeros_like(x) if frm is None else got[0]

    def device_send(self, x, dst):
        """Counted under its own label; see :meth:`device_sendrecv`.
        (ref: comms_iface::device_send)"""
        self._counted("device_send", x)
        return self._permute(x, dst)

    def device_recv(self, x_from_permute):
        return x_from_permute

    def device_sendrecv(self, x, dst, src=None):
        """Send to ``dst`` and receive from whoever targets this rank: an
        int ``dst`` is a ring shift (receive from rank − dst); a list of
        (src, dst) pairs selects explicitly, and a rank no pair targets
        receives zeros. (ref: comms_iface::device_sendrecv)"""
        self._counted("sendrecv", x)
        return self._permute(x, dst)

    def collective_permute(self, x, perm: Sequence[Tuple[int, int]]):
        """The (src, dst) exchange of the tournament merge, counted under
        ``collective_permute`` (reference ``:235``)."""
        self._counted("collective_permute", x)
        return self._permute(x, list(perm))

    def device_multicast_sendrecv(self, x, dsts: Optional[Sequence[int]]
                                  = None):
        """(ref: comms_iface::device_multicast_sendrecv) Every rank's x,
        as the reference renders it."""
        self._counted("multicast_sendrecv", x)
        return torch.stack(self.exchange(x))

    # -- grouping ------------------------------------------------------------
    def group_start(self):
        """(ref: comms_iface::group_start) Collectives run as called."""

    def group_end(self):
        """(ref: comms_iface::group_end)"""


class ColorComms:
    """A clique of the parent communicator by color (reference ``:276``;
    ref: core/comms.hpp:123 ``comm_split(color, key)``): ranks of equal
    ``color`` form it, ordered by (key, rank). Every collective exchanges
    over the whole parent, as the reference's all_gather and mask do, so
    every parent rank must make each call. Gather-family outputs are sized
    by the parent: the first :meth:`get_size` rows hold the clique's
    values in clique-rank order, the rest are zeros."""

    def __init__(self, parent: MeshComms, color: int,
                 key: Optional[int] = None):
        self.parent = parent
        self.axis_name = parent.axis_name
        self.color = int(color)
        self.key = parent.get_rank() if key is None else int(key)
        table = parent.exchange(torch.tensor(
            [self.color, self.key], dtype=torch.int64,
            device=parent.device))
        self._colors = [int(t[0]) for t in table]
        self._keys = [int(t[1]) for t in table]
        n = len(table)
        self._member = [c == self.color for c in self._colors]
        # the rank of parent-rank r within ITS clique
        self._subrank_of = [
            sum(1 for q in range(n) if self._colors[q] == self._colors[r]
                and (self._keys[q], q) < (self._keys[r], r))
            for r in range(n)]
        self._rank = self._subrank_of[parent.get_rank()]
        self._size = sum(self._member)
        # clique members in clique-rank order
        self._order = sorted((r for r in range(n) if self._member[r]),
                             key=lambda r: self._subrank_of[r])

    def get_size(self) -> int:
        return self._size

    def get_rank(self) -> int:
        return self._rank

    def _members(self, x):
        parts = self.parent.exchange(torch.as_tensor(x))
        return [parts[r] for r in self._order], parts

    def allreduce(self, x, op: Op = Op.SUM):
        return _fold(self._members(x)[0], op)

    def bcast(self, x, root: int = 0):
        return self._members(x)[0][root].clone()

    def reduce(self, x, root: int = 0, op: Op = Op.SUM):
        full = self.allreduce(x, op)
        return full if self._rank == root else torch.as_tensor(x)

    def allgather(self, x):
        mem, parts = self._members(x)
        out = torch.zeros((len(parts),) + tuple(parts[0].shape),
                          dtype=parts[0].dtype, device=parts[0].device)
        if mem:
            out[:len(mem)] = torch.stack(mem)
        return out

    def allgatherv(self, x, counts: Sequence[int]):
        out = self.allgather(x)
        return torch.cat([out[i, :counts[i]] for i in range(len(counts))])

    def gather(self, x, root: int = 0):
        out = self.allgather(x)
        return out if self._rank == root else torch.zeros_like(out)

    def gatherv(self, x, counts: Sequence[int], root: int = 0):
        out = self.allgatherv(x, counts)
        return out if self._rank == root else torch.zeros_like(out)

    def reducescatter(self, x, op: Op = Op.SUM,
                      clique_size: Optional[int] = None):
        """Each member's block of the clique's reduction (``clique_size``
        kept for the reference's signature; the size is known here)."""
        full = self.allreduce(x, op)
        c = full.shape[0] // self._size
        return full[self._rank * c:(self._rank + 1) * c].clone()

    def barrier(self, token=None):
        return self.parent.barrier(token)

    def sync_stream(self, *arrays) -> Status:
        return self.parent.sync_stream(*arrays)

    def comm_split_color(self, color: int, key: Optional[int] = None
                         ) -> "ColorComms":
        """Split the clique again; combined colors keep cliques disjoint
        across parents (colors fit 15 bits, as the reference documents)."""
        return ColorComms(self.parent, self.color * 32768 + (color & 32767),
                          key)

    def device_send(self, x, dst):
        return self.device_sendrecv(x, dst)

    def device_recv(self, x_from_permute):
        return x_from_permute

    def device_sendrecv(self, x, dst, src=None):
        """:meth:`MeshComms.device_sendrecv` in clique ranks; a member no
        pair targets receives zeros."""
        mem, parts = self._members(x)
        if isinstance(dst, int):
            return mem[(self._rank - dst) % max(self._size, 1)].clone()
        want = None
        for s, d in dst:
            if d == self._rank:
                want = s
        if want is None or want >= len(mem):
            return torch.zeros_like(parts[0])
        return mem[want].clone()

    def device_multicast_sendrecv(self, x, dsts=None):
        return self.allgather(x)

    def group_start(self):
        """(ref: comms_iface::group_start)"""

    def group_end(self):
        """(ref: comms_iface::group_end)"""
