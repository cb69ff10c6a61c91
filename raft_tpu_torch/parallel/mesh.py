"""The mesh, its helpers, and the rank runners.

Counterpart of ``raft_tpu/parallel/mesh.py`` (``make_mesh``, ``submesh``,
``shard_rows``, ``replicated``, ``shard_array``). A :class:`Mesh` holds
named axes over an array of ``torch.device``; one device may repeat, so
p shards can share one card, as the reference's virtual CPU devices share
one CPU.

:func:`for_each_rank` is the single controller that the sharded
functions use: it runs a rank function for each device of a mesh line,
in rank order on the calling thread, and the caller combines the
results (the reference's ``shard_map`` programs meet their peers only in
their final merge or reduction, which the controller does itself).
:func:`spmd` runs rank-local code that meets its peers mid-call (the
comms battery, :class:`~raft_tpu_torch.comms.HostComms`): a thread a
rank, each handed a rank-local
:class:`~raft_tpu_torch.comms.comms.MeshComms` whose collectives meet at
an in-process rendezvous. A rank that raises fails the others'
collectives (they raise :class:`~raft_tpu_torch.comms.comms.
CollectiveError` instead of hanging); :func:`spmd` then raises the first
rank's own error.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from raft_tpu_torch.core.error import DeviceError, expects


def _device_array(devs, shape) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        arr[i] = torch.device(d)
    return arr.reshape(shape)


class Mesh:
    """Named axes over an array of devices (``devices`` [*sizes] of
    ``torch.device``, C order). Two meshes are equal when their axis
    names and devices are."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        expects(devices.ndim == len(axis_names),
                "Mesh: %d axis names for a %d-d device array",
                len(axis_names), devices.ndim)
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_list(self) -> List[torch.device]:
        """The devices in rank order (C order over the axes)."""
        return list(self.devices.flat)

    def __eq__(self, other):
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and self.device_list() == other.device_list())

    def __hash__(self):
        return hash((self.axis_names, self.devices.shape,
                     tuple(str(d) for d in self.device_list())))

    def __repr__(self):
        devs = sorted({str(d) for d in self.device_list()})
        return f"Mesh({self.shape}, devices={devs})"


def _visible_cuda_devices() -> List[torch.device]:
    if not torch.cuda.is_available():
        raise DeviceError(
            "make_mesh: no CUDA device is visible; pass devices= (e.g. "
            "[torch.device('cpu')] * p) to build a mesh on the CPU")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(shape: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A named mesh. ``shape`` maps axis name → size (one ``-1`` takes the
    rest of the devices); default a 1-d ``"x"`` mesh over every device.
    ``devices`` defaults to the visible CUDA devices and never falls back
    to the CPU: without a card it raises :class:`DeviceError`. A mesh
    larger than its device list repeats the devices cyclically when its
    size is a multiple of theirs, so ``make_mesh({"x": 4})`` on one card
    places four ranks on it."""
    devs = ([torch.device(d) for d in devices] if devices is not None
            else _visible_cuda_devices())
    expects(len(devs) >= 1, "make_mesh: no devices")
    if not shape:
        return Mesh(_device_array(devs, (len(devs),)), ("x",))
    names = tuple(shape.keys())
    sizes = [int(s) for s in shape.values()]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = max(1, len(devs) // known)
    total = int(np.prod(sizes))
    expects(total >= 1 and total % len(devs) == 0,
            "make_mesh: shape %s does not fill %d devices",
            dict(zip(names, sizes)), len(devs))
    devs = devs * (total // len(devs))
    return Mesh(_device_array(devs, sizes), names)


def submesh(mesh: Mesh, axis: str, index: int) -> Mesh:
    """The sub-mesh at a fixed coordinate of ``axis`` (comm_split with a
    static color)."""
    expects(axis in mesh.axis_names, "submesh: unknown axis %r", axis)
    ax = mesh.axis_names.index(axis)
    devs = np.take(mesh.devices, index, axis=ax)
    return Mesh(devs, tuple(n for n in mesh.axis_names if n != axis))


class RowSharding(NamedTuple):
    """Axis 0 split over ``mesh[axis]`` (one block of rows a rank)."""

    mesh: Mesh
    axis: str


class Replicated(NamedTuple):
    """The whole array on every rank."""

    mesh: Mesh


def shard_rows(mesh: Mesh, axis: str = "x") -> RowSharding:
    return RowSharding(mesh, axis)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


class ShardedArray:
    """A host array placed over a mesh: ``shards[r]`` is rank r's block
    (by its coordinate on ``axis``) on rank r's device."""

    def __init__(self, shards: List[torch.Tensor], mesh: Mesh, axis: str):
        self.shards, self.mesh, self.axis = shards, mesh, axis

    @property
    def shape(self):
        p = self.mesh.shape[self.axis]
        return (p * self.shards[0].shape[0],) + tuple(
            self.shards[0].shape[1:])

    def gather(self) -> torch.Tensor:
        """The whole array on the first rank's device."""
        coords = rank_coords(self.mesh)
        ax = self.mesh.axis_names.index(self.axis)
        first = {}
        for r, c in enumerate(coords):
            first.setdefault(c[ax], r)
        dev = self.shards[0].device
        return torch.cat([self.shards[first[i]].to(dev)
                          for i in sorted(first)])

    def __array__(self, dtype=None, copy=None):
        a = self.gather().cpu().numpy()
        return a if dtype is None else a.astype(dtype)


def shard_array(x, mesh: Mesh, axis: str = "x") -> ShardedArray:
    """Place ``x`` (numpy or tensor) row-sharded over ``mesh[axis]``: the
    rows split into equal blocks, rank r holding its block on its device
    (replicated along the other axes)."""
    x = torch.as_tensor(np.asarray(x)) if not isinstance(
        x, torch.Tensor) else x
    p = mesh.shape[axis]
    expects(x.shape[0] % p == 0, "shard_array: %d rows do not split over "
            "%d ranks", x.shape[0], p)
    c = x.shape[0] // p
    ax = mesh.axis_names.index(axis)
    shards = [x[cd[ax] * c:(cd[ax] + 1) * c].to(dev)
              for cd, dev in zip(rank_coords(mesh), mesh.device_list())]
    return ShardedArray(shards, mesh, axis)


def rank_coords(mesh: Mesh) -> List[tuple]:
    """Each rank's coordinates on the mesh axes, in rank order."""
    return list(itertools.product(*(range(s) for s in mesh.devices.shape)))


def axis_devices(mesh: Mesh, axis: str) -> List[torch.device]:
    """The devices along ``axis``, the other axes at coordinate 0."""
    ax = mesh.axis_names.index(axis)
    sl = [0] * mesh.devices.ndim
    sl[ax] = slice(None)
    return list(mesh.devices[tuple(sl)].flat)


def line_mesh(mesh: Mesh, axis: str) -> Mesh:
    """The 1-d mesh of the ranks along ``axis`` (the sharded functions
    run over one line of a mesh)."""
    if mesh.axis_names == (axis,):
        return mesh
    return Mesh(_device_array(axis_devices(mesh, axis),
                              (mesh.shape[axis],)), (axis,))


# ----------------------------------------------------------- the runners
def for_each_rank(mesh: Mesh, fn: Callable,
                  rank_args: Sequence[tuple]) -> list:
    """The single-controller runner, for rank functions that meet no peer
    mid-call: ``fn(*rank_args[r])`` for each rank of the 1-d ``mesh``, in
    rank order on the calling thread, with rank r's device current (its
    work on that device's current stream). The caller combines the
    results (e.g. :func:`raft_tpu_torch.comms.comms.reduce_parts`, or a
    sharded merge)."""
    devs = mesh.device_list()
    expects(len(rank_args) == len(devs),
            "for_each_rank: %d argument tuples for %d ranks",
            len(rank_args), len(devs))
    out = []
    for dev, args in zip(devs, rank_args):
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                out.append(fn(*args))
        else:
            out.append(fn(*args))
    return out


def _build_comms(mesh: Mesh, axis: str, timeout_s: float):
    """Rank r's communicator along every axis: the ranks that share r's
    coordinates on the other axes form one :class:`LocalGroup`."""
    from raft_tpu_torch.comms.comms import LocalGroup, MeshComms

    coords = rank_coords(mesh)
    devs = mesh.device_list()
    groups = []
    per_rank: List[Dict[str, MeshComms]] = [dict() for _ in coords]
    for ai, name in enumerate(mesh.axis_names):
        lines: Dict[tuple, List[int]] = {}
        for r, c in enumerate(coords):
            lines.setdefault(c[:ai] + c[ai + 1:], []).append(r)
        for ranks in lines.values():
            g = LocalGroup([devs[r] for r in ranks], timeout_s)
            groups.append(g)
            for i, r in enumerate(ranks):
                per_rank[r][name] = MeshComms(g, i, name, per_rank[r])
    return [pr[axis] for pr in per_rank], groups


def spmd(mesh: Mesh, fn: Callable, rank_args: Optional[Sequence] = None,
         axis: Optional[str] = None,
         timeout_s: Optional[float] = None) -> list:
    """Run ``fn(comms, *rank_args[r])`` once for every rank of ``mesh``,
    each in a thread of its own, and return the results in rank order (C
    order over the axes): the runner for rank functions that meet their
    peers mid-call (the comms battery, :class:`~raft_tpu_torch.comms.
    HostComms`). ``comms`` is rank r's :class:`MeshComms` along ``axis``
    (default the first); ``comms.comm_split(other)`` gives the other
    axes. On a card, each rank runs on the caller's current stream of its
    device.

    A rank's collective waits at most ``timeout_s`` (default
    :data:`~raft_tpu_torch.comms.comms.DEFAULT_TIMEOUT_S`) for its peers,
    and once one rank has finished or failed the others have ``2 ·
    timeout_s + 1`` seconds to finish, so a rank stuck outside a
    collective fails the call with :class:`CollectiveError` instead of
    hanging it (its thread is left behind). If a rank raises, the others'
    collectives fail with :class:`CollectiveError` and :func:`spmd` raises
    the error of the lowest rank that failed first-hand (a rank's own
    error, not a peer's report of it)."""
    from raft_tpu_torch.comms.comms import DEFAULT_TIMEOUT_S, CollectiveError

    axis = mesh.axis_names[0] if axis is None else axis
    expects(axis in mesh.axis_names, "spmd: axis %r not in mesh axes %s",
            axis, mesh.axis_names)
    n = mesh.size
    rank_args = [()] * n if rank_args is None else list(rank_args)
    expects(len(rank_args) == n, "spmd: %d argument tuples for %d ranks",
            len(rank_args), n)
    timeout_s = DEFAULT_TIMEOUT_S if timeout_s is None else float(timeout_s)
    comms, groups = _build_comms(mesh, axis, timeout_s)
    devs = mesh.device_list()
    callers = {d: torch.cuda.current_stream(d) for d in set(devs)
               if d.type == "cuda"}
    results: list = [None] * n
    errors: List[Optional[BaseException]] = [None] * n
    finished: "queue.Queue[int]" = queue.Queue()

    def fail(r: int, e: BaseException) -> None:
        errors[r] = e
        for g in groups:
            g.abort(r, e)

    def body(r: int) -> None:
        dev = devs[r]
        try:
            if dev.type == "cuda":
                with torch.cuda.device(dev), torch.cuda.stream(callers[dev]):
                    results[r] = fn(comms[r], *rank_args[r])
            else:
                results[r] = fn(comms[r], *rank_args[r])
        except BaseException as e:  # every rank's failure is reported
            fail(r, e)
        finally:
            finished.put(r)

    for r in range(n):
        threading.Thread(target=body, args=(r,), name=f"spmd-rank-{r}",
                         daemon=True).start()
    done = {finished.get()}
    t_end = time.monotonic() + 2 * timeout_s + 1.0
    while len(done) < n:
        try:
            done.add(finished.get(timeout=max(0.0,
                                              t_end - time.monotonic())))
        except queue.Empty:
            stuck = sorted(set(range(n)) - done)
            err = CollectiveError(
                f"spmd: rank(s) {stuck} of {n} did not finish within "
                f"{2 * timeout_s + 1.0} s of the first")
            for g in groups:
                g.abort(stuck[0], err)
            raise err from None
    failed = [e for e in errors if e is not None]
    if failed:
        own = [e for e in failed if not isinstance(e, CollectiveError)]
        raise (own or failed)[0]
    return results
