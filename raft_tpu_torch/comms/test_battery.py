"""The communicator self-tests, run rank by rank.

Counterpart of ``raft_tpu/comms/test_battery.py`` (ref: cpp/include/raft/
comms/detail/test.hpp: test_collective_allreduce:31, …broadcast:62,
…reduce:97, …allgather:133, …gather:170, …gatherv:207,
…reducescatter:266, test_pointToPoint_simple_send_recv:301,
…device_send_or_recv:366, …device_sendrecv:408,
…device_multicast_sendrecv:454, test_commsplit:513). As in the C++
battery, every rank runs each test with its own
:class:`~raft_tpu_torch.comms.comms.MeshComms` and checks its own
result, so the same functions run over both transports: in-process ranks
(:func:`run_battery` over a mesh) and a process group (each process
calls them with :func:`~raft_tpu_torch.comms.session.process_comms`).
The reference's host point-to-point tests ride its TCP ``p2p`` module,
which is not ported; here they run the same patterns over the device
send/recv.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.comms.comms import MeshComms, Op


def _val(comms: MeshComms, v, dtype=torch.float32):
    return torch.as_tensor(v, dtype=dtype, device=comms.device)


def perform_test_comm_allreduce(comms: MeshComms) -> bool:
    """(ref: test.hpp:31 — each rank gives 1; expect size.)"""
    out = comms.allreduce(_val(comms, [1.0]), Op.SUM)
    return bool((out == comms.get_size()).all())


def perform_test_comm_bcast(comms: MeshComms, root: int = 0) -> bool:
    """(ref: test.hpp:62 — root's value lands everywhere.)"""
    out = comms.bcast(_val(comms, [100.0 + comms.get_rank()]), root=root)
    return bool((out == 100.0 + root).all())


def perform_test_comm_reduce(comms: MeshComms, root: int = 0) -> bool:
    """(ref: test.hpp:97 — root holds the sum; the others keep their
    input.)"""
    r, n = comms.get_rank(), comms.get_size()
    out = comms.reduce(_val(comms, [float(r)]), root=root, op=Op.SUM)
    want = float(sum(range(n))) if r == root else float(r)
    return bool(out[0] == want)


def perform_test_comm_allgather(comms: MeshComms) -> bool:
    """(ref: test.hpp:133 — every rank sees every rank's value.)"""
    out = comms.allgather(_val(comms, [float(comms.get_rank())]))
    return out[:, 0].cpu().tolist() == [float(i)
                                        for i in range(comms.get_size())]


def perform_test_comm_gather(comms: MeshComms, root: int = 0) -> bool:
    """(ref: test.hpp:170)"""
    out = comms.gather(_val(comms, [float(comms.get_rank())]), root=root)
    if comms.get_rank() != root:
        return bool((out == 0).all())
    return out[:, 0].cpu().tolist() == [float(i)
                                        for i in range(comms.get_size())]


def perform_test_comm_gatherv(comms: MeshComms, root: int = 0) -> bool:
    """(ref: test.hpp:207 — rank r gives r+1 copies of r.)"""
    n, r = comms.get_size(), comms.get_rank()
    counts = tuple(i + 1 for i in range(n))
    x = torch.zeros(max(counts), device=comms.device)
    x[:counts[r]] = r
    out = comms.gatherv(x, counts, root=root)
    want = [float(i) for i, c in enumerate(counts) for _ in range(c)]
    if r != root:
        return bool((out == 0).all())
    return out.cpu().tolist() == want


def perform_test_comm_reducescatter(comms: MeshComms) -> bool:
    """(ref: test.hpp:266 — each rank gets its slice of the sum.)"""
    n = comms.get_size()
    out = comms.reducescatter(torch.ones(n, device=comms.device), Op.SUM)
    return out.shape == (1,) and bool((out == n).all())


def perform_test_comm_device_sendrecv(comms: MeshComms) -> bool:
    """Ring shift by one: rank r receives r−1. (ref: test.hpp:408)"""
    n, r = comms.get_size(), comms.get_rank()
    out = comms.device_sendrecv(_val(comms, [float(r)]), 1)
    return bool(out[0] == float((r - 1) % n))


def perform_test_comm_device_multicast_sendrecv(comms: MeshComms) -> bool:
    """(ref: test.hpp:454)"""
    out = comms.device_multicast_sendrecv(
        _val(comms, [float(comms.get_rank())]))
    return out[:, 0].cpu().tolist() == [float(i)
                                        for i in range(comms.get_size())]


def perform_test_comm_send_recv(comms: MeshComms,
                                num_trials: int = 2) -> bool:
    """All to all: every rank sends its id to every other rank and checks
    what it received, one ring shift at a time (ref: test.hpp:301
    test_pointToPoint_simple_send_recv's pattern)."""
    n, r = comms.get_size(), comms.get_rank()
    for _ in range(num_trials):
        for s in range(1, n):
            got = comms.device_sendrecv(_val(comms, [r], torch.int32), s)
            if int(got[0]) != (r - s) % n:
                return False
        comms.barrier()
    return True


def perform_test_comm_device_send_or_recv(comms: MeshComms,
                                          num_trials: int = 2) -> bool:
    """Disjoint send-or-receive pairs: even rank r sends its id to r+1;
    odd ranks check r−1 arrived, even ranks that no pair targets get
    zeros. (ref: test.hpp:366)"""
    n, r = comms.get_size(), comms.get_rank()
    pairs = [(s, s + 1) for s in range(0, n - 1, 2)]
    for _ in range(num_trials):
        got = int(comms.collective_permute(_val(comms, [r], torch.int32),
                                           pairs)[0])
        if got != (r - 1 if r % 2 else 0):
            return False
    return True


def perform_test_comm_split(comms: MeshComms, other_axis: str) -> bool:
    """2-D grid: allreduce along this axis and along ``other_axis``
    (ref: test.hpp:513 test_commsplit)."""
    col = comms.comm_split(other_axis)
    a = comms.allreduce(_val(comms, [1.0]))
    b = col.allreduce(_val(col, [1.0]))
    return bool(a[0] == comms.get_size() and b[0] == col.get_size())


ALL_TESTS = [
    perform_test_comm_allreduce,
    perform_test_comm_bcast,
    perform_test_comm_reduce,
    perform_test_comm_allgather,
    perform_test_comm_gather,
    perform_test_comm_gatherv,
    perform_test_comm_reducescatter,
    perform_test_comm_device_sendrecv,
    perform_test_comm_device_multicast_sendrecv,
    perform_test_comm_send_recv,
    perform_test_comm_device_send_or_recv,
]


def run_battery(comms_or_mesh, tests=None) -> dict:
    """Every test of ``tests`` (default :data:`ALL_TESTS`) → whether it
    passed on every rank. ``comms_or_mesh`` is a mesh (the tests run over
    its in-process ranks) or this process's communicator (each process of
    the group calls this)."""
    tests = ALL_TESTS if tests is None else tests
    if isinstance(comms_or_mesh, MeshComms):
        return {t.__name__: bool(t(comms_or_mesh)) for t in tests}
    from raft_tpu_torch.parallel.mesh import spmd

    outs = spmd(comms_or_mesh,
                lambda c: [bool(t(c)) for t in tests])
    return {t.__name__: all(o[i] for o in outs)
            for i, t in enumerate(tests)}
