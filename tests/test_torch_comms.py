"""The port's mesh and comms layer (raft_tpu_torch.parallel,
raft_tpu_torch.comms) on the CPU, held to the reference's (raft_tpu.comms
over ``jax.devices()[:p]`` of the 8 virtual CPU devices).

The battery runs rank by rank over p in-process ranks (the port's
``spmd``) and, for the host-side view, through ``HostComms`` against the
reference's ``HostComms`` on the same inputs: integer-valued data, so the
reductions are exact whatever the summation order and the results must be
equal. ``ColorComms`` is held to the reference's inside ``shard_map``.
The merge cost model is compared on equal ``ChipSpec`` figures: equal
numbers (float arithmetic in the same order) and the same choices.
"""

import time

import jax
import numpy as np
import pytest
import torch

from raft_tpu import comms as jcomms
from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu_torch import comms, parallel
from raft_tpu_torch.comms import (CollectiveError, HostComms, MeshComms, Op,
                                  test_battery)
from raft_tpu_torch.core.error import DeviceError

CPU = torch.device("cpu")


def _mesh(p):
    return parallel.make_mesh({"x": p}, devices=[CPU] * p)


def _jmesh(p):
    return jmake_mesh({"x": p}, devices=jax.devices()[:p])


@pytest.mark.parametrize("p", [2, 4, 8])
def test_battery_over_in_process_ranks(p):
    got = test_battery.run_battery(_mesh(p))
    assert set(got) == {t.__name__ for t in test_battery.ALL_TESTS}
    assert all(got.values()), got


@pytest.mark.parametrize("root", [0, 3])
def test_battery_roots(root):
    fns = [lambda c: test_battery.perform_test_comm_bcast(c, root),
           lambda c: test_battery.perform_test_comm_reduce(c, root),
           lambda c: test_battery.perform_test_comm_gather(c, root),
           lambda c: test_battery.perform_test_comm_gatherv(c, root)]
    for fn in fns:
        assert all(parallel.spmd(_mesh(4), fn))


def test_comm_split_on_a_2d_mesh():
    m = parallel.make_mesh({"row": 2, "col": 4}, devices=[CPU] * 8)
    assert m.shape == {"row": 2, "col": 4}
    assert all(parallel.spmd(
        m, lambda c: test_battery.perform_test_comm_split(c, "col"),
        axis="row"))
    sizes = parallel.spmd(m, lambda c: (c.get_size(),
                                        c.comm_split("row").get_size()),
                          axis="col")
    assert sizes == [(4, 2)] * 8
    assert parallel.submesh(m, "row", 0).shape == {"col": 4}
    assert parallel.make_mesh({"a": 2, "b": -1},
                              devices=[CPU] * 8).shape["b"] == 4


@pytest.mark.parametrize("p", [2, 8])
def test_host_comms_match_reference(p):
    """Every HostComms collective on the same rank-indexed integer data
    in both packages, results equal (axis 0 = rank)."""
    hc, jhc = HostComms(_mesh(p), "x"), jcomms.HostComms(_jmesh(p), "x")
    rank = np.arange(p, dtype=np.float32)[:, None] + 1.0
    tile = np.tile(np.arange(p, dtype=np.float32), (p, 1))
    counts = tuple(r + 1 for r in range(p))
    ragged = np.zeros((p, p), np.float32)
    for r in range(p):
        ragged[r, :counts[r]] = r
    cases = [
        ("allreduce", (rank, Op.SUM), (rank, jcomms.Op.SUM)),
        ("allreduce", (rank, Op.MAX), (rank, jcomms.Op.MAX)),
        ("allreduce", (rank, Op.MIN), (rank, jcomms.Op.MIN)),
        ("allreduce", (rank, Op.PROD), (rank, jcomms.Op.PROD)),
        ("bcast", (rank, 1), (rank, 1)),
        ("reduce", (rank, 1), (rank, 1)),
        ("allgather", (rank,), (rank,)),
        ("gather", (rank, 1), (rank, 1)),
        ("allgatherv", (ragged, counts), (ragged, counts)),
        ("gatherv", (ragged, counts, 1), (ragged, counts, 1)),
        ("reducescatter", (tile,), (tile,)),
        ("device_sendrecv", (rank, 1), (rank, 1)),
        ("device_sendrecv", (rank, -1), (rank, -1)),
        ("device_multicast_sendrecv", (rank,), (rank,)),
    ]
    for name, a, ja in cases:
        got = getattr(hc, name)(*a).numpy()
        want = np.asarray(getattr(jhc, name)(*ja))
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(hc.get_rank_array().numpy(),
                                  np.asarray(jhc.get_rank_array()))
    hc.barrier()
    assert hc.sync_stream() == comms.Status.SUCCESS


def test_color_comms_match_reference():
    """comm_split(color, key) on 8 ranks: color = rank % 3, key = −rank
    (reversed order inside each clique), each collective against the
    reference's ColorComms inside shard_map."""
    from jax.sharding import PartitionSpec as P

    p = 8
    jc = jcomms.MeshComms("x", size=p)

    def jfn(v):
        r = jax.lax.axis_index("x")
        cc = jc.comm_split_color(r % 3, -r)
        x = v[0]
        return (cc.allreduce(x)[None], cc.bcast(x, 1)[None],
                cc.allgather(x)[None], cc.gather(x, 0)[None],
                cc.device_sendrecv(x, 1)[None],
                cc.device_sendrecv(x, [(0, 1)])[None],
                jax.numpy.stack([cc.get_rank(), cc.get_size()])[None])

    x = np.arange(p, dtype=np.float32)[:, None] * 10 + 1
    want = jax.shard_map(jfn, mesh=_jmesh(p), in_specs=(P("x"),),
                         out_specs=(P("x"),) * 7, check_vma=False)(x)

    def fn(c, xr):
        cc = c.comm_split_color(c.get_rank() % 3, -c.get_rank())
        return (cc.allreduce(xr), cc.bcast(xr, 1), cc.allgather(xr),
                cc.gather(xr, 0), cc.device_sendrecv(xr, 1),
                cc.device_sendrecv(xr, [(0, 1)]),
                torch.tensor([cc.get_rank(), cc.get_size()]))

    outs = parallel.spmd(_mesh(p), fn,
                         [(torch.from_numpy(x[r]),) for r in range(p)])
    for j in range(7):
        got = np.stack([o[j].numpy() for o in outs])
        np.testing.assert_array_equal(got, np.asarray(want[j]).reshape(
            got.shape), err_msg=str(j))


def test_a_rank_that_raises_fails_every_rank_quickly():
    """Rank 2 raises before its allgather: the other ranks' allgather
    fails with CollectiveError at once (not at the timeout) and spmd
    raises rank 2's own error."""
    seen = []

    def fn(c):
        if c.get_rank() == 2:
            raise ValueError("rank 2 failed")
        try:
            return c.allgather(torch.ones(3))
        except CollectiveError as e:
            seen.append(str(e))
            raise

    t0 = time.monotonic()
    with pytest.raises(ValueError, match="rank 2 failed"):
        parallel.spmd(_mesh(4), fn, timeout_s=30)
    assert time.monotonic() - t0 < 5
    assert len(seen) == 3 and all("rank 2" in s for s in seen)


def test_many_ranks_under_a_short_switch_interval():
    """More ranks than cores, 200 rounds of allreduce and sendrecv with
    the interpreter switching threads every microsecond: a lost or
    crossed update in the rendezvous would break a round's sum or shift.
    Bounded by the collectives' own 60 s timeout."""
    import os
    import sys

    p = min(32, max(16, 2 * (os.cpu_count() or 1)))

    def fn(c):
        r = c.get_rank()
        for i in range(200):
            x = torch.tensor([float(r + i)])
            if c.allreduce(x).item() != p * i + p * (p - 1) / 2:
                return False
            if c.device_sendrecv(x, 1).item() != (r - 1) % p + i:
                return False
        return True

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.monotonic()
        assert all(parallel.spmd(_mesh(p), fn, timeout_s=60))
        assert time.monotonic() - t0 < 60
    finally:
        sys.setswitchinterval(prev)


def test_a_missing_rank_times_out_with_the_typed_error():
    """A rank that never joins the collective: the others fail with
    CollectiveError (a DeviceError) after the collective's timeout."""
    def fn(c):
        if c.get_rank() == 1:
            return None
        return c.allreduce(torch.ones(1))

    t0 = time.monotonic()
    with pytest.raises(CollectiveError, match="timed out"):
        parallel.spmd(_mesh(3), fn, timeout_s=0.5)
    assert 0.4 < time.monotonic() - t0 < 10
    assert issubclass(CollectiveError, DeviceError)


def test_a_rank_stuck_outside_a_collective_fails_the_call():
    """A rank that neither finishes nor reaches a collective: once its
    peers have finished, spmd waits 2 · timeout_s + 1 s for it and then
    raises CollectiveError naming it, instead of hanging."""
    def fn(c):
        if c.get_rank() == 1:
            time.sleep(6)
        return c.get_rank()

    t0 = time.monotonic()
    with pytest.raises(CollectiveError, match=r"rank\(s\) \[1\]"):
        parallel.spmd(_mesh(3), fn, timeout_s=0.5)
    assert 1.5 < time.monotonic() - t0 < 5


def test_point_to_point_collectives_move_only_their_blocks(monkeypatch):
    """collective_permute and reducescatter over in-process ranks: each
    rank takes only the block sent to it (a permute one block, a
    reducescatter one block from every rank), not every rank's whole
    tensor as the all-gather collectives do; the results are right."""
    taken = []
    real = comms.LocalGroup._take

    def take(self, rank, t, ev, copy):
        taken.append(t.numel())
        return real(self, rank, t, ev, copy)

    monkeypatch.setattr(comms.LocalGroup, "_take", take)
    p = 4

    def fn(c):
        r = c.get_rank()
        a = c.collective_permute(torch.full((3,), float(r)),
                                 [(s, s ^ 1) for s in range(p)])
        return a, c.reducescatter(torch.arange(8.0) + r)

    outs = parallel.spmd(_mesh(p), fn)
    assert [int(o[0][0]) for o in outs] == [1, 0, 3, 2]
    for r, (_, b) in enumerate(outs):
        assert b.tolist() == [float(sum(2 * r + j + s for s in range(p)))
                              for j in range(2)]
    assert sorted(taken) == [2] * (p * p) + [3] * p


def test_make_mesh_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError, match="no CUDA device"):
        parallel.make_mesh()
    with pytest.raises(DeviceError):
        parallel.make_mesh({"x": 4})
    with pytest.raises(DeviceError):
        parallel.DeviceResourcesSNMG()
    m = parallel.make_mesh({"x": 4}, devices=[CPU])     # repeated
    assert m.shape == {"x": 4} and m.device_list() == [CPU] * 4
    with pytest.raises(Exception):
        parallel.make_mesh({"x": 3}, devices=[CPU, CPU])


def test_shard_array_and_snmg_and_session():
    m = _mesh(8)
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    sa = parallel.shard_array(x, m)
    assert len(sa.shards) == 8 and sa.shape == (8, 2)
    np.testing.assert_array_equal(np.asarray(sa), x)
    snmg = parallel.DeviceResourcesSNMG([CPU] * 4, root_rank=1)
    assert snmg.device_count() == 4 and snmg.is_root_rank(1)
    assert snmg.device_resources(3).device == CPU
    assert test_battery.perform_test_comm_allreduce.__name__
    assert snmg.get_comms().allreduce(
        torch.ones(4, 1)).ravel().tolist() == [4.0] * 4
    session = comms.Comms(devices=[CPU] * 8, axis_names=("row", "col"),
                          mesh_shape=(2, 4))
    session.init()
    assert comms.local_handle(session.session_id) is session.handle
    row, col = session.comms, session.handle.get_subcomm("col")
    assert row.get_size() == 2 and col.get_size() == 4
    assert row.allreduce(torch.ones(2, 1)).ravel().tolist() == [2.0, 2.0]
    session.destroy()
    assert comms.local_handle(session.session_id) is None


def test_mpi_environment_detection(monkeypatch):
    for var in ("OMPI_COMM_WORLD_RANK", "PMI_RANK", "SLURM_PROCID"):
        monkeypatch.delenv(var, raising=False)
    assert comms.detect_mpi_environment() is None
    monkeypatch.setenv("PMI_RANK", "3")
    monkeypatch.setenv("PMI_SIZE", "4")
    assert comms.detect_mpi_environment() == \
        jcomms.detect_mpi_environment() == (3, 4)


def test_get_type_and_status():
    assert comms.get_type(torch.zeros(1)) == comms.DataType.FLOAT32
    assert comms.get_type(torch.zeros(1, dtype=torch.bfloat16)) == \
        comms.DataType.BFLOAT16
    from raft_tpu_torch.core.error import DeadlineExceededError

    assert comms.status_from_exception(DeadlineExceededError("x")) == \
        comms.Status.ABORT
    assert comms.status_from_exception(RuntimeError("x")) == \
        comms.Status.ERROR


# ------------------------------------------------------- the cost model
def _specs():
    from raft_tpu.utils.arch import ChipSpec as JSpec
    from raft_tpu_torch.utils.arch import ChipSpec

    figs = [("slow", 1e12, 1e12, 1e12, 1e9, 1e6, 0.0),
            ("fast", 1e12, 1e12, 1e12, 1e9, 1e15, 1.0),
            ("h100", 989e12, 67e12, 3.35e12, 80e9, 450e9, 5e-6)]
    return [(ChipSpec(*f[:5], ici_bw=f[5], ici_latency=f[6]),
             JSpec(*f[:5], ici_bw=f[5], ici_latency=f[6])) for f in figs]


@pytest.mark.parametrize("p", [2, 4, 6, 8, 16])
@pytest.mark.parametrize("nq,k", [(33, 7), (512, 64), (4096, 64)])
def test_cost_model_matches_reference(p, nq, k):
    from raft_tpu.observability import costmodel as jcm
    from raft_tpu_torch.observability import costmodel as tcm

    for s in ("allgather", "tournament"):
        if s == "tournament" and p & (p - 1):
            with pytest.raises(ValueError):
                tcm.ici_traffic_model(p, nq, k, s)
            continue
        assert tcm.ici_traffic_model(p, nq, k, s) == \
            jcm.ici_traffic_model(p, nq, k, s)
        for spec, jspec in _specs():
            assert tcm.ici_time_model(p, nq, k, s, spec) == \
                jcm.ici_time_model(p, nq, k, s, jspec)
    for spec, jspec in _specs():
        assert tcm.choose_merge_strategy(p, nq, k, spec) == \
            jcm.choose_merge_strategy(p, nq, k, jspec)
    # the CPU figures are the reference's: "auto" picks alike off a card
    from raft_tpu.utils.arch import CPU_SPEC as JCPU
    from raft_tpu_torch.utils.arch import CPU_SPEC

    assert tcm.choose_merge_strategy(p, nq, k, CPU_SPEC) == \
        jcm.choose_merge_strategy(p, nq, k, JCPU)


def test_h100_spec_sheet_figures():
    from raft_tpu_torch.utils.arch import H100_SPEC, chip_spec

    assert H100_SPEC.hbm_bw == 3.35e12 and H100_SPEC.ici_bw == 450e9
    assert chip_spec("cpu").name.startswith("cpu")
    assert chip_spec("cuda") is H100_SPEC


def test_process_group_transport_at_world_size_one(tmp_path):
    """The process-group transport in this process (gloo, world size 1,
    a TCPStore on 127.0.0.1): the battery passes, as NCCL's does on the
    card."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    comms.initialize_distributed(f"127.0.0.1:{port}", 1, 0,
                                 backend="gloo", timeout_s=30)
    try:
        c = comms.process_comms(device="cpu")
        assert isinstance(c, MeshComms) and c.get_size() == 1
        got = test_battery.run_battery(c)
        assert all(got.values()), got
        assert c.allgather(torch.tensor([True])).dtype == torch.bool
    finally:
        comms.shutdown_distributed()
    assert not dist.is_initialized()
