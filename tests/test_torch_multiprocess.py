"""The port's process-group transport across real processes: two OS
processes (tests/_torch_mp_worker.py, torch only) join a gloo group
through the launcher environment (``OMPI_COMM_WORLD_*`` read by
``comms.initialize_mpi_comms``, rendezvous at a TCPStore on 127.0.0.1),
run the comms battery over it, and each runs its part of the
database-sharded KNN (``distance.knn_fused_shard`` with the allgather and
the tournament merge), whose merged answer must equal the single-device
``knn_fused`` bit for bit on every rank. Every wait has a timeout: the
group's own (30 s, set in the worker) and the test's (120 s a process).
"""

import os
import socket
import subprocess
import sys


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_battery_and_sharded_knn():
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "_torch_mp_worker.py")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.update({
            "PYTHONPATH": repo_root + os.pathsep + env.get("PYTHONPATH", ""),
            "OMPI_COMM_WORLD_RANK": str(rank),
            "OMPI_COMM_WORLD_SIZE": "2",
            "RAFT_TPU_COORDINATOR": "127.0.0.1",
            "RAFT_TPU_TEST_PORT": str(port),
            "CUDA_VISIBLE_DEVICES": "",
        })
        procs.append(subprocess.Popen(
            [sys.executable, worker], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert "battery complete" in out
        assert f"rank {rank} sharded knn allgather ok" in out
        assert f"rank {rank} sharded knn tournament ok" in out
        assert "FAIL" not in out
