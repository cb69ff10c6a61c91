"""MPI-launched bootstrap.

Counterpart of ``raft_tpu/comms/mpi.py`` (ref: comms/mpi_comms.hpp
``initialize_mpi_comms``): under mpirun/srun, read the launcher's
environment for (rank, size) and join the process group at the
coordinator ``RAFT_TPU_COORDINATOR`` names (rank 0's host).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from raft_tpu_torch.core.error import expects


def detect_mpi_environment() -> Optional[Tuple[int, int]]:
    """(rank, size) from OpenMPI/MPICH/SLURM launcher env, or None."""
    for rank_var, size_var in (
        ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"),
        ("PMI_RANK", "PMI_SIZE"),
        ("SLURM_PROCID", "SLURM_NTASKS"),
    ):
        if rank_var in os.environ and size_var in os.environ:
            return int(os.environ[rank_var]), int(os.environ[size_var])
    return None


def initialize_mpi_comms(coordinator_address: Optional[str] = None,
                         coordinator_port: int = 8476,
                         backend: Optional[str] = None):
    """Join the process group from an MPI-style launch; returns (rank,
    size)."""
    from raft_tpu_torch.comms.session import initialize_distributed

    env = detect_mpi_environment()
    expects(env is not None,
            "initialize_mpi_comms: no MPI launcher environment detected")
    rank, size = env
    if coordinator_address is None:
        host = os.environ.get("RAFT_TPU_COORDINATOR")
        expects(host is not None or size == 1,
                "initialize_mpi_comms: set RAFT_TPU_COORDINATOR to rank 0's "
                "host (or pass coordinator_address) for multi-host launches")
        coordinator_address = f"{host or '127.0.0.1'}:{coordinator_port}"
    initialize_distributed(coordinator_address, size, rank, backend=backend)
    return rank, size
