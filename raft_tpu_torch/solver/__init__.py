"""raft_tpu_torch.solver — the linear assignment solver of the port.
(ref: cpp/include/raft/solver.)"""

from raft_tpu_torch.solver.linear_assignment import (LinearAssignmentProblem,
                                                     solve_lap)

__all__ = ["LinearAssignmentProblem", "solve_lap"]
