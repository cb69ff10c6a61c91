"""Lanczos solver configuration of the port (counterpart of
``raft_tpu/sparse/solver/lanczos_types.py``; ref: cpp/include/raft/sparse/
solver/lanczos_types.hpp:20 ``LANCZOS_WHICH`` and :40
``lanczos_solver_config``)."""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class LANCZOS_WHICH(enum.Enum):
    """(ref: lanczos_types.hpp:20) SM selects the smallest-magnitude Ritz
    values of the same Krylov process, without shift-invert, as the
    reference does: interior eigenvalues converge slowly."""

    LA = "LA"  # largest algebraic
    LM = "LM"  # largest magnitude
    SA = "SA"  # smallest algebraic
    SM = "SM"  # smallest magnitude


@dataclasses.dataclass
class LanczosSolverConfig:
    """(ref: lanczos_types.hpp:40 ``lanczos_solver_config``)

    ``jit_loop``: the reference's name for its two control flows, kept.
    The port runs one loop of restart cycles until the residuals meet the
    tolerance or ``max_iterations`` steps were taken; False also stops it
    when the residual stagnates (the reference's host loop), True does not
    (its compiled loop). None (default) is True on ``cuda`` and False on
    the CPU."""

    n_components: int
    max_iterations: int = 1000
    ncv: Optional[int] = None
    tolerance: float = 1e-6
    which: LANCZOS_WHICH = LANCZOS_WHICH.SA
    seed: int = 42
    jit_loop: Optional[bool] = None
