"""Exact Jonker–Volgenant tail of the LAP solver: wrapper, plain twin and
launch count.

The reference's tail (``raft_tpu/solver/linear_assignment.py:_jv_solve``)
is a jitted ``while_loop``, not a Pallas kernel: n augmentations whose
every step decides the next. Its port is the hand-written kernel in
``csrc/lap_jv.cu`` (one block an instance, the loop on the card); see that
file for the design. The twin is the same loop in PyTorch, one host read a
step, used on the CPU and as the kernel's oracle on the card.

The contract: cost [batch, n, n] f32 → (assign [batch, n] int32 row →
column, u [batch, n] f32 row duals), bit for bit the reference's.

The wrapper dispatches on the tensors' device: CPU tensors take the twin,
CUDA tensors launch the kernel or raise. There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from raft_tpu_torch.core.error import DeviceError
from raft_tpu_torch.ops import _build

#: the most columns the kernel takes (its shared-memory envelope)
MAX_N = 8192
#: the reference's infinity (``jnp.float32(3e38)``)
INF = 3e38

# kernel launches since import (or since a caller reset them)
LAUNCHES = 0

_FN = None


def _operand(cost) -> torch.Tensor:
    cost = torch.as_tensor(cost)
    if cost.ndim != 3 or cost.shape[1] != cost.shape[2] or cost.shape[1] < 1:
        raise ValueError(f"lap_jv_solve: need cost [batch, n, n], got "
                         f"{tuple(cost.shape)}")
    return cost.to(torch.float32).contiguous()


def lap_jv_solve(cost, with_steps: bool = False):
    """(assign [batch, n] int32, u [batch, n] f32) of cost [batch, n, n],
    and each instance's Dijkstra steps [batch] int64 with ``with_steps``
    (the work the run's data needed). On CUDA tensors the kernel runs; on
    CPU tensors the twin."""
    global LAUNCHES
    cost = _operand(cost)
    if cost.device.type == "cpu":
        return lap_jv_solve_ref(cost, with_steps)
    if cost.device.type != "cuda":
        raise DeviceError(f"lap_jv_solve: no kernel for device {cost.device}")
    batch, n, _ = cost.shape
    if n > MAX_N:
        raise NotImplementedError(f"lap_jv_solve takes n ≤ {MAX_N}, got {n}")
    assign = torch.empty((batch, n), dtype=torch.int32, device=cost.device)
    u = torch.empty((batch, n), dtype=torch.float32, device=cost.device)
    steps = torch.empty(batch, dtype=torch.int64, device=cost.device)
    with torch.cuda.device(cost.device):
        rc = _launcher()(cost.data_ptr(), batch, n, assign.data_ptr(),
                         u.data_ptr(), steps.data_ptr() if with_steps
                         else None, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise DeviceError(f"lap_jv_solve: launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return (assign, u, steps) if with_steps else (assign, u)


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.load("lap_jv").lap_jv_launch
        vp = ctypes.c_void_p
        fn.argtypes = [vp, ctypes.c_int, ctypes.c_int, vp, vp, vp, vp]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _jv_one(cost: torch.Tensor):
    """One instance, the reference's ``_jv_solve`` step for step."""
    n = cost.shape[0]
    dev = cost.device
    inf = torch.tensor(INF, dtype=torch.float32, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    p = torch.full((n + 1,), -1, dtype=torch.long, device=dev)
    steps = 0
    for i0 in range(n):
        p[n] = i0
        minv = torch.full((n,), INF, dtype=torch.float32, device=dev)
        way = torch.full((n,), n, dtype=torch.long, device=dev)
        used = torch.zeros(n, dtype=torch.bool, device=dev)
        j0 = n
        while True:
            i_row = int(p[j0])
            if i_row < 0:
                break
            steps += 1
            if j0 < n:
                used[j0] = True
            cur = cost[i_row] - u[i_row] - v
            better = (cur < minv) & ~used
            minv = torch.where(better, cur, minv)
            way = torch.where(better, j0, way)
            masked = torch.where(used, inf, minv)
            j1 = int(torch.argmin(masked))
            delta = masked[j1]
            u[p[:n][used]] += delta
            u[i0] += delta
            v = torch.where(used, v - delta, v)
            minv = torch.where(used, minv, minv - delta)
            j0 = j1
        while j0 != n:                 # backtrack the augmenting path
            j1 = int(way[j0])
            p[j0] = p[j1]
            j0 = j1
    assign = torch.empty(n, dtype=torch.int32, device=dev)
    assign[p[:n]] = torch.arange(n, dtype=torch.int32, device=dev)
    return assign, u, steps


def lap_jv_solve_ref(cost, with_steps: bool = False):
    """Plain PyTorch twin of :func:`lap_jv_solve`: the reference's arithmetic in
    a host loop over each instance's augmentations and steps."""
    cost = _operand(cost)
    out = [_jv_one(c) for c in cost]
    assign = torch.stack([o[0] for o in out])
    u = torch.stack([o[1] for o in out])
    if not with_steps:
        return assign, u
    return assign, u, torch.tensor([o[2] for o in out], dtype=torch.int64,
                                   device=cost.device)
