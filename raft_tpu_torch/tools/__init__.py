"""raft_tpu_torch.tools — the operator surfaces of the serving engine:
:func:`~raft_tpu_torch.tools.statusz.render_statusz` and the debugz HTTP
server (:class:`~raft_tpu_torch.tools.debugz.DebugzServer`)."""

from raft_tpu_torch.tools.debugz import DebugzServer
from raft_tpu_torch.tools.statusz import render_statusz

__all__ = ["DebugzServer", "render_statusz"]
