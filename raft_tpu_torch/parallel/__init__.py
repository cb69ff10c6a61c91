"""raft_tpu_torch.parallel — the mesh, its helpers, the rank runners and
the SNMG handle (counterpart of ``raft_tpu/parallel``)."""

from raft_tpu_torch.parallel.mesh import (
    Mesh,
    Replicated,
    RowSharding,
    ShardedArray,
    axis_devices,
    for_each_rank,
    line_mesh,
    make_mesh,
    rank_coords,
    replicated,
    shard_array,
    shard_rows,
    spmd,
    submesh,
)
from raft_tpu_torch.parallel.snmg import DeviceResourcesSNMG

__all__ = [
    "Mesh", "Replicated", "RowSharding", "ShardedArray", "axis_devices",
    "for_each_rank", "line_mesh", "make_mesh",
    "rank_coords", "replicated", "shard_array", "shard_rows", "spmd",
    "submesh", "DeviceResourcesSNMG",
]
