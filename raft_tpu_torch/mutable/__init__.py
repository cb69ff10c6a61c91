"""raft_tpu_torch.mutable — streaming upserts and deletes over immutable
bases, and their durability.

- :class:`~raft_tpu_torch.mutable.index.MutableIndex`: the mutation plane
  (brute bf16 / int8, IVF-Flat and IVF-PQ bases), with ``apply_upsert``,
  ``apply_delete`` and ``search_view``.
- :mod:`~raft_tpu_torch.mutable.layout`: :class:`IndexLayout`, the slab
  struct the planes share, and the certified-fused operands over it.
- :mod:`~raft_tpu_torch.mutable.wal` (segmented write-ahead log) and
  :mod:`~raft_tpu_torch.mutable.checkpoint` (atomic checkpoints and
  :func:`recover`), byte-compatible with the reference's.
"""

from raft_tpu_torch.mutable.checkpoint import (CheckpointStore,
                                               DurabilityPlane,
                                               has_durable_state,
                                               last_recovery, recover)
from raft_tpu_torch.mutable.index import (COMPACT_THRESHOLD_ENV,
                                          DELTA_CAP_ENV, MutableIndex,
                                          MutableView, apply_delete,
                                          apply_upsert,
                                          compact_threshold_default,
                                          delta_cap_default, search_view)
from raft_tpu_torch.mutable.layout import (FusedOps, IndexLayout,
                                           dense_layout, fused_geometry,
                                           fused_ops_for_layout,
                                           quantize_layout,
                                           ragged_layout_from_lists,
                                           run_fused_ops)
from raft_tpu_torch.mutable.wal import (OP_CHECKPOINT, OP_DELETE, OP_UPSERT,
                                        WalRecord, WalWriter)
from raft_tpu_torch.mutable.wal import replay as wal_replay

__all__ = [
    "COMPACT_THRESHOLD_ENV", "CheckpointStore", "DELTA_CAP_ENV",
    "DurabilityPlane", "FusedOps", "IndexLayout", "MutableIndex",
    "MutableView", "OP_CHECKPOINT", "OP_DELETE", "OP_UPSERT", "WalRecord",
    "WalWriter", "apply_delete", "apply_upsert",
    "compact_threshold_default", "delta_cap_default", "dense_layout",
    "fused_geometry", "fused_ops_for_layout", "has_durable_state",
    "last_recovery", "quantize_layout", "ragged_layout_from_lists",
    "recover", "run_fused_ops", "search_view", "wal_replay",
]
