"""raft_tpu_torch.serving — the micro-batching query engine of the port.

- :class:`~raft_tpu_torch.serving.engine.ServingEngine` — the engine.
- :mod:`~raft_tpu_torch.serving.buckets` — the bucket ladder
  (``RAFT_TPU_SERVING_BUCKETS``).
- :mod:`~raft_tpu_torch.serving.snapshot` — immutable snapshots and the
  :class:`~raft_tpu_torch.serving.snapshot.SnapshotStore`.
"""

from raft_tpu_torch.serving.buckets import (MAX_BUCKETS, ROW_QUANTUM,
                                            bucket_for, bucket_ladder,
                                            default_bucket_ladder)
from raft_tpu_torch.serving.engine import (OverloadShedError,
                                           RequestTooLargeError,
                                           ServingEngine, ServingFuture,
                                           execute_batch)
from raft_tpu_torch.serving.snapshot import (IndexSnapshot, SnapshotStore,
                                             build_snapshot)

__all__ = ["MAX_BUCKETS", "ROW_QUANTUM", "IndexSnapshot",
           "OverloadShedError", "RequestTooLargeError", "ServingEngine",
           "ServingFuture", "SnapshotStore", "bucket_for", "bucket_ladder",
           "build_snapshot", "default_bucket_ladder", "execute_batch"]
