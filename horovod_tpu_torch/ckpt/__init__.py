"""Sharded checkpoints + peer-replica recovery (the port of
``horovod_tpu/ckpt``).

Two coupled tiers above the rank-0 path in ``checkpoint.py``:

* :mod:`~horovod_tpu_torch.ckpt.sharded` — every rank writes only its own
  shard (atomic, checksummed), rank 0 commits a manifest LAST, restore
  reassembles and reshards across world-size changes (N -> M).
* :mod:`~horovod_tpu_torch.ckpt.replica` — each rank mirrors its
  committed snapshot to its replica key over the HMAC-signed KV path, so
  a respawned rank restores from a live copy in seconds and touches disk
  only when no peer holds a valid one.

``elastic.State`` routes commit/restore/sync through both tiers; the
restore *provenance* (``peer`` / ``disk`` / ``none``) is recorded in the
metrics registry and ``State.last_restore``.  The trees the tiers carry
are ``ckpt/tree.py``'s.
"""

from .replica import ReplicaTier, tier_from_env  # noqa: F401
from .sharded import (  # noqa: F401
    MANIFEST,
    SCHEMA,
    ShardCorruptError,
    ShardedSave,
    latest_step,
    list_steps,
    load_manifest,
    restore_sharded,
    save_sharded,
    save_sharded_async,
    shard_assignment,
)

__all__ = [
    "MANIFEST",
    "SCHEMA",
    "ShardCorruptError",
    "ShardedSave",
    "ReplicaTier",
    "tier_from_env",
    "latest_step",
    "list_steps",
    "load_manifest",
    "restore_sharded",
    "save_sharded",
    "save_sharded_async",
    "shard_assignment",
]
