"""Ops of horovod_tpu_torch: collectives, compression and flash attention
(``ops.flash_attention``; not re-exported here, so the name stays the
module's)."""

from .collectives import (
    Adasum,
    Average,
    Max,
    Min,
    ReduceOp,
    Sum,
    allreduce,
    broadcast,
    grouped_allreduce,
)
from .compression import Compression

__all__ = [
    "ReduceOp", "Average", "Sum", "Adasum", "Min", "Max",
    "allreduce", "grouped_allreduce", "broadcast",
    "Compression",
]
