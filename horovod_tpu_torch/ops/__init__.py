"""Ops of horovod_tpu_torch: collectives, compression, RoPE
(``ops.rope``) and flash attention (``ops.flash_attention``; neither
re-exported here, so the names stay the modules')."""

from .collectives import (
    Adasum,
    Average,
    Max,
    Min,
    ReduceOp,
    Sum,
    all_gather_flat,
    allgather,
    allreduce,
    alltoall,
    broadcast,
    grouped_allreduce,
    reduce_scatter_flat,
    reducescatter,
)
from .compression import Compression, ErrorFeedbackCompressor

__all__ = [
    "ReduceOp", "Average", "Sum", "Adasum", "Min", "Max",
    "allreduce", "grouped_allreduce", "broadcast", "allgather", "alltoall",
    "reducescatter", "reduce_scatter_flat", "all_gather_flat",
    "Compression", "ErrorFeedbackCompressor",
]
