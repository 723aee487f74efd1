"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

The JAX package ``horovod_tpu`` stays beside it as the reference; this
package imports ``torch`` only, never JAX nor anything of ``horovod_tpu``.

Execution model: **one process per GPU**, as in the original Horovod.
Where the JAX package runs one process over many devices under
``shard_map``, each process here owns one GPU (``cuda:local_rank``) and
the processes meet in the ``torch.distributed`` default process group —
NCCL on CUDA, gloo on the CPU.  Entry points run on the GPU unless the
caller passes ``device="cpu"``; with no GPU and no ``device="cpu"``,
:func:`init` raises.

The slices ported so far are the data-parallel GPT training step and
what ``bench.py --model gpt-*`` builds around it: ``init``, the
collectives, ``DistributedOptimizer`` with ``broadcast_parameters``, the
backward-overlap / ZeRO-1 plane (``optim.overlap``), the GPT model with
learned or rotary positions and remat, flash attention, whose three
kernels are hand-written CUDA for Hopper (``csrc/``), and the bench entry
``python -m horovod_tpu_torch.bench``; then the conv zoo (ResNet, VGG,
Inception V3, the MNIST nets) with ``SyncBatchNorm`` and its training
step, ``train.build_step``, whose convolutions are cuDNN's.
"""

from .basics import (
    NotInitializedError,
    cross_rank,
    cross_size,
    device,
    global_topology,
    init,
    is_homogeneous,
    is_initialized,
    local_rank,
    local_size,
    rank,
    shutdown,
    size,
)
from .ops.collectives import (
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
from .ops.compression import Compression, ErrorFeedbackCompressor
from .optim import (
    DistributedOptimizer,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "is_homogeneous", "device",
    "global_topology", "NotInitializedError",
    "ReduceOp", "Average", "Sum", "Adasum", "Min", "Max",
    "allreduce", "grouped_allreduce", "broadcast", "allgather",
    "alltoall", "reducescatter", "reduce_scatter_flat", "all_gather_flat",
    "Compression", "ErrorFeedbackCompressor",
    "DistributedOptimizer", "broadcast_parameters",
    "broadcast_optimizer_state", "broadcast_object",
]
