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

The slice ported so far is the data-parallel GPT training step:
``init``, the collectives, ``DistributedOptimizer`` with
``broadcast_parameters``, the GPT model, and flash attention, whose three
kernels are hand-written CUDA for Hopper (``csrc/``).
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
    allreduce,
    broadcast,
    grouped_allreduce,
)
from .ops.compression import Compression
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
    "allreduce", "grouped_allreduce", "broadcast", "Compression",
    "DistributedOptimizer", "broadcast_parameters",
    "broadcast_optimizer_state", "broadcast_object",
]
