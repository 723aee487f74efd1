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
step, ``train.build_step``, whose convolutions are cuDNN's; then the rest
of the reductions (Adasum, sparse gradients, the two-level schedules over
the local and cross groups with a compressed cross leg), the topology API
and fp8 activation storage; then the eager named-tensor engine
(``runtime/``: negotiation, tensor fusion, the response cache, schedule
replay, ``join``) behind the asynchronous named API (``allreduce_async``,
``synchronize``, ...) and the ``horovod.torch``-compatible surface
(``interop.torch``, whose hook ``DistributedOptimizer`` rides the engine);
then the launcher (``python -m horovod_tpu_torch.run``, static and
``--elastic``), elastic training (``elastic``: ``State``, ``run``, the KV
rendezvous), the checkpoint tiers (``checkpoint``: ``save_checkpoint`` and
the ``Store``; ``ckpt``: the sharded format and the peer replicas) and
the training callbacks (``callbacks``); then serving (``serve``: decode,
the slot engine, the front door, the elastic serving fleet behind
``python -m horovod_tpu_torch.run --elastic --serve``, ``ServeJob`` and
the weight hot-swap), the function-shipping ``run.run(fn, np=...)`` and
``cluster``; and the observability planes (``obs``: metrics dumps, the
flight recorder and post-mortem, tracing, live telemetry, the memory
plane, and the training-health and divergence planes) with the step
anatomy and the bench's campaigns; the ``Estimator`` / ``Model``
frontend; and the TensorFlow, Keras and MXNet frontends (``interop``);
and the reference's SPMD training surface on process groups: ``mesh`` (a
``DeviceMesh`` over the port's groups), ``distribute`` (each rank steps on
its block of the batch), ``DistributedGradientTransform`` and
``sync_gradients`` (the gradients reduced inside the backward, bucket by
bucket), with the reference's examples as ``horovod_tpu_torch.examples``.

The names of the reference's top level that the port does not carry yet
would be in :data:`NOT_PORTED`, each with its ROADMAP item: reading one
raises :class:`NotPortedError` naming it.  It is empty: every name is
ported.
"""

from . import callbacks
from .basics import (
    CROSS_AXIS,
    DP_AXIS,
    LOCAL_AXIS,
    SLICE_AXIS,
    NotInitializedError,
    ccl_built,
    cross_rank,
    cross_size,
    ddl_built,
    device,
    device_rank,
    global_topology,
    gloo_built,
    gloo_enabled,
    init,
    is_homogeneous,
    is_initialized,
    local_rank,
    local_size,
    mesh,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    native_engine_built,
    nccl_built,
    num_devices,
    num_slices,
    rank,
    shutdown,
    size,
    slice_id,
    slice_of_rank,
    slice_size,
    xla_collectives_built,
)
from .checkpoint import (
    LocalStore,
    Store,
    latest_checkpoint_step,
    restore_checkpoint,
    save_checkpoint,
    save_checkpoint_async,
)
from .exceptions import NotPortedError
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
    allreduce_,
    alltoall,
    broadcast,
    broadcast_,
    grouped_allreduce,
    reduce_scatter_flat,
    reducescatter,
)
from .ops.compression import Compression, ErrorFeedbackCompressor
from .ops.eager import (
    allgather_async,
    allreduce_async,
    allreduce_async_,
    broadcast_async,
    broadcast_async_,
    join,
    poll,
    synchronize,
)
from .ops.sparse import IndexedSlices, allreduce_sparse
from .ops.sparse import to_dense as sparse_to_dense
from .optim import (
    DistributedGradientTransform,
    DistributedOptimizer,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
    distribute,
    overlap,
    sync_gradients,
)
from .optim.overlap import OverlapPlan
from .parallel.sync_batch_norm import SyncBatchNorm
from .estimator import Estimator, Model
from . import obs

__version__ = "0.1.0"

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "is_homogeneous", "device",
    "global_topology", "NotInitializedError", "num_devices", "device_rank",
    "slice_id", "num_slices", "slice_size", "slice_of_rank",
    "xla_collectives_built", "native_engine_built", "mpi_built",
    "mpi_enabled", "mpi_threads_supported", "gloo_built", "gloo_enabled",
    "nccl_built", "ccl_built", "ddl_built",
    "DP_AXIS", "CROSS_AXIS", "LOCAL_AXIS", "SLICE_AXIS",
    "ReduceOp", "Average", "Sum", "Adasum", "Min", "Max",
    "allreduce", "allreduce_", "grouped_allreduce", "broadcast",
    "broadcast_", "allgather", "alltoall", "reducescatter",
    "reduce_scatter_flat", "all_gather_flat",
    "allreduce_async", "allreduce_async_", "allgather_async",
    "broadcast_async", "broadcast_async_", "synchronize", "poll", "join",
    "Compression", "ErrorFeedbackCompressor",
    "IndexedSlices", "allreduce_sparse", "sparse_to_dense",
    "DistributedOptimizer", "broadcast_parameters",
    "broadcast_optimizer_state", "broadcast_object", "OverlapPlan",
    "overlap", "SyncBatchNorm", "NOT_PORTED", "NotPortedError",
    "Store", "LocalStore", "save_checkpoint", "save_checkpoint_async",
    "restore_checkpoint", "latest_checkpoint_step", "callbacks", "obs",
    "Estimator", "Model", "mesh", "distribute",
    "DistributedGradientTransform", "sync_gradients",
]


# Names of the reference's top level (horovod_tpu/__init__.py) still to
# port: name -> (ROADMAP item, what it is).  Keep in step with ROADMAP.
NOT_PORTED: dict = {}


def __getattr__(name):
    if name in NOT_PORTED:
        item, what = NOT_PORTED[name]
        raise NotPortedError(
            f"horovod_tpu_torch.{name} is not ported yet (ROADMAP {item}: "
            f"{what})")
    raise AttributeError(
        f"module 'horovod_tpu_torch' has no attribute {name!r}")
