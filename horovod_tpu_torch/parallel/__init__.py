"""Parallel schedules and layers of horovod_tpu_torch (counterpart of
``horovod_tpu/parallel``): the two-level collectives over the local and
cross groups, cross-replica batch norm, sequence parallelism (ring,
zigzag and Ulysses attention), mixture-of-experts with expert
parallelism, Megatron tensor parallelism and the GPipe / circular
pipelines.  The schedules take an axis name of ``basics.init_axes`` or a
process group where the reference takes a mesh axis name."""

from .hierarchical import hierarchical_adasum, hierarchical_allreduce
from .moe import MoEParams, init_moe_params, moe_mlp, moe_mlp_ep
from .pipeline import (
    pp_gpt_apply, pp_gpt_loss, pp_gpt_loss_circular, pp_tp_gpt_loss,
    stack_pp_params, stack_pp_params_circular, stack_tp_pp_params,
    unstack_pp_params, unstack_pp_params_circular, unstack_tp_pp_params,
)
from .ring_attention import (
    local_attention,
    ring_attention,
    ring_attention_zigzag,
    ulysses_attention,
    zigzag_positions,
    zigzag_shard,
    zigzag_unshard,
)
from .sync_batch_norm import SyncBatchNorm, sync_batch_stats
from .tensor_parallel import (
    local_shard, stack_tp_params, tp_gpt_apply, unstack_tp_params,
)

__all__ = [
    "hierarchical_adasum", "hierarchical_allreduce",
    "local_attention", "ring_attention", "ring_attention_zigzag",
    "ulysses_attention", "zigzag_positions", "zigzag_shard",
    "zigzag_unshard",
    "MoEParams", "init_moe_params", "moe_mlp", "moe_mlp_ep",
    "pp_gpt_apply", "pp_gpt_loss", "pp_gpt_loss_circular", "pp_tp_gpt_loss",
    "stack_pp_params", "stack_pp_params_circular", "stack_tp_pp_params",
    "unstack_pp_params", "unstack_pp_params_circular",
    "unstack_tp_pp_params",
    "SyncBatchNorm", "sync_batch_stats",
    "stack_tp_params", "tp_gpt_apply", "unstack_tp_params", "local_shard",
]
