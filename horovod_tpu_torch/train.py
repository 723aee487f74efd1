"""The data-parallel GPT training step (counterpart of the root
``bench.py::build_gpt_step``).

One process per GPU: each rank holds a replica of the model, takes its
slice of the global batch, and the gradients are averaged before an AdamW
update, so the replicas stay identical.  ``overlap_mode`` picks how:
``"off"`` is :class:`DistributedOptimizer` (one fused reduce in
``step()``), ``"bucket"`` and ``"bucket+zero1"`` the backward-overlap plane
of ``optim/overlap.py`` (per-bucket collectives issued during the
backward; ZeRO-1 also shards the AdamW state).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import basics
from .models.transformer import gpt
from .optim import DistributedOptimizer, broadcast_parameters
from .optim.overlap import MODES, OverlapPlan
from .ops.collectives import allreduce

__all__ = ["build_gpt_step", "lm_loss", "make_adamw"]

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def lm_loss(model, toks: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy on fp32 logits (the reference's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``)."""
    logits = model(toks[:, :-1])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           toks[:, 1:].reshape(-1))


def make_adamw(params) -> torch.optim.AdamW:
    """``optax.adamw(1e-4)``'s equivalent: lr 1e-4, betas (0.9, 0.999),
    eps 1e-8 and weight decay 1e-4 on every parameter."""
    return torch.optim.AdamW(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def build_gpt_step(size: str, dtype: str, batch_size: int, seq_len: int,
                   attention: str = "flash", remat: bool = False,
                   flash_block_q: int = 512, flash_block_k: int = 256,
                   kv_heads: int = 0, pos_embedding: str = "learned",
                   moe_experts: int = 0, attention_window: int = 0,
                   overlap_mode: str = "off", grad_bucket_mb=None, *,
                   device=None):
    """GPT causal-LM training step, with the reference's keywords and
    defaults.  Returns ``(step, state, static)`` like the reference:
    ``step(*state) -> (model, optimizer, loss)`` with ``state = (model,
    optimizer, tokens)``, where ``tokens`` is this rank's slice of the
    global batch and ``loss`` is the mean over the world.  ``batch_size``
    is per GPU; ``device=None`` is this process's GPU.

    ``optimizer`` is a :class:`DistributedOptimizer` around
    :func:`make_adamw` (``overlap_mode="off"``), or an
    :class:`~horovod_tpu_torch.optim.overlap.OverlapPlan` of that mode
    with buckets of ``grad_bucket_mb`` (None: ``HVDTPU_GRAD_BUCKET_MB`` or
    16).
    """
    if dtype not in _DTYPES:
        raise NotImplementedError(
            f"dtype {dtype!r} is not ported yet (ROADMAP A4); "
            f"use one of {sorted(_DTYPES)}")
    if overlap_mode not in MODES:
        raise ValueError(
            f"overlap_mode must be one of {MODES}, got {overlap_mode!r}")
    topo = basics.init(device=device)
    dev = topo.device
    n_gpus = topo.process_count
    model = gpt(size, device=dev, dtype=_DTYPES[dtype], max_len=seq_len,
                attention_impl=attention, remat=remat,
                flash_block_q=flash_block_q, flash_block_k=flash_block_k,
                num_kv_heads=kv_heads or None, pos_embedding=pos_embedding,
                moe_experts=moe_experts,
                attention_window=attention_window or None)
    vocab = model.cfg.vocab_size

    global_batch = batch_size * n_gpus
    tokens = np.random.RandomState(0).randint(
        0, vocab, size=(global_batch, seq_len + 1))
    r = topo.process_rank
    local = torch.from_numpy(
        tokens[r * batch_size:(r + 1) * batch_size]).to(dev)
    broadcast_parameters(model.state_dict(), root_rank=0)

    if overlap_mode == "off":
        opt = DistributedOptimizer(make_adamw(model.parameters()))
    else:
        opt = OverlapPlan(model.parameters(), make_adamw, mode=overlap_mode,
                          bucket_mb=grad_bucket_mb)

    def step(model, opt, toks):
        opt.zero_grad()
        loss = lm_loss(model, toks)
        loss.backward()
        opt.step()
        # the mean over the world, so a non-finite loss on any rank shows
        return model, opt, allreduce(loss.detach())

    state = (model, opt, local)
    return step, state, {"n_chips": n_gpus, "global_batch": global_batch,
                         "carry_len": 2}
