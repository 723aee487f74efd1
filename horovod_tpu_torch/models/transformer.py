"""GPT-style transformer (counterpart of
``horovod_tpu/models/transformer.py``).

Pre-LN decoder-only causal LM.  Submodule and parameter names mirror the
flax tree (``wte``, ``wpe``, ``block{i}.{ln1,qkv,proj,ln2,fc1,fc2}``,
``lnf``, ``head``), so
:func:`horovod_tpu_torch.models.convert.params_from_jax` maps one onto the
other.  The flax defaults are kept where PyTorch's differ:

* LayerNorm epsilon 1e-6, computed in fp32 with fp32 weights;
* GELU is the tanh approximation;
* a Dense layer casts its input and its fp32 weights to the compute dtype
  before the product, so the residual stream is in the compute dtype;
* the learned ``wpe`` table is fp32 and cast before the add; ``lnf`` runs
  in fp32, ``head`` in the compute dtype, and logits come back in fp32.

Attention: ``attention_impl="flash"`` (the CUDA kernels on the card, their
plain versions on the CPU), ``"reference"`` (plain softmax attention), or
a sequence-parallel schedule over ``sp_axis`` (``parallel/
ring_attention.py``): ``"ring"``, ``"zigzag"`` (the load-balanced causal
ring; needs explicit ``positions`` from ``zigzag_positions``) or
``"ulysses"``.  Under sequence parallelism each rank runs the model on its
shard of the sequence (``pos_offset`` the global position of its first
row, or ``positions``), and its parameter gradients are its tokens'
share: sum them over the sequence axis as over a data-parallel one.

Positions: ``pos_embedding="learned"`` (the ``wpe`` table) or ``"rope"``
(rotary, ``ops/rope.py``; no ``wpe`` parameter, as flax creates none): the
tables are computed once per forward and handed to every block.

``moe_experts > 0`` replaces every block's MLP by a mixture of experts
(``parallel/moe.py``: the reference's GShard dispatch with static
capacity; parameters ``router``, ``w1``, ``b1``, ``w2``, ``b2`` on the
block, as flax names them).  Each block's auxiliary load-balancing loss
is appended to the ``losses`` list the caller passes to ``forward``: the
reference's ``"losses"`` collection.

``act_store_dtype=torch.float8_e4m3fn`` stores the attention context, both
branch deltas and the GELU intermediate through e4m3 and back
(:func:`.layers.act_store`, the reference's ``act_store`` at the same
places).

``remat=True`` checkpoints each block as the reference's
``nn.remat(Block, policy=dots_with_no_batch_dims_saveable)``: non-reentrant
``torch.utils.checkpoint`` with a selective policy that saves the outputs
of the 2-D matrix products (the Dense layers) and recomputes everything
else in the backward, attention included (the flash forward launches
again).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.rope import apply_rope_tables, rope_tables
from ..parallel.moe import (DEFAULT_GROUP_SIZE as MOE_DEFAULT_GROUP_SIZE,
                            ROUTER_STD, moe_flax_params, moe_mlp,
                            moe_params_of)
from .layers import Dense, act_store

__all__ = ["TransformerConfig", "Block", "GPT", "GPT_CONFIGS", "gpt",
           "block_math"]

_LN_EPS = 1e-6  # flax nn.LayerNorm's default


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None  # GQA/MQA; None = MHA
    emb_dim: int = 768
    mlp_ratio: int = 4
    max_len: int = 1024
    dtype: torch.dtype = torch.bfloat16
    # flash | reference | ring | zigzag | ulysses
    attention_impl: str = "flash"
    # the sequence axis of ring / zigzag / ulysses: a name of
    # basics.init_axes or a process group
    sp_axis: Any = None
    attention_window: Optional[int] = None  # flash only
    pos_embedding: str = "learned"  # learned | rope
    rope_theta: float = 10000.0
    # Checkpoint each block, saving only the Dense products (see module doc)
    remat: bool = False
    # Tile hints for the plain flash versions (the CUDA kernels use their
    # own tiles); the reference's defaults.
    flash_block_q: int = 512
    flash_block_k: int = 256
    # Activation storage dtype (torch.float8_e4m3fn) of the saved
    # activations; None stores them in the compute dtype
    act_store_dtype: Optional[torch.dtype] = None
    # Mixture-of-experts MLP in every block (see the module docstring)
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_group_size: int = MOE_DEFAULT_GROUP_SIZE

    def __post_init__(self):
        if self.num_kv_heads is not None:
            if self.num_kv_heads <= 0 or self.num_heads % self.num_kv_heads:
                raise ValueError(
                    f"num_heads={self.num_heads} must be a positive "
                    f"multiple of num_kv_heads={self.num_kv_heads}"
                )
        if self.pos_embedding not in ("learned", "rope"):
            raise ValueError(
                f"pos_embedding must be 'learned' or 'rope', got "
                f"{self.pos_embedding!r}"
            )

    @property
    def head_dim(self) -> int:
        return self.emb_dim // self.num_heads

    @property
    def kv_heads(self) -> int:
        return (self.num_kv_heads if self.num_kv_heads is not None
                else self.num_heads)


ATTENTION_IMPLS = ("flash", "reference", "ring", "zigzag", "ulysses")


def _check_config(cfg: TransformerConfig) -> None:
    if cfg.attention_impl not in ATTENTION_IMPLS:
        raise ValueError(
            f"unknown attention_impl {cfg.attention_impl!r}; expected one "
            f"of {ATTENTION_IMPLS}"
        )


def _attend(cfg: TransformerConfig, q, k, v):
    """The configured attention schedule (always causal)."""
    impl = cfg.attention_impl
    if impl == "flash":
        from ..ops.flash_attention import flash_attention  # noqa: PLC0415

        return flash_attention(
            q, k, v, causal=True,
            block_q=cfg.flash_block_q, block_k=cfg.flash_block_k,
            window=cfg.attention_window,
        )
    if cfg.attention_window is not None:
        raise ValueError(
            "attention_window is flash-only; "
            f"attention_impl={impl!r} does not support it"
        )
    from ..parallel.ring_attention import (  # noqa: PLC0415
        local_attention, ring_attention, ring_attention_zigzag,
        ulysses_attention)

    if cfg.kv_heads != cfg.num_heads and impl in ("reference", "ulysses"):
        # these attend at full heads; the rings carry narrow k/v through
        # the shift and broadcast after
        rep = cfg.num_heads // cfg.kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if impl == "reference":
        return local_attention(q, k, v, causal=True)
    if cfg.sp_axis is None:
        raise ValueError(f"attention_impl={impl!r} requires sp_axis")
    if impl == "ring":
        return ring_attention(q, k, v, cfg.sp_axis, causal=True)
    if impl == "zigzag":
        return ring_attention_zigzag(q, k, v, cfg.sp_axis)
    return ulysses_attention(q, k, v, cfg.sp_axis, causal=True)


def block_math(cfg: TransformerConfig, x, rope_tabs, *, ln1, qkv, proj,
               ln2, mlp, attend=None, num_heads: Optional[int] = None,
               num_kv_heads: Optional[int] = None):
    """The pre-LN block wiring: ``LN -> qkv -> split heads -> rope ->
    attend -> proj (+res) -> LN -> mlp (+res)``; ``proj`` and ``mlp``
    return the residual delta; ``rope_tabs`` is ``(cos, sin)`` or
    ``None``.  ``attend`` overrides the attention schedule: a callable
    ``(q, k, v) -> att`` over the rope-applied ``[b, s, heads,
    head_dim]`` tensors (the KV-cache decode path, ``models/decode.py``,
    appends to its cache and attends against the prefix through it).
    ``num_heads`` / ``num_kv_heads`` override the config's for a rank's
    head shard (tensor parallelism, ``parallel/tensor_parallel.py``)."""
    def store(y):
        return act_store(y, cfg.act_store_dtype, cfg.dtype)

    b, s, _ = x.shape
    nh = num_heads if num_heads is not None else cfg.num_heads
    nkv = num_kv_heads if num_kv_heads is not None else cfg.kv_heads
    hd = cfg.head_dim
    q_dim, kv_dim = nh * hd, nkv * hd
    fused = qkv(ln1(x))
    q = fused[..., :q_dim].reshape(b, s, nh, hd)
    k = fused[..., q_dim:q_dim + kv_dim].reshape(b, s, nkv, hd)
    v = fused[..., q_dim + kv_dim:].reshape(b, s, nkv, hd)
    if rope_tabs is not None:
        q = apply_rope_tables(q, *rope_tabs)
        k = apply_rope_tables(k, *rope_tabs)
    if attend is None:
        attend_cfg = cfg
        if nh != cfg.num_heads or nkv != cfg.kv_heads:
            # a head shard: the schedule sees the local head geometry
            attend_cfg = replace(cfg, num_heads=nh, num_kv_heads=nkv,
                                 emb_dim=q_dim)
        att = _attend(attend_cfg, q, k, v)
    else:
        att = attend(q, k, v)
    att = store(att.reshape(b, s, q_dim))
    x = x + store(proj(att))
    return x + store(mlp(ln2(x)))


class _LayerNorm(nn.LayerNorm):
    """``flax.linen.LayerNorm(dtype=float32)``: fp32 math, eps 1e-6."""

    def __init__(self, dim):
        super().__init__(dim, eps=_LN_EPS)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class Block(nn.Module):
    """Pre-LN transformer block; the wiring is :func:`block_math`."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        e, dt = cfg.emb_dim, cfg.dtype
        kv_dim = cfg.kv_heads * cfg.head_dim
        self.ln1 = _LayerNorm(e)
        self.qkv = Dense(e, e + 2 * kv_dim, dt)
        self.proj = Dense(e, e, dt)
        self.ln2 = _LayerNorm(e)
        if cfg.moe_experts > 0:
            moe_flax_params(self, e, cfg.mlp_ratio * e, cfg.moe_experts)
        else:
            self.fc1 = Dense(e, cfg.mlp_ratio * e, dt)
            self.fc2 = Dense(cfg.mlp_ratio * e, e, dt)

    def _mlp(self, h, losses):
        cfg = self.cfg
        if cfg.moe_experts > 0:
            y, aux = moe_mlp(
                h, moe_params_of(self), top_k=cfg.moe_top_k,
                capacity_factor=cfg.moe_capacity_factor,
                group_size=cfg.moe_group_size, dtype=cfg.dtype,
                act_store_dtype=cfg.act_store_dtype)
            if losses is not None:
                losses.append(aux)
            # y comes back in ln2's fp32; the residual stream stays in the
            # compute dtype, as in the dense MLP
            return y.to(cfg.dtype)
        return self.fc2(act_store(F.gelu(self.fc1(h), approximate="tanh"),
                                  cfg.act_store_dtype, cfg.dtype))

    def forward(self, x, rope_tabs=None, attend=None, losses=None):
        """``losses``: a list each MoE block appends its aux loss to."""
        return block_math(
            self.cfg, x, rope_tabs, ln1=self.ln1, qkv=self.qkv, proj=self.proj,
            ln2=self.ln2, mlp=lambda h: self._mlp(h, losses), attend=attend,
        )


def _block_with_aux(block, x, rope_tabs):
    """``block`` on ``x``, and its MoE aux loss (None for a dense block):
    the unit a remat checkpoint wraps, so the recompute appends nowhere."""
    got: list = []
    y = block(x, rope_tabs, losses=got)
    return y, (got[0] if got else None)


def _remat_context_fn():
    """The ``context_fn`` of :func:`torch.utils.checkpoint.checkpoint` for
    the reference's ``dots_with_no_batch_dims_saveable`` policy: the
    outputs of 2-D matrix products (``mm``/``addmm``: the Dense layers)
    are saved, everything else is recomputed (batched products such as the
    reference attention's, and the flash kernels, which are no matrix
    product to the dispatcher).  Needs torch's selective-checkpoint API and
    raises ``ImportError`` without it, rather than recompute everything."""
    from torch.utils.checkpoint import (  # noqa: PLC0415
        CheckpointPolicy,
        create_selective_checkpoint_contexts,
    )

    saved = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return lambda: create_selective_checkpoint_contexts(policy)


class GPT(nn.Module):
    """Decoder-only causal LM.  ``tokens``: int ``[batch, seq]``; returns
    fp32 logits ``[batch, seq, vocab]``.

    Parameters are made on the CPU from ``generator`` (seed 0 when
    omitted) with the variances of the flax initializers: Dense weights
    N(0, 1/fan_in) and zero biases, ``wte`` N(0, 1/emb_dim), ``wpe``
    N(0, 0.02^2) (learned positions only), LayerNorms 1 and 0.  Move the
    module with ``.to()``.
    """

    def __init__(self, cfg: TransformerConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_config(cfg)
        self.cfg = cfg
        e = cfg.emb_dim
        self.wte = nn.Embedding(cfg.vocab_size, e)
        if cfg.pos_embedding == "learned":
            self.wpe = nn.Parameter(torch.empty(cfg.max_len, e))
        self._remat_context = _remat_context_fn() if cfg.remat else None
        for i in range(cfg.num_layers):
            self.add_module(f"block{i}", Block(cfg))
        self.lnf = _LayerNorm(e)
        self.head = Dense(e, cfg.vocab_size, cfg.dtype, bias=False)
        self._init_params(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def _init_params(self, g: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, Dense):
                mod.weight.normal_(0.0, mod.in_features ** -0.5, generator=g)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, _LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self.wte.weight.normal_(0.0, self.cfg.emb_dim ** -0.5, generator=g)
        if self.cfg.pos_embedding == "learned":
            self.wpe.normal_(0.0, 0.02, generator=g)
        if self.cfg.moe_experts > 0:
            d = self.cfg.emb_dim
            ff = self.cfg.mlp_ratio * d
            for block in self.blocks():
                block.router.normal_(0.0, ROUTER_STD, generator=g)
                block.w1.normal_(0.0, (2.0 / d) ** 0.5, generator=g)
                block.w2.normal_(0.0, (2.0 / ff) ** 0.5, generator=g)
                block.b1.zero_()
                block.b2.zero_()

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.cfg.num_layers)]

    def embed(self, tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None):
        """The embedding step (the reference's ``_gpt_embed``,
        horovod_tpu/parallel/tensor_parallel.py:198-225): ``(x,
        rope_tabs)`` for ``tokens`` ``[b, s]``.  ``positions``: int,
        ``[s]`` for every row or ``[b, s]`` per row; ``None`` means
        ``0..s-1``.  The learned table is gathered with NaN past
        ``max_len``, as ``jnp.take(mode="fill", fill_value=nan)`` does;
        the RoPE tables are ``[positions.numel(), head_dim // 2]`` (per
        row for ``[b, 1]`` positions), ``None`` for learned positions."""
        cfg = self.cfg
        s = tokens.shape[1]
        if s > cfg.max_len:
            raise ValueError(
                f"sequence length {s} exceeds max_len={cfg.max_len}")
        x = self.wte(tokens).to(cfg.dtype)
        if positions is None:
            positions = torch.arange(s, device=tokens.device)
            if cfg.pos_embedding == "learned":
                return x + self.wpe[:s].to(cfg.dtype)[None], None
        if cfg.pos_embedding == "learned":
            inside = (positions >= 0) & (positions < cfg.max_len)
            pe = self.wpe[positions.clamp(0, cfg.max_len - 1)]
            pe = torch.where(inside[..., None], pe, torch.nan)
            return x + pe.to(cfg.dtype), None
        # once for all blocks: a block's recompute does not redo them
        return x, rope_tables(positions.reshape(-1), cfg.head_dim,
                              cfg.rope_theta)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The head step (the reference's ``_gpt_head``): final LN, the LM
        head in the compute dtype, fp32 logits."""
        return self.head(self.lnf(x)).float()

    def forward(self, tokens: torch.Tensor, pos_offset: int = 0,
                positions: Optional[torch.Tensor] = None,
                losses: Optional[list] = None):
        """Logits of ``tokens`` (a shard of the sequence under sequence
        parallelism).  Positions: ``pos_offset``, the global position of
        ``tokens[:, 0]`` for a contiguous shard, or explicit ``positions
        [s]`` (required by the zigzag layout).  ``losses``: a list every
        MoE block appends its aux loss to."""
        s = tokens.shape[1]
        if positions is None:
            if self.cfg.attention_impl == "zigzag":
                # contiguous positions never match the zigzag layout
                raise ValueError(
                    "attention_impl='zigzag' requires explicit positions "
                    "(zigzag_positions(axis_index, P, s_local))")
            if pos_offset:
                positions = pos_offset + torch.arange(s, device=tokens.device)
        x, rope_tabs = self.embed(tokens, positions)
        for block in self.blocks():
            if self._remat_context is None:
                x = block(x, rope_tabs, losses=losses)
                continue
            x, aux = checkpoint(_block_with_aux, block, x, rope_tabs,
                                use_reentrant=False,
                                context_fn=self._remat_context)
            if aux is not None and losses is not None:
                losses.append(aux)
        return self.logits(x)


# Named sizes (GPT-2 family geometry, head_dim 64 beyond nano).
GPT_CONFIGS = {
    "nano": TransformerConfig(num_layers=3, num_heads=4, emb_dim=128,
                              max_len=256, vocab_size=1024),
    "small": TransformerConfig(num_layers=12, num_heads=12, emb_dim=768),
    "medium": TransformerConfig(num_layers=24, num_heads=16, emb_dim=1024),
    "large": TransformerConfig(num_layers=36, num_heads=20, emb_dim=1280),
}


def gpt(size: str = "small", *, device=None,
        generator: Optional[torch.Generator] = None, **overrides) -> GPT:
    """``gpt("small", dtype=torch.float32)`` etc.  The model lands on
    ``device``: the current GPU when ``None``."""
    cfg = GPT_CONFIGS[size]
    if overrides:
        cfg = replace(cfg, **overrides)
    model = GPT(cfg, generator=generator)
    return model.to("cuda" if device is None else device)
