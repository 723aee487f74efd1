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
plain versions on the CPU) or ``"reference"`` (plain softmax attention).

Positions: ``pos_embedding="learned"`` (the ``wpe`` table) or ``"rope"``
(rotary, ``ops/rope.py``; no ``wpe`` parameter, as flax creates none): the
tables are computed once per forward for positions ``0..S-1`` and handed
to every block.

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
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.rope import apply_rope_tables, rope_tables
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
    attention_impl: str = "flash"  # flash | reference
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
    # An option of the reference model not ported yet: raises
    # NotImplementedError naming its ROADMAP item when set.
    moe_experts: int = 0

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


def _check_ported(cfg: TransformerConfig) -> None:
    """Raise for the reference options this port does not carry yet."""
    if cfg.attention_impl in ("ring", "zigzag", "ulysses"):
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r} is not ported yet "
            "(ROADMAP A11); 'flash' and 'reference' are"
        )
    if cfg.attention_impl not in ("flash", "reference"):
        raise ValueError(
            f"unknown attention_impl {cfg.attention_impl!r}; expected "
            "'flash' or 'reference'"
        )
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "moe_experts > 0 is not ported yet (ROADMAP A11)")


def _attend(cfg: TransformerConfig, q, k, v):
    """The configured attention schedule (always causal)."""
    if cfg.attention_impl == "flash":
        from ..ops.flash_attention import flash_attention  # noqa: PLC0415

        return flash_attention(
            q, k, v, causal=True,
            block_q=cfg.flash_block_q, block_k=cfg.flash_block_k,
            window=cfg.attention_window,
        )
    if cfg.attention_window is not None:
        raise ValueError(
            "attention_window is flash-only; "
            f"attention_impl={cfg.attention_impl!r} does not support it"
        )
    from ..parallel.ring_attention import local_attention  # noqa: PLC0415

    if cfg.kv_heads != cfg.num_heads:
        rep = cfg.num_heads // cfg.kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return local_attention(q, k, v, causal=True)


def block_math(cfg: TransformerConfig, x, rope_tabs, *, ln1, qkv, proj,
               ln2, mlp):
    """The pre-LN block wiring: ``LN -> qkv -> split heads -> rope ->
    attend -> proj (+res) -> LN -> mlp (+res)``; ``proj`` and ``mlp``
    return the residual delta; ``rope_tabs`` is ``(cos, sin)`` or
    ``None``."""
    def store(y):
        return act_store(y, cfg.act_store_dtype, cfg.dtype)

    b, s, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    q_dim, kv_dim = nh * hd, nkv * hd
    fused = qkv(ln1(x))
    q = fused[..., :q_dim].reshape(b, s, nh, hd)
    k = fused[..., q_dim:q_dim + kv_dim].reshape(b, s, nkv, hd)
    v = fused[..., q_dim + kv_dim:].reshape(b, s, nkv, hd)
    if rope_tabs is not None:
        q = apply_rope_tables(q, *rope_tabs)
        k = apply_rope_tables(k, *rope_tabs)
    att = store(_attend(cfg, q, k, v).reshape(b, s, q_dim))
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
        self.fc1 = Dense(e, cfg.mlp_ratio * e, dt)
        self.fc2 = Dense(cfg.mlp_ratio * e, e, dt)

    def forward(self, x, rope_tabs=None):
        return block_math(
            self.cfg, x, rope_tabs, ln1=self.ln1, qkv=self.qkv, proj=self.proj,
            ln2=self.ln2,
            mlp=lambda h: self.fc2(act_store(
                F.gelu(self.fc1(h), approximate="tanh"),
                self.cfg.act_store_dtype, self.cfg.dtype)),
        )


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
        _check_ported(cfg)
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

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.cfg.num_layers)]

    def forward(self, tokens: torch.Tensor):
        cfg = self.cfg
        s = tokens.shape[1]
        if s > cfg.max_len:
            raise ValueError(
                f"sequence length {s} exceeds max_len={cfg.max_len}")
        x = self.wte(tokens).to(cfg.dtype)
        rope_tabs = None
        if cfg.pos_embedding == "learned":
            x = x + self.wpe[:s].to(cfg.dtype)[None]
        else:
            # once for all blocks: a block's recompute does not redo them
            positions = torch.arange(s, device=tokens.device)
            rope_tabs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        for block in self.blocks():
            if self._remat_context is None:
                x = block(x, rope_tabs)
            else:
                x = checkpoint(block, x, rope_tabs, use_reentrant=False,
                               context_fn=self._remat_context)
        return self.head(self.lnf(x)).float()


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
