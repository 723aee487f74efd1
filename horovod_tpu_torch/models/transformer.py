"""GPT-style transformer (counterpart of
``horovod_tpu/models/transformer.py``).

Pre-LN decoder-only causal LM with learned positions.  Submodule and
parameter names mirror the flax tree (``wte``, ``wpe``,
``block{i}.{ln1,qkv,proj,ln2,fc1,fc2}``, ``lnf``, ``head``), so
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
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

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
    pos_embedding: str = "learned"
    # Tile hints for the plain flash versions (the CUDA kernels use their
    # own tiles); the reference's defaults.
    flash_block_q: int = 512
    flash_block_k: int = 256
    # Options of the reference model not ported yet: each raises
    # NotImplementedError naming its ROADMAP item when set.
    remat: bool = False
    moe_experts: int = 0
    act_store_dtype: Optional[torch.dtype] = None

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
    if cfg.pos_embedding == "rope":
        raise NotImplementedError(
            "pos_embedding='rope' is not ported yet (ROADMAP A4)")
    if cfg.remat:
        raise NotImplementedError("remat is not ported yet (ROADMAP A4)")
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "moe_experts > 0 is not ported yet (ROADMAP A11)")
    if cfg.act_store_dtype is not None:
        raise NotImplementedError(
            "act_store_dtype (fp8 activation storage) is not ported yet "
            "(ROADMAP A4)")


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


def block_math(cfg: TransformerConfig, x, *, ln1, qkv, proj, ln2, mlp):
    """The pre-LN block wiring: ``LN -> qkv -> split heads -> attend ->
    proj (+res) -> LN -> mlp (+res)``; ``proj`` and ``mlp`` return the
    residual delta."""
    b, s, _ = x.shape
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    q_dim, kv_dim = nh * hd, nkv * hd
    fused = qkv(ln1(x))
    q = fused[..., :q_dim].reshape(b, s, nh, hd)
    k = fused[..., q_dim:q_dim + kv_dim].reshape(b, s, nkv, hd)
    v = fused[..., q_dim + kv_dim:].reshape(b, s, nkv, hd)
    att = _attend(cfg, q, k, v).reshape(b, s, q_dim)
    x = x + proj(att)
    return x + mlp(ln2(x))


class _Dense(nn.Linear):
    """``flax.linen.Dense(dtype=...)``: input and fp32 weights cast to the
    compute dtype before the product."""

    def __init__(self, d_in, d_out, dtype, bias=True):
        super().__init__(d_in, d_out, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), b)


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
        self.qkv = _Dense(e, e + 2 * kv_dim, dt)
        self.proj = _Dense(e, e, dt)
        self.ln2 = _LayerNorm(e)
        self.fc1 = _Dense(e, cfg.mlp_ratio * e, dt)
        self.fc2 = _Dense(cfg.mlp_ratio * e, e, dt)

    def forward(self, x):
        return block_math(
            self.cfg, x, ln1=self.ln1, qkv=self.qkv, proj=self.proj,
            ln2=self.ln2,
            mlp=lambda h: self.fc2(F.gelu(self.fc1(h), approximate="tanh")),
        )


class GPT(nn.Module):
    """Decoder-only causal LM.  ``tokens``: int ``[batch, seq]``; returns
    fp32 logits ``[batch, seq, vocab]``.

    Parameters are made on the CPU from ``generator`` (seed 0 when
    omitted) with the variances of the flax initializers: Dense weights
    N(0, 1/fan_in) and zero biases, ``wte`` N(0, 1/emb_dim), ``wpe``
    N(0, 0.02^2), LayerNorms 1 and 0.  Move the module with ``.to()``.
    """

    def __init__(self, cfg: TransformerConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        e = cfg.emb_dim
        self.wte = nn.Embedding(cfg.vocab_size, e)
        self.wpe = nn.Parameter(torch.empty(cfg.max_len, e))
        for i in range(cfg.num_layers):
            self.add_module(f"block{i}", Block(cfg))
        self.lnf = _LayerNorm(e)
        self.head = _Dense(e, cfg.vocab_size, cfg.dtype, bias=False)
        self._init_params(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def _init_params(self, g: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, _Dense):
                mod.weight.normal_(0.0, mod.in_features ** -0.5, generator=g)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, _LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self.wte.weight.normal_(0.0, self.cfg.emb_dim ** -0.5, generator=g)
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
        x = x + self.wpe[:s].to(cfg.dtype)[None]
        for block in self.blocks():
            x = block(x)
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
