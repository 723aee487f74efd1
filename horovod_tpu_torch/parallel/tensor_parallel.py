"""Megatron tensor parallelism for the GPT family (counterpart of
``horovod_tpu/parallel/tensor_parallel.py``).

The block's weights shard across a width axis (a name of
``basics.init_axes`` or a process group), one process per shard:

* qkv column-parallel, whole heads per rank, so each rank's attention
  runs on its ``num_heads / tp`` heads through the model's attention (the
  flash kernels on the card) with no exchange;
* proj row-parallel: one all-reduce rejoins the residual, the bias added
  once after it;
* fc1 column-parallel, fc2 row-parallel (one all-reduce).

The gradients are Megatron's: a column-parallel input passes through
``pvary`` (identity, its backward sums the ranks' cotangents: *f*), a
row-parallel output through ``psum`` (all-reduce, its backward passes the
cotangent through: *g*), which are the transposes the reference gets
from ``shard_map`` with replication tracking.  So the sharded weights'
gradients are the matching slices of the unsharded model's, and the
replicated weights' (LayerNorms, embeddings, post-reduce biases, the LM
head) are the unsharded model's on every rank.

Weights are trees: nested dicts of tensors keyed as the reference's
(``block0 -> qkv -> weight``, ...) with the port's layouts (a Dense
``weight`` ``[out, in]``).  :func:`stack_tp_params` splits a GPT into
``(sharded, replicated)``: every ``sharded`` leaf has a leading ``tp``
dim, and rank r passes ``local_shard(sharded, r)`` (leading dim 1, the
view ``shard_map`` gives a device) to :func:`tp_gpt_apply`.
``models.convert.tree_from_jax`` turns the reference's trees into these.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from ..ops.collectives import _axis, psum, pvary

__all__ = ["stack_tp_params", "unstack_tp_params", "tp_gpt_apply",
           "local_shard", "param_tree", "flat_params"]

_LN_EPS = 1e-6


def param_tree(params) -> dict:
    """A GPT's parameters as a nested tree of tensors: ``params`` is a
    ``GPT`` module, its ``state_dict()`` (dotted names) or already a
    tree.  Leaves are detached."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if not any("." in k for k in params):
        return {k: (param_tree(v) if isinstance(v, Mapping) else v.detach())
                for k, v in params.items()}
    tree: dict = {}
    for name, value in params.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value.detach()
    return tree


def flat_params(tree: Mapping, prefix: str = "") -> dict:
    """The inverse of :func:`param_tree`: dotted names, as a GPT's
    ``load_state_dict`` takes them."""
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            out.update(flat_params(sub, f"{prefix}{name}."))
        else:
            out[prefix + name] = sub
    return out


def _map(fn, tree):
    return {k: (_map(fn, v) if isinstance(v, Mapping) else fn(v))
            for k, v in tree.items()}


def local_shard(tree: Mapping, index: int) -> dict:
    """Shard ``index`` of a stacked tree, keeping a leading dim of 1 (what
    ``shard_map`` hands a device for ``in_specs=P(axis)``)."""
    return _map(lambda a: a[index:index + 1], tree)


def _split_qkv_rows(weight, bias, cfg, tp: int):
    """Split the fused qkv projection so rank r holds whole heads: its
    q rows, then its k rows, then its v rows.  Per-rank lists."""
    emb, kv_dim = cfg.emb_dim, cfg.kv_heads * cfg.head_dim
    parts_w = (weight[:emb], weight[emb:emb + kv_dim],
               weight[emb + kv_dim:])
    parts_b = (bias[:emb], bias[emb:emb + kv_dim], bias[emb + kv_dim:])
    ws = [w.chunk(tp, dim=0) for w in parts_w]
    bs = [b.chunk(tp) for b in parts_b]
    return ([torch.cat([w[r] for w in ws]) for r in range(tp)],
            [torch.cat([b[r] for b in bs]) for r in range(tp)])


def stack_tp_params(params, cfg, tp: int):
    """Split a GPT's parameters into ``(sharded, replicated)`` trees.

    ``sharded``: the block matrices with a leading ``tp`` dim (rank r's
    shard at index r).  ``replicated``: embeddings, LayerNorms, the
    post-reduce biases (``proj_bias``, ``fc2_bias``) and the LM head.
    Needs ``tp`` to divide ``num_heads``, ``kv_heads`` and the MLP
    width."""
    if cfg.num_heads % tp or cfg.kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide num_heads={cfg.num_heads} and "
            f"kv_heads={cfg.kv_heads}")
    if (cfg.mlp_ratio * cfg.emb_dim) % tp:
        raise ValueError(f"tp={tp} must divide the MLP width")
    p = param_tree(params)
    sharded, replicated = {}, {}
    for name, sub in p.items():
        if not name.startswith("block"):
            replicated[name] = sub
            continue
        if "fc1" not in sub:
            raise ValueError(
                "stack_tp_params supports dense blocks only; MoE blocks "
                "shard over the ep axis instead (parallel/moe.py "
                "moe_mlp_ep)")
        qw, qb = _split_qkv_rows(sub["qkv"]["weight"], sub["qkv"]["bias"],
                                 cfg, tp)
        sharded[name] = {
            "qkv": {"weight": torch.stack(qw), "bias": torch.stack(qb)},
            # row-parallel: split on the input dim; the biases apply once
            # after the reduce, so they sit on the replicated tree
            "proj": {"weight": torch.stack(
                sub["proj"]["weight"].chunk(tp, dim=1))},
            "fc1": {"weight": torch.stack(
                        sub["fc1"]["weight"].chunk(tp, dim=0)),
                    "bias": torch.stack(sub["fc1"]["bias"].chunk(tp))},
            "fc2": {"weight": torch.stack(
                sub["fc2"]["weight"].chunk(tp, dim=1))},
        }
        replicated[name] = {"ln1": sub["ln1"], "ln2": sub["ln2"],
                            "proj_bias": sub["proj"]["bias"],
                            "fc2_bias": sub["fc2"]["bias"]}
    return _map(lambda a: a.contiguous(), sharded), replicated


def unstack_tp_params(sharded, replicated, cfg, tp: int) -> dict:
    """Inverse of :func:`stack_tp_params`: the GPT's parameter tree
    (:func:`flat_params` of it loads into a ``GPT``)."""
    emb, kv_dim = cfg.emb_dim, cfg.kv_heads * cfg.head_dim
    qw, kw = emb // tp, kv_dim // tp
    out = {k: v for k, v in replicated.items() if not k.startswith("block")}
    for name, blk in sharded.items():
        lead = blk["qkv"]["weight"].shape[0]
        if lead != tp:
            raise ValueError(
                f"{name} shards carry leading dim {lead}, expected "
                f"tp={tp}: unstacking with a different tp than the tree "
                "was stacked with")
        rep = replicated[name]
        w, b = blk["qkv"]["weight"], blk["qkv"]["bias"]
        cuts = ((0, qw), (qw, qw + kw), (qw + kw, qw + 2 * kw))
        out[name] = {
            "ln1": rep["ln1"], "ln2": rep["ln2"],
            "qkv": {"weight": torch.cat([torch.cat(list(w[:, a:z]))
                                         for a, z in cuts]),
                    "bias": torch.cat([torch.cat(list(b[:, a:z]))
                                       for a, z in cuts])},
            "proj": {"weight": torch.cat(list(blk["proj"]["weight"]), dim=1),
                     "bias": rep["proj_bias"]},
            "fc1": {"weight": torch.cat(list(blk["fc1"]["weight"])),
                    "bias": torch.cat(list(blk["fc1"]["bias"]))},
            "fc2": {"weight": torch.cat(list(blk["fc2"]["weight"]), dim=1),
                    "bias": rep["fc2_bias"]},
        }
    return out


def raw_layer_norm(x, sub):
    """LayerNorm from a raw ``{weight, bias}`` subtree, fp32 math."""
    return F.layer_norm(x.float(), (x.shape[-1],), sub["weight"],
                        sub["bias"], _LN_EPS)


def raw_dense(sub, dtype):
    """A Dense layer from a raw ``{weight [out, in], bias}`` subtree in
    ``dtype`` (input and weights cast first, as ``layers.Dense``)."""
    def apply(h):
        b = sub.get("bias")
        return F.linear(h.to(dtype), sub["weight"].to(dtype),
                        None if b is None else b.to(dtype))
    return apply


def _gpt_embed(rep, cfg, tokens, pos_offset, positions):
    """The replicated embedding of the TP / PP / width-sharded paths:
    ``(x, positions, rope_tabs)``, :meth:`GPT.embed`'s math from the raw
    tree (the learned table gathered with NaN past ``max_len``)."""
    from ..ops.rope import rope_tables  # noqa: PLC0415

    s = tokens.shape[1]
    if s > cfg.max_len:
        raise ValueError(f"sequence length {s} exceeds max_len={cfg.max_len}")
    if positions is None:
        if cfg.attention_impl == "zigzag":
            raise ValueError(
                "attention_impl='zigzag' requires explicit positions "
                "(zigzag_positions(axis_index, P, s_local))")
        positions = pos_offset + torch.arange(s, device=tokens.device)
    x = F.embedding(tokens, rep["wte"]["weight"]).to(cfg.dtype)
    rope_tabs = None
    if cfg.pos_embedding == "learned":
        inside = (positions >= 0) & (positions < cfg.max_len)
        pe = rep["wpe"][positions.clamp(0, cfg.max_len - 1)]
        pe = torch.where(inside[..., None], pe, torch.nan)
        x = x + pe.to(cfg.dtype)
    else:
        rope_tabs = rope_tables(positions.reshape(-1), cfg.head_dim,
                                cfg.rope_theta)
    return x, positions, rope_tabs


def _gpt_head(rep, cfg, x):
    """The replicated epilogue: final LN, the LM head, fp32 logits."""
    h = raw_layer_norm(x, rep["lnf"])
    return F.linear(h.to(cfg.dtype), rep["head"]["weight"].to(cfg.dtype)
                    ).float()


def _tp_block(cfg, p, rep, x, rope_tabs, tp_axis, tp, attend=None):
    """One block on this rank's head / width shard: ``block_math`` with
    column-parallel qkv / fc1 (their input through ``pvary``) and
    row-parallel proj / fc2 (``psum``, then the replicated bias)."""
    from ..models.layers import act_store  # noqa: PLC0415
    from ..models.transformer import block_math  # noqa: PLC0415

    dt = cfg.dtype

    def col(sub):
        dense = raw_dense(sub, dt)
        return lambda h: dense(pvary(h, tp_axis))

    def row(weight, bias):
        return lambda h: psum(F.linear(h.to(dt), weight.to(dt)),
                              tp_axis) + bias.to(dt)

    def mlp(h):
        m = F.gelu(col(p["fc1"])(h), approximate="tanh")
        return row(p["fc2"]["weight"], rep["fc2_bias"])(
            act_store(m, cfg.act_store_dtype, dt))

    return block_math(
        cfg, x, rope_tabs,
        ln1=lambda h: raw_layer_norm(h, rep["ln1"]),
        qkv=col(p["qkv"]),
        proj=row(p["proj"]["weight"], rep["proj_bias"]),
        ln2=lambda h: raw_layer_norm(h, rep["ln2"]),
        mlp=mlp, attend=attend,
        num_heads=cfg.num_heads // tp, num_kv_heads=cfg.kv_heads // tp)


def tp_gpt_apply(sharded_params, replicated_params, cfg, tokens, tp_axis,
                 pos_offset=0, positions=None):
    """``GPT.forward`` with the block weights sharded over ``tp_axis``:
    ``sharded_params`` is this rank's shard (leading dim 1, as
    :func:`local_shard` gives it), ``replicated_params`` the replicated
    tree, ``tokens`` the same on every rank.  Returns fp32 logits, equal
    (up to the order of the sums) to the unsharded model's."""
    _, tp, _ = _axis(tp_axis)
    p = _map(lambda a: a[0], sharded_params)
    rep = replicated_params
    x, _, rope_tabs = _gpt_embed(rep, cfg, tokens, pos_offset, positions)
    for i in range(cfg.num_layers):
        x = _tp_block(cfg, p[f"block{i}"], rep[f"block{i}"], x, rope_tabs,
                      tp_axis, tp)
    return _gpt_head(rep, cfg, x)
