"""Long-context serving over a sequence-sharded slot cache (counterpart
of ``horovod_tpu/serve/longctx.py``).

A slot whose context outgrows one GPU shards its K/V along the sequence
over an axis (a name of ``basics.init_axes`` or a process group): each
rank holds a contiguous ``[b, S/P, hkv, hd]`` chunk.

* :func:`ulysses_prefill_attention`: the prompt phase, the Ulysses
  reshard (``parallel.ring_attention.ulysses_attention``'s schedule).
* :func:`sharded_decode_attention`: the decode phase.  Each rank computes
  the flash-style partial softmax statistics ``(m, l, o)`` of the one
  query over its chunk, and one max and two sums over the axis merge
  them: O(b x h x hd) on the wire a step, the cache never moves.

fp32 softmax math, einsums as the reference's; no kernel of this repo
runs here.
"""

from __future__ import annotations

import torch

from ..ops.collectives import _axis, all_to_all, pmax, psum

__all__ = ["sharded_decode_attention", "ulysses_prefill_attention"]


def ulysses_prefill_attention(q, k, v, axis, *, causal: bool = True):
    """Prefill attention for sequence-sharded prompts ``q/k/v [b, s_local,
    h, hd]``: all-to-all to head shards, attention over the whole prompt,
    all-to-all back."""
    from ..parallel.ring_attention import local_attention  # noqa: PLC0415

    _, size, _ = _axis(axis)
    h = q.shape[2]
    if h % size != 0:
        raise ValueError(
            f"ulysses_prefill_attention requires heads ({h}) divisible by "
            f"the {axis!r} axis size ({size})")

    def seq_to_heads(x):
        return all_to_all(x, axis, split_axis=2, concat_axis=1)

    out = local_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                          causal=causal)
    return all_to_all(out, axis, split_axis=1, concat_axis=2)


def sharded_decode_attention(cfg, q, k_shard, v_shard, pos, axis):
    """One decode query per slot against a sequence-sharded cache.

    ``q [b, h, hd]`` (the same on every rank), ``k_shard/v_shard [b,
    S/P, hkv, hd]`` this rank's contiguous chunk, ``pos [b]`` each slot's
    global write position.  Returns the fp32 ``[b, h, hd]`` attention,
    the same on every rank.  The mask is ``models.decode``'s: a global
    index past ``pos`` (or below the sliding window's lower edge) is
    masked; a wholly masked chunk has ``l = 0`` and drops out of the
    merge."""
    _, _, idx = _axis(axis)
    b, h, hd = q.shape
    s_local = k_shard.shape[1]
    group = h // cfg.kv_heads
    offset = idx * s_local
    qg = q.reshape(b, cfg.kv_heads, group, hd).float()
    st = torch.einsum("bkgd,bskd->bkgs", qg, k_shard.float()) * hd ** -0.5
    gidx = (offset + torch.arange(s_local, device=q.device)
            )[None, None, None, :]
    pb = pos[:, None, None, None]
    mask = gidx > pb
    if cfg.attention_window is not None:
        mask = mask | (gidx < pb - (cfg.attention_window - 1))
    st = st.masked_fill(mask, float("-inf"))
    # partial statistics over the chunk; a wholly masked row has m = -inf,
    # so its subtrahend is clamped and its l is exactly 0
    m = st.amax(-1)                                           # [b, k, g]
    safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(st - safe_m[..., None])
    e = torch.where(torch.isfinite(st), e, torch.zeros_like(e))
    l = e.sum(-1)
    o = torch.einsum("bkgs,bskd->bkgd", e, v_shard.float())
    # the merge: rescale each chunk to the global max of the chunks that
    # contribute (a masked chunk's clamped 0 must not win the max)
    neg_inf = torch.full_like(safe_m, float("-inf"))
    gm = pmax(torch.where(l > 0, safe_m, neg_inf), axis)
    safe_gm = torch.where(torch.isfinite(gm), gm, torch.zeros_like(gm))
    scale = torch.where(l > 0, torch.exp(safe_m - safe_gm),
                        torch.zeros_like(l))
    gl = psum(l * scale, axis)
    go = psum(o * scale[..., None], axis)
    out = go / gl.clamp(min=1e-30)[..., None]
    return out.reshape(b, h, hd)
