"""Slot-based KV-cache incremental decoding for the GPT family
(counterpart of ``horovod_tpu/models/decode.py``, function for function).

The cache is a fixed pool of *slots* (batch rows) with per-slot write
positions, so a continuous-batching scheduler can admit a request into
one slot (:func:`assign_slot`) while the other slots keep decoding, all
through one ``decode_step`` shape.

* :func:`init_cache`: per-layer K/V ``[L, b, max_len, kv_heads,
  head_dim]`` in the compute dtype plus per-slot positions ``pos [b]``, a
  dict of tensors on the model's device.
* :func:`decode_step`: one token for every slot, its K/V appended at the
  slot's own position; ``write_mask`` freezes rows.
* :func:`prefill` / :func:`prefill_scan`: one causal forward writing the
  prompt's K/V in one shot, or the prompt fed token by token through
  :func:`decode_step` (the incremental oracle).
* :func:`generate`: greedy or sampled continuation, ``eos_id=`` freezing
  finished rows and stopping once every row is done.
* :func:`reset_slot` / :func:`assign_slot`: clear one slot; prefill one
  request into one slot with every other slot's rows untouched.
* :func:`init_paged_pool` / :func:`decode_step_paged` /
  :func:`assign_slot_paged`: the same over fixed-size pages named by
  per-slot block tables (``serve/paged.py``).

Each function takes the port's :class:`~.transformer.GPT` in place of the
reference's ``(cfg, params)``, and runs under ``torch.inference_mode()``.
The block wiring is not repeated here: every layer runs the model's
``Block`` (:func:`~.transformer.block_math`) with an ``attend`` override
that appends to the cache and attends against the prefix, so GQA and fp8
activation storage reach decoding unchanged.  RoPE is applied inside the
override with per-row tables (each slot sits at its own position).
Attention over the cache is an fp32 einsum, as the reference's
(``decode.py:115-168``): no kernel of this repo runs on this path.

Writes are in place (``index_put_``), where the reference returns a new
cache from a donated ``.at[].set``; the functions return the same dict
with a new ``pos``.  A masked or overrun row writes nothing (the
reference writes out of range and lets ``mode="drop"`` discard it); this
is decided on the device, without reading the mask back (``_write_rows``).
Decoding past a slot's cache end drops the write and poisons that slot's
logits with NaN.

Width sharding (the reference's ``tp_axis=`` / ``rep=`` keywords, and
``init_paged_pool(kv_heads=)``): pass a :class:`WidthShard`, this rank's
Megatron shard of the model over a width axis, wherever a model is taken.
Its blocks run ``parallel/tensor_parallel.py``'s column / row-parallel
math (two all-reduces a block over the axis) on ``kv_heads / width``
heads, so the cache and the pool hold only this rank's heads, and the
logits come out the same on every rank of the axis.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import prng

__all__ = [
    "init_cache",
    "decode_step",
    "prefill",
    "prefill_scan",
    "generate",
    "reset_slot",
    "assign_slot",
    "init_paged_pool",
    "decode_step_paged",
    "assign_slot_paged",
    "WidthShard",
]

_MASKED = torch.finfo(torch.float32).min / 2


class WidthShard:
    """This rank's width shard of a GPT, for the decode functions and the
    slot engine: ``sharded`` is its shard of ``stack_tp_params``'s
    sharded tree (leading dim 1, as ``local_shard`` gives it),
    ``replicated`` the replicated tree, ``tp_axis`` the width axis (a name
    of ``basics.init_axes`` or a process group).  It offers what the
    decode functions read of a model: ``cfg``, ``kv_heads`` (this rank's),
    ``embed``, ``blocks``, ``logits``, ``parameters``."""

    def __init__(self, cfg, sharded, replicated, tp_axis):
        from ..ops.collectives import _axis  # noqa: PLC0415
        from ..parallel.tensor_parallel import _map  # noqa: PLC0415

        _, self.width, self.index = _axis(tp_axis)
        self.cfg, self.tp_axis = cfg, tp_axis
        self.kv_heads = cfg.kv_heads // self.width
        self.shard = _map(lambda a: a[0], sharded)
        self.replicated = replicated

    def parameters(self):
        from ..parallel.tensor_parallel import flat_params  # noqa: PLC0415

        yield from flat_params(self.shard).values()
        yield from flat_params(self.replicated).values()

    def embed(self, tokens, positions=None):
        from ..parallel.tensor_parallel import _gpt_embed  # noqa: PLC0415

        x, _, rope_tabs = _gpt_embed(self.replicated, self.cfg, tokens, 0,
                                     positions)
        return x, rope_tabs

    def blocks(self):
        from ..parallel.tensor_parallel import _tp_block  # noqa: PLC0415

        def block(i):
            return lambda x, rope_tabs, attend=None: _tp_block(
                self.cfg, self.shard[f"block{i}"],
                self.replicated[f"block{i}"], x, rope_tabs, self.tp_axis,
                self.width, attend=attend)
        return [block(i) for i in range(self.cfg.num_layers)]

    def logits(self, x):
        from ..parallel.tensor_parallel import _gpt_head  # noqa: PLC0415

        return _gpt_head(self.replicated, self.cfg, x)


def _kv_heads(model) -> int:
    """The kv heads a model's cache holds: a width shard's own."""
    return getattr(model, "kv_heads", model.cfg.kv_heads)


def _dense_only(cfg) -> None:
    if cfg.moe_experts > 0:
        raise ValueError("decode cache supports dense blocks only")


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _kv_zeros(model, shape, slots: int) -> dict:
    cfg = model.cfg
    dev = _device(model)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "pos": torch.zeros(slots, dtype=torch.int64, device=dev),
    }


@torch.inference_mode()
def init_cache(model, batch: int, max_len: Optional[int] = None) -> dict:
    """Empty slot pool: per-layer K/V in the compute dtype and per-slot
    write positions ``pos [batch]``, on the model's device."""
    cfg = model.cfg
    _dense_only(cfg)
    s = max_len or cfg.max_len
    return _kv_zeros(model, (cfg.num_layers, batch, s, _kv_heads(model),
                             cfg.head_dim), batch)


def _slot_pos(cache, batch: int) -> torch.Tensor:
    """Per-slot positions ``[b]``; a legacy scalar ``pos`` (caches from
    before the slot layout) broadcasts to the batch."""
    pos = cache["pos"]
    if pos.dim() == 0:
        pos = pos.expand(batch)
    return pos


def _rope_rows(x, cos, sin):
    """Rotate ``x [b, 1, heads, hd]`` by per-row tables ``[b, hd // 2]``:
    ``ops.rope.apply_rope_tables``'s fp32 math with the broadcast on the
    batch axis."""
    half = x.shape[-1] // 2
    c = cos[:, None, None, :]
    s = sin[:, None, None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _band_mask(cfg, idx, last):
    """Positions ``idx`` a query at ``last`` must not see: the future and,
    with a window, everything before its lower edge."""
    mask = idx > last
    if cfg.attention_window is not None:
        mask = mask | (idx < last - (cfg.attention_window - 1))
    return mask


def _attend_cached(cfg, q, k_cache, v_cache, pos):
    """One query per slot against the slot's cache prefix: ``q [b, h,
    hd]``, ``k/v_cache [b, S, hkv, hd]``, ``pos [b]`` -> fp32 ``[b, h,
    hd]``.  GQA queries fold onto their kv group by reshape (no K/V
    broadcast); the kv-head count is read off the cache."""
    b, h, hd = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, hd).float()
    st = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * hd ** -0.5
    idx = torch.arange(s, device=q.device)[None, None, None, :]
    st = st.masked_fill(_band_mask(cfg, idx, pos[:, None, None, None]),
                        _MASKED)
    p = torch.softmax(st, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, h, hd)


def _attend_prefix(cfg, q, k_cache, v_cache):
    """Every prompt query against the just-written cache: ``q [b, s, h,
    hd]``, ``k/v_cache [b, S, hkv, hd]`` -> fp32 ``[b, s, h, hd]``; query
    ``t`` sees the mask the scanned path applies at ``pos == t``."""
    b, s, h, hd = q.shape
    big, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, hd).float()
    st = torch.einsum("btkgd,bskd->btkgs", qg, k_cache.float()) * hd ** -0.5
    idx = torch.arange(big, device=q.device)[None, None, None, None, :]
    t = torch.arange(s, device=q.device)[None, :, None, None, None]
    st = st.masked_fill(_band_mask(cfg, idx, t), _MASKED)
    p = torch.softmax(st, dim=-1)
    out = torch.einsum("btkgs,bskd->btkgd", p, v_cache.float())
    return out.reshape(b, s, h, hd)


def _write_rows(buf, dest, valid, new) -> None:
    """``buf[:, dest[j]] = new[:, j]`` for the rows ``j`` where ``valid``,
    in place, without reading ``valid`` on the host.  ``buf [M, N, ...]``
    (a view into the cache), ``dest [n]`` in ``[0, N)`` where valid,
    ``new [M, n, ...]``.  A row that is not valid writes nothing: it is
    sent to the first valid row's destination with that row's value (or,
    when no row is valid, to row 0 with row 0's own value), so every
    repeated index carries the same bits and the scatter leaves
    exactly the valid rows written."""
    n = dest.shape[0]
    rows = torch.arange(n, device=dest.device)
    first = torch.where(valid, rows, n).min().clamp(max=n - 1)
    hit = valid[first]
    anchor_dest = torch.where(hit, dest[first], 0)
    anchor_val = torch.where(hit, new[:, first], buf[:, 0])
    shape = (1, n) + (1,) * (new.dim() - 2)
    dest = torch.where(valid, dest, anchor_dest)
    vals = torch.where(valid.reshape(shape), new, anchor_val[:, None])
    buf[:, dest] = vals


def _decode_layers(model, x, rope_tabs, write, gather, pos):
    """Every block on one token per slot: RoPE per row, ``write(i, k, v)``
    appends the layer's K/V, ``gather(i)`` gives the slot-major ``[b, S,
    hkv, hd]`` prefix to attend against."""
    cfg = model.cfg
    for i, block in enumerate(model.blocks()):

        def attend(q, k_t, v_t, _i=i):
            if rope_tabs is not None:
                q = _rope_rows(q, *rope_tabs)
                k_t = _rope_rows(k_t, *rope_tabs)
            write(_i, k_t[:, 0].to(cfg.dtype), v_t[:, 0].to(cfg.dtype))
            kc, vc = gather(_i)
            return _attend_cached(cfg, q[:, 0], kc, vc, pos)[:, None]

        x = block(x, None, attend=attend)
    return model.logits(x)[:, 0]


def _finish(logits, cache, pos, capacity, write_mask):
    """NaN-poison the rows that decoded past ``capacity`` (and were meant
    to write) and advance the writing rows' positions."""
    overrun = pos >= capacity
    advance = torch.ones_like(pos)
    if write_mask is not None:
        overrun = overrun & write_mask
        advance = write_mask.to(pos.dtype)
    logits = logits.masked_fill(overrun[:, None], torch.nan)
    cache["pos"] = pos + advance
    return logits, cache


@torch.inference_mode()
def decode_step(model, cache: dict, tokens_t: torch.Tensor,
                write_mask: Optional[torch.Tensor] = None):
    """Decode one token per slot: ``tokens_t [b]`` -> ``(logits [b,
    vocab], cache)``, each slot's K/V appended at its own
    ``cache["pos"][slot]``.

    ``write_mask [b]`` (bool, default all true): rows where it is False
    are frozen, no K/V write and no position advance; their logits are
    meaningless.  A slot at the cache end writes nothing and gets NaN
    logits."""
    b = tokens_t.shape[0]
    pos = _slot_pos(cache, b)
    _, _, s_cache, hkv, hd = cache["k"].shape
    # each row at its own position; RoPE tables per row [b, hd // 2]
    x, rope_tabs = model.embed(tokens_t[:, None], pos[:, None])
    valid = pos < s_cache
    if write_mask is not None:
        valid = valid & write_mask
    rows = torch.arange(b, device=pos.device)
    dest = rows * s_cache + pos.clamp(max=s_cache - 1)

    def write(i, k_t, v_t):
        for name, new in (("k", k_t), ("v", v_t)):
            _write_rows(cache[name][i].view(1, b * s_cache, hkv, hd), dest,
                        valid, new[None])

    logits = _decode_layers(model, x, rope_tabs, write,
                            lambda i: (cache["k"][i], cache["v"][i]), pos)
    return _finish(logits, cache, pos, s_cache, write_mask)


def _prefill_into(model, tokens, cache):
    """One causal forward over ``tokens [b, s]`` writing every layer's K/V
    into positions ``[0, s)`` of ``cache``; per-position logits."""
    cfg = model.cfg
    s = tokens.shape[1]
    x, rope_tabs = model.embed(tokens)
    for i, block in enumerate(model.blocks()):

        def attend(q, k_t, v_t, _i=i):
            cache["k"][_i, :, :s] = k_t
            cache["v"][_i, :, :s] = v_t
            return _attend_prefix(cfg, q, cache["k"][_i], cache["v"][_i])

        x = block(x, rope_tabs, attend=attend)
    return model.logits(x)


@torch.inference_mode()
def prefill(model, tokens: torch.Tensor, max_len: Optional[int] = None,
            lengths=None):
    """Single-forward prefill: prompts ``[b, s]`` through one causal
    forward, every position's K/V written into a fresh cache.  Returns
    per-position logits ``[b, s, vocab]`` and the cache.  ``lengths [b]``:
    the true lengths of right-padded prompts (each slot's ``pos``)."""
    b, s = tokens.shape
    cache = init_cache(model, b, max_len)
    s_cache = cache["k"].shape[2]
    if s > s_cache:
        raise ValueError(
            f"prompt length {s} exceeds the {s_cache}-token cache; "
            f"raise max_len")
    logits = _prefill_into(model, tokens, cache)
    if lengths is None:
        cache["pos"].fill_(s)
    else:
        cache["pos"].copy_(torch.as_tensor(lengths))
    return logits, cache


@torch.inference_mode()
def prefill_scan(model, tokens: torch.Tensor, max_len: Optional[int] = None):
    """Token-by-token prefill through :func:`decode_step`: the oracle of
    :func:`prefill` (held to it at a tolerance: the two sum in another
    order, ROADMAP C0.2)."""
    b, s = tokens.shape
    cache = init_cache(model, b, max_len)
    out = []
    for t in range(s):
        logits, cache = decode_step(model, cache, tokens[:, t])
        out.append(logits)
    return torch.stack(out, dim=1), cache


@torch.inference_mode()
def reset_slot(cache: dict, slot: int) -> dict:
    """Clear slot ``slot``: zero its K/V rows, rewind its position; the
    other slots are untouched."""
    cache["k"][:, slot] = 0
    cache["v"][:, slot] = 0
    cache["pos"][slot] = 0
    return cache


def _prefill_one(model, tokens, length):
    """Prefill one (bucket-padded) prompt into a prompt-length mini-cache:
    ``(logits at the last real position, mini-cache)``."""
    s = tokens.shape[0]
    if length is None:
        length = s
    logits, one = prefill(model, tokens[None], max_len=s,
                          lengths=[int(length)])
    return logits[0, int(length) - 1], one, int(length)


@torch.inference_mode()
def assign_slot(model, cache: dict, slot: int, tokens: torch.Tensor,
                length=None):
    """Prefill one request into slot ``slot`` while every other slot's
    K/V stays untouched: the scheduler's admission.  ``tokens [s]`` may be
    right-padded to a bucket length, ``length`` the true one (default
    ``s``).  Returns ``(cache, last_logits [vocab])``, the prediction at
    the prompt's last real position.  Positions ``>= s`` of the slot keep
    the evicted request's K/V, masked by ``pos`` until overwritten."""
    s = tokens.shape[0]
    s_cache = cache["k"].shape[2]
    if s > s_cache:
        raise ValueError(
            f"assign_slot: {s} prompt tokens exceed the {s_cache}-token "
            f"slot cache")
    last, one, length = _prefill_one(model, tokens, length)
    cache["k"][:, slot, :s] = one["k"][:, 0]
    cache["v"][:, slot, :s] = one["v"][:, 0]
    cache["pos"][slot] = length
    return cache, last


@torch.inference_mode()
def init_paged_pool(model, num_pages: int, page_size: int,
                    num_slots: int, kv_heads: Optional[int] = None) -> dict:
    """Paged KV pool: per-layer K/V in ``num_pages`` pages of
    ``page_size`` rows shared by every slot ``[L, num_pages, page_size,
    kv_heads, head_dim]``, plus per-slot positions.  A slot's cache is
    whatever pages its block table names.  ``kv_heads`` overrides the
    head count (default the model's: a :class:`WidthShard`'s own)."""
    cfg = model.cfg
    _dense_only(cfg)
    hkv = kv_heads if kv_heads is not None else _kv_heads(model)
    return _kv_zeros(model, (cfg.num_layers, num_pages, page_size, hkv,
                             cfg.head_dim), num_slots)


@torch.inference_mode()
def decode_step_paged(model, pool: dict, tables: torch.Tensor,
                      tokens_t: torch.Tensor,
                      write_mask: Optional[torch.Tensor] = None):
    """One decode step through the block tables: ``tokens_t [b]`` ->
    ``(logits [b, vocab], pool)``.  Slot ``j``'s K/V lands in page
    ``tables[j, pos // page_size]`` at row ``pos % page_size``, and
    attention gathers the slot's pages back into its virtually contiguous
    prefix (logical position ``t`` at gathered index ``t``), so the math
    equals :func:`decode_step`'s whenever the virtual length matches.

    ``tables [b, max_pages]``: page ids; entries past a slot's allocated
    prefix are ``num_pages`` (the null page): writes there are dropped and
    the gather reads zeros.  Decoding past the virtual capacity drops the
    write and NaN-poisons the slot's logits.  ``model`` may be a
    :class:`WidthShard`: the pool then holds this rank's heads."""
    b = tokens_t.shape[0]
    pos = _slot_pos(pool, b)
    _, num_pages, ps, hkv, hd = pool["k"].shape
    mp = tables.shape[1]
    virt = mp * ps
    x, rope_tabs = model.embed(tokens_t[:, None], pos[:, None])
    page_of = tables.gather(1, (pos // ps).clamp(max=mp - 1)[:, None])[:, 0]
    valid = (pos < virt) & (page_of < num_pages)
    if write_mask is not None:
        valid = valid & write_mask
    dest = page_of.clamp(max=num_pages - 1) * ps + pos % ps
    null = (tables >= num_pages)[..., None, None, None]
    pages = tables.clamp(max=num_pages - 1)

    def write(i, k_t, v_t):
        for name, new in (("k", k_t), ("v", v_t)):
            _write_rows(pool[name][i].view(1, num_pages * ps, hkv, hd), dest,
                        valid, new[None])

    def gather(i):
        return tuple(pool[name][i][pages].masked_fill(null, 0).reshape(
            b, virt, hkv, hd) for name in ("k", "v"))

    logits = _decode_layers(model, x, rope_tabs, write, gather, pos)
    return _finish(logits, pool, pos, virt, write_mask)


@torch.inference_mode()
def assign_slot_paged(model, pool: dict, tables: torch.Tensor, slot: int,
                      tokens: torch.Tensor, length=None):
    """Admit one request into the paged pool: prefill the prompt into a
    contiguous mini-cache (:func:`prefill`'s math), then scatter its rows
    into the slot's pages.  Rows past the slot's allocated prefix hit the
    null page and are dropped; every other slot's pages are untouched.
    Returns ``(pool, last_logits [vocab])``.  ``model`` may be a
    :class:`WidthShard` (the prefill then runs on this rank's heads)."""
    s = tokens.shape[0]
    L, num_pages, ps, hkv, hd = pool["k"].shape
    mp = tables.shape[1]
    if s > mp * ps:
        raise ValueError(
            f"assign_slot_paged: {s} prompt tokens exceed the "
            f"{mp * ps}-row virtual slot capacity")
    last, one, length = _prefill_one(model, tokens, length)
    pidx = torch.arange(s, device=tables.device)
    pages = tables[slot][pidx // ps]
    dest = pages.clamp(max=num_pages - 1) * ps + pidx % ps
    for name in ("k", "v"):
        _write_rows(pool[name].view(L, num_pages * ps, hkv, hd), dest,
                    pages < num_pages, one[name][:, 0])
    pool["pos"][slot] = length
    return pool, last


@torch.inference_mode()
def generate(model, prompt: torch.Tensor, steps: int,
             max_len: Optional[int] = None, temperature: float = 0.0,
             top_k: int = 0, key: Optional[torch.Tensor] = None,
             eos_id: Optional[int] = None) -> torch.Tensor:
    """Continuation: ``prompt [b, s]`` -> ``[b, steps]`` tokens (int64).

    ``temperature == 0`` is greedy argmax; ``temperature > 0`` samples
    ``softmax(logits / temperature)`` with ``key`` (an ``ops.prng`` key,
    split into one key a step as the reference does), ``top_k > 0``
    truncating to the k most likely tokens first.  ``eos_id``: rows that
    emit it are frozen (masked writes, no advance, ``eos_id`` repeated as
    pad) and the loop stops once every row is done."""
    if temperature > 0 and key is None:
        raise ValueError("temperature > 0 requires a PRNG key")

    def pick(logits, k):
        if temperature <= 0:
            return torch.argmax(logits, dim=-1)
        lt = logits / temperature
        if top_k > 0:
            kth = torch.topk(lt, top_k, dim=-1).values[..., -1:]
            lt = torch.where(lt < kth, -torch.inf, lt)
        return prng.categorical(k, lt, axis=-1)

    b = prompt.shape[0]
    dev = prompt.device
    if steps <= 0:
        return torch.zeros((b, 0), dtype=torch.int64, device=dev)
    keys = (prng.split(key.to(dev), steps) if key is not None
            else torch.zeros((steps, 2), dtype=torch.int64, device=dev))
    logits, cache = prefill(model, prompt, max_len)
    tok = pick(logits[:, -1], keys[0])
    if eos_id is None:
        out = [tok]
        for i in range(1, steps):
            logits, cache = decode_step(model, cache, tok)
            tok = pick(logits, keys[i])
            out.append(tok)
        return torch.stack(out, dim=1)

    out = torch.full((b, steps), eos_id, dtype=torch.int64, device=dev)
    out[:, 0] = tok
    done = tok == eos_id
    for i in range(1, steps):
        if bool(done.all()):
            break
        logits, cache = decode_step(model, cache, tok, write_mask=~done)
        tok = torch.where(done, eos_id, pick(logits, keys[i]))
        out[:, i] = tok
        done = done | (tok == eos_id)
    return out
