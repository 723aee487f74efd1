"""Sequence parallelism: ring, zigzag-ring and Ulysses attention
(counterpart of ``horovod_tpu/parallel/ring_attention.py``).

The schedules run on ``[batch, seq_local, heads, head_dim]`` shards of a
sequence split over an axis (a name of ``basics.init_axes`` or a process
group), one process per shard, where the reference runs them inside
``shard_map``:

* :func:`ring_attention`: each rank keeps its Q shard while the K/V
  blocks travel the ring (``ops.collectives.ring_shift``, the
  reference's ``ppermute``), folded into an fp32 online softmax; under
  the causal mask a block from a later rank is skipped outright;
* :func:`ring_attention_zigzag`: the load-balanced causal ring over
  sequences laid out by :func:`zigzag_shard` (rank i holds chunks i and
  2P-1-i), two unmasked half-size attends per step after the self block;
* :func:`ulysses_attention`: one all-to-all turns sequence shards into
  head shards, plain attention runs on the whole sequence, a second
  all-to-all turns it back.

The block math is the reference's, an einsum per block with fp32 scores
and accumulators; GQA K/V travel at kv width and broadcast to the query
heads after the shift.

The backward of a shift is a shift the other way, which the neighbours'
backward must meet in the same order.  So K and V travel stacked, one
shift a step (a single chain, each backward waiting on the next step's),
and the last block in hand is tied into the output with weight zero: on
a rank whose causal mask skips the last blocks, their shifts still take
part in the backward.  No kernel of this repo runs here (the reference
runs no Pallas kernel on these schedules either).  All three are
differentiable through the collectives' autograd rules.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.collectives import _axis, all_to_all, ring_shift

__all__ = [
    "ring_attention",
    "ring_attention_zigzag",
    "ulysses_attention",
    "local_attention",
    "zigzag_positions",
    "zigzag_shard",
    "zigzag_unshard",
]


def _online_softmax_update(state, q_sub, k_sub, v_sub, scale, mask=None):
    """One online-softmax fold of ``q_sub`` (fp32) against a K/V block:
    ``state`` is ``(o [b, sq, h, d], m [b, h, sq], l [b, h, sq])`` in
    fp32; ``mask`` a bool ``[sq, sk]`` (True = masked)."""
    o, m, l = state
    if q_sub.shape[2] != k_sub.shape[2]:
        # GQA: k/v broadcast here, after the shift, so the wire carries
        # kv width
        rep = q_sub.shape[2] // k_sub.shape[2]
        k_sub = k_sub.repeat_interleave(rep, dim=2)
        v_sub = v_sub.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q_sub, k_sub.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(mask[None, None], float("-inf"))
    m_new = torch.maximum(m, scores.amax(-1))
    # both rings fold the (diagonal-masked) self block first, so m_new is
    # finite from the first fold on
    p = torch.exp(scores - m_new[..., None])
    corr = torch.exp(m - m_new)  # [b, h, q]
    l = l * corr + p.sum(-1)
    o = (o * corr.transpose(1, 2)[..., None]
         + torch.einsum("bhqk,bkhd->bqhd", p, v_sub.float()))
    return o, m_new, l


def local_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> torch.Tensor:
    """Plain softmax attention on ``[batch, seq, heads, head_dim]``.

    ``q_offset``/``kv_offset`` are the global positions of the first local
    row; the causal mask is taken in global coordinates.  Scores and
    softmax in fp32, the weighted sum in the input dtype, as the
    reference.
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        kv_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(kv_pos[None, :] > q_pos[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _init_state(b, sq, h, d, device):
    return (torch.zeros((b, sq, h, d), dtype=torch.float32, device=device),
            torch.full((b, h, sq), float("-inf"), dtype=torch.float32,
                       device=device),
            torch.zeros((b, h, sq), dtype=torch.float32, device=device))


def _finish(state):
    o, _, l = state
    return o / l.transpose(1, 2)[..., None]


def _tie(out, kv):
    """``out`` plus zero times one element of the last block in hand: its
    shift's backward then runs on every rank (see the module docstring)."""
    return out + 0.0 * kv.reshape(-1)[0].float()


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Ring attention over a sequence split along ``axis``.

    ``q/k/v`` are this rank's contiguous shard ``[batch, seq_local, heads,
    head_dim]``.  Each of the P steps folds one K/V block into the online
    softmax and passes the block on to the next rank.  At step t the block
    in hand came from rank ``(me - t) % P``; under ``causal`` a block from
    a later rank lies wholly above the diagonal and is skipped, and the
    mask is taken in global positions.
    """
    _, size, me = _axis(axis)
    b, s_local, h, d = q.shape
    scale_ = scale if scale is not None else d ** -0.5
    qf = q.float()
    q_pos = me * s_local + torch.arange(s_local, device=q.device)
    state = _init_state(b, s_local, h, d, q.device)
    kv = torch.stack([k, v])
    for t in range(size):
        src = (me - t) % size  # the original owner of the block in hand
        if not (causal and src > me):
            mask = None
            if causal:
                kv_pos = src * s_local + torch.arange(s_local,
                                                      device=q.device)
                mask = kv_pos[None, :] > q_pos[:, None]
            state = _online_softmax_update(state, qf, kv[0], kv[1], scale_,
                                           mask=mask)
        if t + 1 < size:
            kv = ring_shift(kv, axis)
    return _tie(_finish(state), kv).to(q.dtype)


def _zigzag_order(size: int, seq: int):
    """Chunk permutation of the zigzag layout: [0, 2P-1, 1, 2P-2, ...]."""
    if seq % (2 * size):
        raise ValueError(f"sequence {seq} not divisible by 2*size={2 * size}")
    return [c for i in range(size) for c in (i, 2 * size - 1 - i)]


def _apply_chunk_order(x, order, axis):
    chunks = torch.chunk(x, len(order), dim=axis)
    return torch.cat([chunks[c] for c in order], dim=axis)


def zigzag_shard(x: torch.Tensor, size: int, axis: int = 0) -> torch.Tensor:
    """Reorder a global sequence so an equal contiguous split over
    ``size`` ranks gives rank i the zigzag pair (chunk i, chunk
    2*size-1-i).  The length must divide by 2*size."""
    return _apply_chunk_order(x, _zigzag_order(size, x.shape[axis]), axis)


def zigzag_unshard(x: torch.Tensor, size: int, axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`zigzag_shard` on the same global view."""
    order = _zigzag_order(size, x.shape[axis])
    return _apply_chunk_order(x, list(np.argsort(order)), axis)


def zigzag_positions(axis_index: int, size: int, s_local: int,
                     device=None) -> torch.Tensor:
    """Global positions of rank ``axis_index``'s rows under the zigzag
    layout (first half chunk i, second half chunk 2*size-1-i)."""
    half = s_local // 2
    ar = torch.arange(half, device=device)
    return torch.cat([axis_index * half + ar,
                      (2 * size - 1 - axis_index) * half + ar])


def ring_attention_zigzag(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Load-balanced causal ring attention over zigzag-placed sequences.

    The global sequence went through :func:`zigzag_shard` before the
    split, so this rank's rows are ``concat(chunk_me, chunk_{2P-1-me})``
    (positions from :func:`zigzag_positions`), and the output comes back
    in that layout.  After the self block, the only masked compute, each
    step attends the block from rank ``src``: late queries see its early
    chunk always, early queries its early chunk iff ``src < me``, late
    queries its late chunk iff ``src > me``; early queries never see a
    late chunk.
    """
    _, size, me = _axis(axis)
    b, s_local, h, d = q.shape
    if s_local % 2:
        raise ValueError("zigzag requires an even local sequence length")
    half = s_local // 2
    scale_ = scale if scale is not None else d ** -0.5
    qf = q.float()

    def accum(state, q_sub, k_sub, v_sub, mask=None):
        return _online_softmax_update(state, q_sub, k_sub, v_sub, scale_,
                                      mask=mask)

    q_lo, q_hi = qf[:, :half], qf[:, half:]
    ar = torch.arange(half, device=q.device)
    tri = ar[None, :] > ar[:, None]  # k > q
    st_lo = accum(_init_state(b, half, h, d, q.device), q_lo, k[:, :half],
                  v[:, :half], mask=tri)
    st_hi = accum(_init_state(b, half, h, d, q.device), q_hi, k[:, half:],
                  v[:, half:], mask=tri)
    # late queries see all of this rank's early chunk
    st_hi = accum(st_hi, q_hi, k[:, :half], v[:, :half])
    kv = torch.stack([k, v])
    for t in range(1, size):
        kv = ring_shift(kv, axis)
        src = (me - t) % size
        kc, vc = kv[0, :, :half], kv[1, :, :half]  # src's early chunk
        kd, vd = kv[0, :, half:], kv[1, :, half:]  # src's late chunk
        if src < me:
            st_lo = accum(st_lo, q_lo, kc, vc)
        if src > me:
            st_hi = accum(st_hi, q_hi, kd, vd)
        st_hi = accum(st_hi, q_hi, kc, vc)
    out = torch.cat([_finish(st_lo), _finish(st_hi)], dim=1)
    return _tie(out, kv).to(q.dtype)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Ulysses sequence parallelism: all-to-all from sequence shards to
    head shards, plain attention over the whole sequence on ``heads / P``
    heads, all-to-all back.  ``heads`` must divide by the axis size."""
    _, size, _ = _axis(axis)
    h = q.shape[2]
    if h % size != 0:
        raise ValueError(
            f"ulysses_attention requires heads ({h}) divisible by the "
            f"{axis!r} axis size ({size}); use ring_attention for head "
            f"counts smaller than the axis."
        )

    def seq_to_heads(x):  # [b, s/P, h, d] -> [b, s, h/P, d]
        return all_to_all(x, axis, split_axis=2, concat_axis=1)

    out = local_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                          causal=causal, scale=scale)
    return all_to_all(out, axis, split_axis=1, concat_axis=2)
