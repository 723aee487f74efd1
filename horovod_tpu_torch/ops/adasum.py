"""Adasum reduction (counterpart of ``horovod_tpu/ops/adasum.py``).

The pairwise rule for contributions ``a`` and ``b`` (reference
horovod/common/ops/adasum/adasum.h:239-263)::

    adasum(a, b) = (1 - a.b / (2 |a|^2)) * a  +  (1 - a.b / (2 |b|^2)) * b

the sum when ``a`` and ``b`` are orthogonal, their average when they are
equal.  :func:`adasum_allreduce` runs the reference's recursive scheme on a
power-of-2 world: log2(n) levels, level ``k`` combining each rank's running
fp32 vector with that of rank ``rank ^ 2^k``, which it receives whole in one
point-to-point exchange (the JAX package's ``ppermute``).  Both ranks of a
pair compute the same expression on the same two vectors (the lower rank's
vector first), so they hold bit-identical results and the tree stays
consistent.  The exchange is an autograd Function whose backward is the
same exchange of the cotangent (an XOR pairing is its own inverse, as
``ppermute``'s transpose is), and the projection is plain torch ops, so the
gradient runs through the coefficients as ``jax.grad`` does.

Adasum is per tensor: every call combines one tensor with its own
coefficients; callers must not fuse tensors into one buffer first.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["adasum_allreduce", "adasum_combine", "adasum_rows"]


def _numpy_adasum_rows(rows):
    """Host-side recursive Adasum of ``rows[i]`` = rank i's flat buffer, in
    float64 (a copy of the JAX package's ``_numpy_adasum_rows``, the eager
    engine's reduction): for a world that is not a power of 2, extra rank
    ``p + j`` (p the largest power of 2 <= n) folds into rank ``j`` first,
    then a balanced binary tree runs over the p-group."""
    import numpy as np  # noqa: PLC0415

    vecs = [np.asarray(r, np.float64) for r in rows]

    def combine(a, b):
        dot = float(np.dot(a, b))
        na2 = max(float(np.dot(a, a)), 1e-30)
        nb2 = max(float(np.dot(b, b)), 1e-30)
        return (1.0 - dot / (2 * na2)) * a + (1.0 - dot / (2 * nb2)) * b

    p = 1
    while p * 2 <= len(vecs):
        p *= 2
    extras = len(vecs) - p
    vecs = [
        combine(vecs[j], vecs[p + j]) if j < extras else vecs[j]
        for j in range(p)
    ]

    def rec(vs):
        if len(vs) == 1:
            return vs[0]
        half = len(vs) // 2
        return combine(rec(vs[:half]), rec(vs[half:]))

    return rec(vecs)


def adasum_rows(rows: torch.Tensor) -> torch.Tensor:
    """:func:`_numpy_adasum_rows` on a ``(world, n)`` tensor, on its
    device: the same folding of the extra ranks, the same tree and the
    same arithmetic, in the tensor's dtype (the eager engine passes fp64,
    so a CUDA payload's Adasum never leaves the card)."""
    vecs = list(rows.unbind(0))

    def combine(a, b):
        dot = torch.dot(a, b)
        na2 = torch.clamp(torch.dot(a, a), min=1e-30)
        nb2 = torch.clamp(torch.dot(b, b), min=1e-30)
        return (1.0 - dot / (2 * na2)) * a + (1.0 - dot / (2 * nb2)) * b

    p = 1
    while p * 2 <= len(vecs):
        p *= 2
    extras = len(vecs) - p
    vecs = [combine(vecs[j], vecs[p + j]) if j < extras else vecs[j]
            for j in range(p)]

    def rec(vs):
        if len(vs) == 1:
            return vs[0]
        half = len(vs) // 2
        return combine(rec(vs[:half]), rec(vs[half:]))

    return rec(vecs)


def adasum_combine(a, b, dot, na2, nb2, eps: float = 1e-30):
    """Combine two contributions given their inner products (reference
    adasum.h:239-263: per-pair scalar coefficients)."""
    a_coef = 1.0 - dot / (2.0 * torch.clamp(na2, min=eps))
    b_coef = 1.0 - dot / (2.0 * torch.clamp(nb2, min=eps))
    return a_coef * a + b_coef * b


def _exchange(x: torch.Tensor, peer: int, group) -> torch.Tensor:
    """Send ``x`` to global rank ``peer`` and receive its tensor of the
    same shape."""
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, peer, group),
        dist.P2POp(dist.irecv, out, peer, group),
    ])
    for req in reqs:
        req.wait()
    return out


class _Exchange(torch.autograd.Function):
    """The partner's vector; backward: the same exchange of the cotangent
    (the cotangent of what this rank received belongs to the partner's
    input)."""

    @staticmethod
    def forward(ctx, x, peer, group):
        ctx.peer, ctx.group = peer, group
        return _exchange(x.detach(), peer, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.peer, ctx.group), None, None


def adasum_allreduce(tensor: torch.Tensor, *, group=None) -> torch.Tensor:
    """Adasum-allreduce one tensor across the world (or ``group``, whose
    ranks are then the group's), the reference's recursive binary tree:
    level k combines each rank's running result with partner
    ``rank ^ 2^k``.  The world size must be a power of 2, as the
    reference's VHDD requires.  The math runs in fp32 whatever the input
    dtype; the result is cast back.  Differentiable."""
    n = dist.get_world_size(group)
    if n & (n - 1) != 0:
        raise ValueError(f"Adasum requires a power-of-2 world size, got {n}")
    me = dist.get_rank(group)
    flat = tensor.reshape(-1).to(torch.float32, copy=True)
    level = 1
    while level < n:
        partner = me ^ level
        peer = partner if group is None else dist.get_global_rank(group,
                                                                  partner)
        other = _Exchange.apply(flat, peer, group)
        # the same expression on both ranks of the pair: lower rank first
        lo, hi = (flat, other) if me < partner else (other, flat)
        dot = torch.dot(lo, hi)
        flat = adasum_combine(lo, hi, dot, torch.dot(lo, lo),
                              torch.dot(hi, hi))
        level <<= 1
    return flat.reshape(tensor.shape).to(tensor.dtype)
