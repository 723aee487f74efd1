"""Mixture-of-experts with expert parallelism (counterpart of
``horovod_tpu/parallel/moe.py``).

The GShard formulation, as the reference has it: top-k routing becomes
one-hot ``dispatch`` / ``combine`` tensors ``[n, E, C]`` with a fixed
capacity C per expert, so the layer is einsums of static shapes; tokens
route within groups of at most ``group_size`` (padding rows claim no
slot); overflow drops (the token rides the residual); the Switch
auxiliary loss ``E * sum_e fraction_e * mean_gate_e`` is 1 at uniform
routing.  The dispatch and combine einsums run in fp32, the experts'
FFN in the compute dtype.

:func:`moe_mlp_ep` shards the experts over an axis (a name of
``basics.init_axes`` or a process group): each rank routes its own
tokens, one all-to-all carries every expert's slots to its owner and one
brings the outputs home, and the aux loss is averaged over the axis.
Its result equals :func:`moe_mlp` run on each rank's tokens with the
whole expert set.  Its gradients follow the reference's recipe (the
router's gradient averaged over the axis, the experts' divided by its
size: the gradients of the mean of the ranks' losses).

Parameters are :class:`MoEParams` in the reference's layout (``router [d,
E]``, ``w1 [E, d, ff]``, ``w2 [E, ff, d]``), so flax's leaves load as
they are.  No kernel of this repo runs here: the reference's MoE is XLA
einsums.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.collectives import _axis, all_to_all, pmean, pvary

__all__ = ["init_moe_params", "moe_mlp", "moe_mlp_ep", "MoEParams",
           "DEFAULT_GROUP_SIZE", "ROUTER_STD"]

# the reference's initialization: small-normal router, fan-in-scaled FFN
ROUTER_STD = 0.02

# Routing group (GShard grouping): dispatch/combine stay O(n * group).
DEFAULT_GROUP_SIZE = 4096


def _ffn_scales(d: int, ff: int):
    return (2.0 / d) ** 0.5, (2.0 / ff) ** 0.5


class MoEParams(NamedTuple):
    """Weights of one MoE MLP: the router and E experts' FFNs."""

    router: torch.Tensor  # [d, E]
    w1: torch.Tensor      # [E, d, ff]
    b1: torch.Tensor      # [E, ff]
    w2: torch.Tensor      # [E, ff, d]
    b2: torch.Tensor      # [E, d]


def init_moe_params(generator: torch.Generator, d: int, ff: int,
                    num_experts: int, dtype=torch.float32,
                    device=None) -> MoEParams:
    """Fresh weights from ``generator`` (made on the CPU, moved to
    ``device``) with the reference's variances: router N(0, 0.02^2), w1
    N(0, 2/d), w2 N(0, 2/ff), zero biases."""
    s1, s2 = _ffn_scales(d, ff)

    def normal(shape, std):
        return (torch.randn(shape, generator=generator) * std).to(
            device=device, dtype=dtype)

    return MoEParams(
        router=normal((d, num_experts), ROUTER_STD),
        w1=normal((num_experts, d, ff), s1),
        b1=torch.zeros((num_experts, ff), dtype=dtype, device=device),
        w2=normal((num_experts, ff, d), s2),
        b2=torch.zeros((num_experts, d), dtype=dtype, device=device),
    )


def _routing(x2, router, num_experts: int, top_k: int, capacity: int,
             valid):
    """Routing of the groups ``x2 [G, n, d]``: ``(dispatch [G, n, E, C],
    combine [G, n, E, C], aux [G])``.  ``valid [G, n]`` marks real tokens:
    padding claims no capacity slot and is left out of the aux
    statistics.  The reference's ``_routing`` vmapped over the groups."""
    valid = valid.float()
    n_valid = valid.sum(1).clamp(min=1.0)                  # [G]
    logits = x2.float() @ router.float()
    gates = torch.softmax(logits, dim=-1)                  # [G, n, E]
    top1 = gates.argmax(-1)
    me = (F.one_hot(top1, num_experts).float() * valid[..., None]
          ).sum(1) / n_valid[:, None]
    ce = (gates * valid[..., None]).sum(1) / n_valid[:, None]
    aux = num_experts * (me * ce).sum(-1)                  # [G]

    g, n, _ = gates.shape
    dispatch = gates.new_zeros((g, n, num_experts, capacity))
    combine = gates.new_zeros((g, n, num_experts, capacity))
    remaining = gates
    fill = torch.zeros((g, num_experts), dtype=torch.int64,
                       device=gates.device)
    for _ in range(top_k):
        idx = remaining.argmax(-1)                          # [G, n]
        gate_k = remaining.gather(-1, idx[..., None])[..., 0]
        onehot = F.one_hot(idx, num_experts).float() * valid[..., None]
        # position of each token in its expert's queue this round
        pos_in_e = onehot.cumsum(1) - 1.0
        slot = ((pos_in_e * onehot).sum(-1).to(torch.int64)
                + fill.gather(1, idx))                      # [G, n]
        keep = slot < capacity                              # overflow drops
        slot_oh = F.one_hot(torch.where(keep, slot, capacity),
                            capacity + 1)[..., :capacity].float()
        d_k = onehot[..., :, None] * slot_oh[..., None, :]  # [G, n, E, C]
        dispatch = dispatch + d_k
        combine = combine + d_k * gate_k[..., None, None]
        fill = fill + (onehot * keep[..., None]).sum(1).to(torch.int64)
        remaining = remaining * (1.0 - onehot)
    # normalize the combine weights over the selected experts per token
    denom = combine.sum(dim=(2, 3), keepdim=True)
    combine = torch.where(denom > 0, combine / denom.clamp(min=1e-9),
                          combine.new_zeros(()))
    return dispatch, combine, aux


def _grouped_routing(x2, router, num_experts, top_k, capacity_factor,
                     group_size):
    """Route ``x2 [n, d]`` within groups of ``min(group_size, n)``, padding
    the last with invalid rows: ``(xg [G, g, d], dispatch, combine,
    capacity, aux, n)`` with ``aux`` the mean over the groups."""
    n, d = x2.shape
    g = min(group_size, n)
    pad = (-n) % g
    if pad:
        x2 = F.pad(x2, (0, 0, 0, pad))
    valid = torch.arange(n + pad, device=x2.device) < n
    xg = x2.reshape((n + pad) // g, g, d)
    vg = valid.reshape((n + pad) // g, g)
    capacity = max(1, int(math.ceil(capacity_factor * g * top_k
                                    / num_experts)))
    dispatch, combine, aux = _routing(xg, router, num_experts, top_k,
                                      capacity, vg)
    return xg, dispatch, combine, capacity, aux.mean(), n


def _expert_ffn(buf, w1, b1, w2, b2, dtype, act_store_dtype=None):
    """The experts' FFN on ``buf [E_local, C, d]`` in ``dtype``; the GELU
    intermediate goes through ``act_store_dtype`` when set (the MoE leg
    of the fp8 activation storage)."""
    from ..models.layers import act_store  # noqa: PLC0415

    h = torch.einsum("ecd,edf->ecf", buf.to(dtype), w1.to(dtype))
    h = F.gelu(h + b1[:, None, :].to(dtype), approximate="tanh")
    h = act_store(h, act_store_dtype, dtype)
    out = torch.einsum("ecf,efd->ecd", h, w2.to(dtype))
    return out + b2[:, None, :].to(dtype)


def _dispatch(xg, dispatch, num_experts, capacity):
    """Every expert's slots ``[E, G * C, d]`` (fp32)."""
    g_count, _, d = xg.shape
    buf = torch.einsum("gnec,gnd->gecd", dispatch, xg.float())
    return buf.transpose(0, 1).reshape(num_experts, g_count * capacity, d)


def _combine(out, combine, n, shape, dtype):
    """The experts' outputs ``[E, G * C, d]`` weighted back onto the
    tokens (fp32), padding dropped."""
    g_count, _, num_experts, capacity = combine.shape
    d = out.shape[-1]
    out = out.reshape(num_experts, g_count, capacity, d).transpose(0, 1)
    y = torch.einsum("gnec,gecd->gnd", combine, out.float())
    return y.reshape(-1, d)[:n].reshape(shape).to(dtype)


def moe_mlp(x, params: MoEParams, *, top_k: int = 2,
            capacity_factor: float = 2.0,
            group_size: int = DEFAULT_GROUP_SIZE,
            dtype=torch.float32, act_store_dtype=None):
    """Dense MoE MLP: ``x [b, s, d]`` -> ``(y [b, s, d], aux_loss)``.
    Capacity per expert per group is ``ceil(capacity_factor * group *
    top_k / E)``; an overflowing token gets no MLP contribution."""
    b, s, d = x.shape
    num_experts = params.router.shape[1]
    xg, dispatch, combine, capacity, aux, n = _grouped_routing(
        x.reshape(b * s, d), params.router, num_experts, top_k,
        capacity_factor, group_size)
    buf = _dispatch(xg, dispatch, num_experts, capacity)
    out = _expert_ffn(buf, params.w1, params.b1, params.w2, params.b2,
                      dtype, act_store_dtype)
    return _combine(out, combine, n, (b, s, d), x.dtype), aux


def moe_mlp_ep(x, params: MoEParams, ep_axis, *, top_k: int = 2,
               capacity_factor: float = 2.0,
               group_size: int = DEFAULT_GROUP_SIZE, dtype=torch.float32,
               act_store_dtype=None):
    """Expert-parallel MoE MLP over ``ep_axis``.

    ``x [b_local, s, d]`` is this rank's tokens (every rank the same
    count); ``params.w1/b1/w2/b2`` this rank's ``E / P`` experts (rank r
    holds experts ``[r * E/P, (r+1) * E/P)``); ``params.router`` the whole
    router, replicated.  Capacity counts local tokens, as the dense layer
    run per shard does.  One all-to-all each way; the aux loss is the
    mean over the axis and feeds every rank's own loss, so its backward
    sums the ranks' cotangents (``pvary(pmean(.))``, the reference's
    ``pmean`` under ``shard_map`` without replication tracking).
    """
    _, p, _ = _axis(ep_axis)
    b, s, d = x.shape
    e_local = params.w1.shape[0]
    num_experts = e_local * p
    if params.router.shape[1] != num_experts:
        raise ValueError(
            f"router has {params.router.shape[1]} experts but the sharded "
            f"weights imply {e_local} x {p} ranks = {num_experts}")
    xg, dispatch, combine, capacity, aux, n = _grouped_routing(
        x.reshape(b * s, d), params.router, num_experts, top_k,
        capacity_factor, group_size)
    buf = _dispatch(xg, dispatch, num_experts, capacity)
    cap_total = buf.shape[1]
    buf = buf.reshape(p, e_local, cap_total, d)
    buf = all_to_all(buf, ep_axis, 0, 0, tiled=False)  # [P, e_local, ., d]
    buf = buf.transpose(0, 1).reshape(e_local, p * cap_total, d)
    out = _expert_ffn(buf, params.w1, params.b1, params.w2, params.b2,
                      dtype, act_store_dtype)
    out = out.reshape(e_local, p, cap_total, d).transpose(0, 1)
    out = all_to_all(out.contiguous(), ep_axis, 0, 0, tiled=False)
    out = out.reshape(num_experts, cap_total, d)
    y = _combine(out, combine, n, (b, s, d), x.dtype)
    return y, pvary(pmean(aux, ep_axis), ep_axis)


def moe_flax_params(module, d: int, ff: int, num_experts: int):
    """Declare the MoE weights on ``module`` as fp32 parameters ``router``,
    ``w1``, ``b1``, ``w2``, ``b2`` (the names flax gives them on the
    reference's ``Block``), uninitialized: the owner draws them (the GPT's
    init, with :func:`init_moe_params`'s variances); returns them as
    :class:`MoEParams`."""
    shapes = {"router": (d, num_experts), "w1": (num_experts, d, ff),
              "b1": (num_experts, ff), "w2": (num_experts, ff, d),
              "b2": (num_experts, d)}
    for name, shape in shapes.items():
        module.register_parameter(name, torch.nn.Parameter(
            torch.empty(shape)))
    return moe_params_of(module)


def moe_params_of(module) -> MoEParams:
    """The :class:`MoEParams` a module declared with
    :func:`moe_flax_params`."""
    return MoEParams(*(getattr(module, f) for f in MoEParams._fields))
