"""Map a flax variable tree onto the port's ``state_dict`` names.

The trees come in as nested dicts of **numpy** arrays (convert a jax tree
with ``np.asarray`` on each leaf first), so this module needs no JAX.
The port's modules carry flax's names, so the map is a rename of the
leaves plus a layout change of the kernels.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

__all__ = ["params_from_jax", "variables_from_jax", "tree_from_jax",
           "jax_leaf_names", "bucket_components"]

# flax leaf name -> the port's
_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "mean": "running_mean", "var": "running_var"}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _leaf(name: str, a) -> torch.Tensor:
    t = _tensor(a)
    if name != "kernel":
        return t
    if t.dim() == 2:  # Dense [in, out] -> Linear [out, in]
        return t.T.contiguous()
    return t.permute(3, 2, 0, 1).contiguous()  # conv HWIO -> OIHW


def _walk(tree: Mapping, prefix: str, out: dict) -> None:
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            _walk(sub, f"{prefix}{name}.", out)
        else:  # a bare parameter such as the GPT's ``wpe`` keeps its name
            out[prefix + _LEAF.get(name, name)] = _leaf(name, sub)


def variables_from_jax(params: Mapping,
                       batch_stats: Optional[Mapping] = None) -> dict:
    """flax ``params`` (and ``batch_stats``) -> a state_dict for the
    port's model of the same architecture.

    Conv ``kernel`` HWIO becomes ``weight`` OIHW; Dense ``kernel``
    ``[in, out]`` becomes ``weight`` ``[out, in]``; BatchNorm and
    LayerNorm ``scale`` become ``weight``; Embed ``embedding`` becomes
    ``weight``; ``batch_stats`` ``mean`` / ``var`` become
    ``running_mean`` / ``running_var``.  Accepts each tree with or
    without its top-level collection key (``"params"``,
    ``"batch_stats"``).
    """
    out: dict = {}
    _walk(params.get("params", params), "", out)
    if batch_stats:
        _walk(batch_stats.get("batch_stats", batch_stats), "", out)
    return out


def params_from_jax(tree: Mapping) -> dict:
    """flax GPT params -> a state_dict for
    :class:`horovod_tpu_torch.models.transformer.GPT`
    (:func:`variables_from_jax` without batch statistics)."""
    return variables_from_jax(tree)


def tree_from_jax(tree: Mapping) -> dict:
    """A nested tree of the reference's raw weights (numpy leaves) -> the
    same tree of fp32 tensors with the port's names and layouts: the
    per-rank trees of the parallel schedules (``stack_tp_params``,
    ``stack_pp_params``, ``stack_pp_params_circular``,
    ``stack_tp_pp_params``, whose leaves carry leading shard, stage,
    circle and layer dims), a GPT's parameters (MoE blocks' ``router``,
    ``w1``, ... included) or their gradients.

    A ``kernel`` ``[..., in, out]`` becomes ``weight`` ``[..., out, in]``
    (the leading dims kept), ``scale`` and ``embedding`` become
    ``weight``; every other leaf keeps its name and layout.  The port's
    own stacking functions give trees of this form, so the two packages'
    schedules can be fed the same weights and their gradients compared.
    """
    out: dict = {}
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            out[name] = tree_from_jax(sub)
            continue
        t = _tensor(sub)
        if name == "kernel":
            t = t.transpose(-1, -2).contiguous()
        out[_LEAF.get(name, name) if name in ("kernel", "scale",
                                              "embedding") else name] = t
    return out


def jax_leaf_names(tree: Mapping) -> list:
    """The port's parameter name of each leaf of a flax tree, in the
    reference's leaf order (``jax.tree_util``'s flatten order of a tree
    of dicts: keys sorted at every level), so an index into the
    reference's ``BucketLayout`` names the same parameter as the port's
    ``state_dict``.  ``params`` at the top is dropped, as
    :func:`variables_from_jax` drops it."""
    tree = tree.get("params", tree)
    names: list = []

    def walk(sub: Mapping, prefix: str) -> None:
        for key in sorted(sub):
            val = sub[key]
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.")
            else:
                names.append(prefix + _LEAF.get(key, key))

    walk(tree, "")
    return names


def bucket_components(port_layout, port_names, ref_layout,
                      ref_names) -> list:
    """Match the port's gradient buckets to the reference's over the
    same parameters (both ``BucketLayout`` objects; ``*_names`` the parameter
    name of each layout's leaf index, e.g. the port's
    ``named_parameters()`` order and :func:`jax_leaf_names`).  The two
    bucket the parameters in their own leaf orders, so a bucket of one
    need not be a bucket of the other: the result is the connected
    groups of buckets that share parameters, ``[(port bucket indices,
    reference bucket indices)]``, over which per-bucket sums (squared
    grad norms, digests' verdicts) can be compared.  Equal layouts give
    one pair per bucket; one parameter per bucket gives a bijection."""
    port_of = {port_names[i]: b.index for b in port_layout.buckets
               for i in b.leaf_indices}
    ref_of = {ref_names[i]: b.index for b in ref_layout.buckets
              for i in b.leaf_indices}
    if set(port_of) != set(ref_of):
        raise ValueError("the layouts cover different parameters: "
                         f"{sorted(set(port_of) ^ set(ref_of))[:4]}")
    parent: dict = {}

    def find(x):
        while parent.setdefault(x, x) != x:
            x = parent[x]
        return x

    for name in port_of:
        parent[find(("p", port_of[name]))] = find(("r", ref_of[name]))
    groups: dict = {}
    for node in list(parent):
        groups.setdefault(find(node), []).append(node)
    out = []
    for members in groups.values():
        out.append((sorted(i for side, i in members if side == "p"),
                    sorted(i for side, i in members if side == "r")))
    return sorted(out)

