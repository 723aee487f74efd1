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

__all__ = ["params_from_jax", "variables_from_jax"]

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
