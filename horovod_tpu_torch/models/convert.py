"""Map the reference model's flax parameter tree onto the port's
``state_dict`` names.

The tree comes in as nested dicts of **numpy** arrays (convert a jax tree
with ``np.asarray`` on each leaf first), so this module needs no JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["params_from_jax"]


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def params_from_jax(tree: Mapping) -> dict:
    """flax GPT params -> a state_dict for
    :class:`horovod_tpu_torch.models.transformer.GPT`.

    Dense ``kernel`` ``[in, out]`` becomes ``weight`` ``[out, in]``;
    LayerNorm ``scale`` becomes ``weight``; Embed ``embedding`` becomes
    ``weight``; ``wpe`` stays as it is.  Accepts the tree with or without
    its top-level ``"params"`` collection.
    """
    if "params" in tree:
        tree = tree["params"]
    out = {}
    for name, sub in tree.items():
        if not isinstance(sub, Mapping):
            out[name] = _tensor(sub)  # a bare parameter (wpe)
            continue
        if "embedding" in sub:
            out[f"{name}.weight"] = _tensor(sub["embedding"])
            continue
        if "kernel" in sub or "scale" in sub:
            leaves = {name: sub}
        else:  # a block: its layers one level down
            leaves = {f"{name}.{layer}": p for layer, p in sub.items()}
        for prefix, p in leaves.items():
            if "kernel" in p:
                out[f"{prefix}.weight"] = _tensor(p["kernel"]).T.contiguous()
            if "scale" in p:
                out[f"{prefix}.weight"] = _tensor(p["scale"])
            if "bias" in p:
                out[f"{prefix}.bias"] = _tensor(p["bias"])
    return out
