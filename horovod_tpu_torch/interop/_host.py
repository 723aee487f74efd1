"""Host-tensor plumbing of the TF, Keras and MXNet frontends: their
tensors live on the host, so each collective takes a numpy array to a CPU
torch tensor for the eager engine and brings the result back in the
array's own dtype (bf16 included, by a 16-bit view: numpy's bf16 is
ml_dtypes', which torch cannot read directly)."""

from __future__ import annotations

import numpy as np
import torch

from .. import basics


def init(comm=None, device="cpu"):
    """``horovod_tpu_torch.init`` for a host framework: the world opens on
    the CPU (gloo), where its tensors are, unless ``device`` says
    otherwise."""
    return basics.init(comm, device=device)


def to_torch(a) -> torch.Tensor:
    """A CPU torch tensor holding a copy of ``a`` (0-d stays 0-d)."""
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_torch(t: torch.Tensor, dtype) -> np.ndarray:
    """``t`` as a numpy array of ``dtype`` (the dtype the value left as)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(dtype)
    return t.numpy().astype(dtype, copy=False)
