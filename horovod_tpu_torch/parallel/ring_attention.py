"""Plain softmax attention (counterpart of
``horovod_tpu/parallel/ring_attention.py::local_attention``).

The model's ``attention_impl="reference"`` path and the tests' oracle.
The ring, zigzag and Ulysses schedules are ROADMAP A11.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["local_attention"]


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
