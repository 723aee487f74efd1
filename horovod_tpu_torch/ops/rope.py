"""Rotary position embedding (RoPE) (counterpart of
``horovod_tpu/ops/rope.py``).

Positions are an explicit int vector (one position per row), so the
rotation only ever looks at each token's position value.  Angles are
computed in fp32 whatever the activation dtype, and the rotated output is
cast back to it.
"""

from __future__ import annotations

import torch

__all__ = ["rope_tables", "apply_rope_tables", "apply_rope"]


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0):
    """``(cos, sin)``, each fp32 ``[seq, head_dim // 2]``, for
    :func:`apply_rope_tables`.  They depend on the positions and theta
    only, so a model computes them once per forward and hands them to
    every block (under remat a block's recompute then does not redo the
    transcendentals).  An odd ``head_dim`` raises ``ValueError``."""
    if head_dim % 2:
        raise ValueError(f"RoPE requires an even head_dim, got {head_dim}")
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope_tables(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` ``[batch, seq, heads, head_dim]`` by tables from
    :func:`rope_tables`: the first half of each head against the second,
    in fp32, cast back to ``x``'s dtype."""
    half = x.shape[-1] // 2
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x`` by the angles of ``positions`` (int ``[seq]``) in one
    call."""
    cos, sin = rope_tables(positions, x.shape[-1], theta)
    return apply_rope_tables(x, cos, sin)
