"""The ``flax.linen`` layer semantics the port's models need, where
``torch.nn``'s defaults differ from flax's.

* **Padding.**  :class:`Conv2d` and the pools take flax's ``padding``:
  ``"SAME"``, ``"VALID"`` or explicit ``[(lo, hi), (lo, hi)]`` pairs.
  ``"SAME"`` is XLA's: ``out = ceil(in / stride)`` and the pad it needs
  split with the odd element at the *end* — a 3x3 stride-2 conv on an
  even input pads (0, 1), where torch's ``padding=1`` pads (1, 1) and
  samples a shifted grid.  Symmetric pads go to the op; others are a
  ``F.pad`` first (:func:`avg_pool` always pads itself).
* **Dtypes.**  Parameters are fp32; :class:`Dense` and :class:`Conv2d`
  cast their input and weights to the compute dtype before the product,
  as ``nn.Dense`` / ``nn.Conv(dtype=..., param_dtype=float32)``.
* **BatchNorm.**  :class:`BatchNorm` keeps flax's running statistics,
  ``ra = m * ra + (1 - m) * batch`` with ``m = 0.9`` (torch's
  ``momentum`` is ``1 - m``) and the *biased* batch variance (torch's
  ``F.batch_norm`` feeds the unbiased one); statistics in fp32, output in
  the input's dtype, no ``num_batches_tracked``.
* **Pools.**  :func:`max_pool` defaults to ``"VALID"``; :func:`avg_pool`
  counts the pads (flax's ``count_include_pad=True``).
* **Layout.**  Activations are logical NCHW in ``torch.channels_last``
  memory, NHWC physically as in the JAX package; 4-D weights are made
  channels_last too, so cuDNN's NHWC convolutions need no transposes.
  :func:`from_nhwc` views a numpy NHWC batch that way without a copy.

:func:`init_flax_` gives the flax initializers' variances: conv and Dense
weights N(0, 1/fan_in), biases 0, BatchNorm scale 1 and bias 0.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Conv2d", "Dense", "BatchNorm", "max_pool", "avg_pool",
           "same_pads", "resolve_padding", "from_nhwc", "init_flax_"]

Padding = Union[str, Sequence[Tuple[int, int]]]
Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` pads (lo, hi) of one spatial dim: the output has
    ``ceil(size / stride)`` elements, and an odd total pad puts the extra
    element at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def resolve_padding(padding: Padding, hw, kernel, strides) -> Pads:
    """flax ``padding`` -> ((lo_h, hi_h), (lo_w, hi_w)) on an input of
    spatial size ``hw``."""
    if padding == "SAME":
        return tuple(same_pads(s, k, st)
                     for s, k, st in zip(hw, kernel, strides))
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if isinstance(padding, str):
        raise ValueError(f"padding must be 'SAME', 'VALID' or pairs, got "
                         f"{padding!r}")
    (lh, hh), (lw, hw_) = padding
    return ((lh, hh), (lw, hw_))


def _apply_pads(x, pads: Pads, value: float = 0.0):
    """``(x, torch_padding)``: symmetric pads are left to the op, others
    are applied here (``F.pad`` keeps channels_last)."""
    (lh, hh), (lw, hw) = pads
    if lh == hh and lw == hw:
        return x, (lh, lw)
    return F.pad(x, (lw, hw, lh, hh), value=value), (0, 0)


def from_nhwc(array: np.ndarray) -> torch.Tensor:
    """A numpy NHWC batch as an NCHW tensor in channels_last memory (a
    view of the same buffer)."""
    return torch.from_numpy(array).permute(0, 3, 1, 2)


class Dense(nn.Linear):
    """``flax.linen.Dense(dtype=...)``: input and fp32 weights cast to the
    compute dtype before the product."""

    def __init__(self, d_in, d_out, dtype=torch.float32, bias=True):
        super().__init__(d_in, d_out, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv2d(nn.Module):
    """``flax.linen.Conv`` on NCHW (channels_last) input: fp32 ``weight``
    ``[out, in, kh, kw]`` (channels_last) and ``bias``, flax ``padding``,
    input and weights cast to ``dtype`` before the convolution."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides=1, padding: Padding = "SAME", use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_features, *self.kernel_size).contiguous(
                memory_format=torch.channels_last))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        dt = self.compute_dtype
        pads = resolve_padding(self.padding, x.shape[-2:], self.kernel_size,
                               self.strides)
        x, pad = _apply_pads(x.to(dt), pads)
        b = self.bias.to(dt) if self.bias is not None else None
        return F.conv2d(x, self.weight.to(dt), b, self.strides, pad)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm`` over dim 1: ``weight`` (flax ``scale``)
    and ``bias`` fp32, running statistics ``running_mean`` and
    ``running_var`` updated in training mode as ``m * ra + (1 - m) *
    batch`` with the biased batch variance; eval mode normalises with
    them."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        # the op F.batch_norm calls, once (cuDNN's or PyTorch's native
        # kernels, as PyTorch picks; native for bf16 channels_last on the
        # H100); the biased variance is read back from its saved inverse
        # std, 1 / invstd^2 - eps, so it costs no second pass over x
        y, mean, invstd, _, _ = torch.ops.aten._batch_norm_impl_index(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps,
            torch.backends.cudnn.enabled)
        with torch.no_grad():
            self.update_running(mean, invstd.pow(-2).sub_(self.eps))
        return y

    @torch.no_grad()
    def update_running(self, mean, var) -> None:
        """flax's update, ``ra = m * ra + (1 - m) * batch``."""
        m = self.momentum
        self.running_mean.mul_(m).add_(mean, alpha=1 - m)
        self.running_var.mul_(m).add_(var, alpha=1 - m)


def max_pool(x, window, strides, padding: Padding = "VALID"):
    """``flax.linen.max_pool`` (pads are -inf)."""
    window, strides = _pair(window), _pair(strides)
    x, pad = _apply_pads(x, resolve_padding(padding, x.shape[-2:], window,
                                            strides), value=float("-inf"))
    return F.max_pool2d(x, window, strides, pad)


def avg_pool(x, window, strides, padding: Padding = "VALID"):
    """``flax.linen.avg_pool``: the pads count in the mean.  The zeros are
    padded here, never by the op: on CUDA, ``avg_pool2d``'s backward of a
    channels_last input with ``padding`` > 0 disagrees with its forward
    and with the CPU (92% of the gradient's max off on an H100, torch
    2.11), while the unpadded op agrees."""
    window, strides = _pair(window), _pair(strides)
    (lh, hh), (lw, hw) = resolve_padding(padding, x.shape[-2:], window,
                                         strides)
    if lh or hh or lw or hw:
        x = F.pad(x, (lw, hw, lh, hh))
    return F.avg_pool2d(x, window, strides)


@torch.no_grad()
def init_flax_(module: nn.Module, generator: torch.Generator) -> None:
    """The flax initializers' variances, in module order from
    ``generator``: Conv2d / Dense weights N(0, 1/fan_in) and zero biases;
    BatchNorm scale 1, bias 0, running mean 0 and variance 1."""
    for mod in module.modules():
        if isinstance(mod, (Conv2d, Dense)):
            fan_in = mod.weight[0].numel()
            mod.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
