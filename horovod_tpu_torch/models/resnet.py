"""ResNet v1.5 family (counterpart of ``horovod_tpu/models/resnet.py``).

The headline model of Horovod's benchmarks.  v1.5 puts the stride in the
3x3 conv; the last BatchNorm scale of each block starts at zero (an
identity residual at init).  Convolutions and BatchNorm run in
``compute_dtype`` on fp32 parameters, BN statistics in fp32, and the head
is an fp32 Dense on fp32 features (:mod:`.layers` holds the flax
semantics, e.g. the asymmetric ``"SAME"`` pads of the stride-2 3x3
convs).  Input: NCHW images in channels_last memory
(:func:`.layers.from_nhwc`); output fp32 logits.

Module names are flax's (``conv_init``, ``bn_init``,
``stage{i}_block{j}`` with ``conv1..3``, ``bn1..3``, ``proj_conv``,
``proj_bn``, ``head``), so
:func:`horovod_tpu_torch.models.convert.variables_from_jax` maps one
tree onto the other by renaming.  ``axis_name`` (any value) replaces
BatchNorm by the world's :class:`~horovod_tpu_torch.parallel.
sync_batch_norm.SyncBatchNorm`; training mode is the module's
``train()`` / ``eval()``.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv2d, Dense, init_flax_, max_pool

__all__ = ["BottleneckBlock", "BasicBlock", "space_to_depth", "ResNet",
           "ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152"]


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1, with a projection shortcut where the
    shape changes (v1.5)."""

    expansion = 4
    zero_init = "bn3"  # the BatchNorm whose scale starts at 0

    def __init__(self, in_features: int, features: int, strides: int,
                 conv, norm):
        super().__init__()
        out = features * self.expansion
        self.conv1 = conv(in_features, features, 1, use_bias=False)
        self.bn1 = norm(features)
        self.conv2 = conv(features, features, 3, strides, use_bias=False)
        self.bn2 = norm(features)
        self.conv3 = conv(features, out, 1, use_bias=False)
        self.bn3 = norm(out)
        self.project = in_features != out or strides != 1
        if self.project:
            self.proj_conv = conv(in_features, out, 1, strides,
                                  use_bias=False)
            self.proj_bn = norm(out)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.project:
            x = self.proj_bn(self.proj_conv(x))
        return F.relu(x + y)


class BasicBlock(nn.Module):
    """3x3(stride) -> 3x3 (ResNet-18/34)."""

    expansion = 1
    zero_init = "bn2"

    def __init__(self, in_features: int, features: int, strides: int,
                 conv, norm):
        super().__init__()
        self.conv1 = conv(in_features, features, 3, strides, use_bias=False)
        self.bn1 = norm(features)
        self.conv2 = conv(features, features, 3, use_bias=False)
        self.bn2 = norm(features)
        self.project = in_features != features or strides != 1
        if self.project:
            self.proj_conv = conv(in_features, features, 1, strides,
                                  use_bias=False)
            self.proj_bn = norm(features)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.project:
            x = self.proj_bn(self.proj_conv(x))
        return F.relu(x + y)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """The JAX package's NHWC space-to-depth on an NCHW (channels_last)
    tensor: (N, C, H, W) -> (N, C*b*b, H/b, W/b), channel
    ``(i * b + j) * C + c`` holding pixel (b*h + i, b*w + j) of channel
    ``c``."""
    n, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1).reshape(n, h // block, block, w // block,
                                      block, c)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, h // block, w // block,
                                            c * block * block)
    return y.permute(0, 3, 1, 2)


class ResNet(nn.Module):
    """Configurable ResNet (``stage_sizes`` and ``block`` select
    18/34/50/101/152).  ``s2d_stem``: the space-to-depth stem (a 4x4
    stride-1 conv over 12 channels in place of the 7x7 stride-2 one).
    Parameters are made on the CPU from ``generator`` (seed 0 when
    omitted); move the module with ``.to()``."""

    def __init__(self, stage_sizes: Sequence[int], block=BottleneckBlock,
                 num_classes: int = 1000, num_filters: int = 64,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 axis_name: Optional[str] = None, s2d_stem: bool = False,
                 act_store_dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if act_store_dtype is not None:
            raise NotImplementedError(
                "act_store_dtype (fp8 activation storage) is not ported yet "
                "(ROADMAP A4)")
        self.compute_dtype = compute_dtype
        self.s2d_stem = s2d_stem
        conv = partial(Conv2d, dtype=compute_dtype)
        if axis_name is not None:
            from ..parallel.sync_batch_norm import (  # noqa: PLC0415
                SyncBatchNorm,
            )

            norm = partial(SyncBatchNorm, momentum=0.9)
        else:
            norm = partial(BatchNorm, momentum=0.9)
        if s2d_stem:
            self.conv_init = conv(12, num_filters, 4, 1,
                                  padding=[(1, 2), (1, 2)], use_bias=False)
        else:
            self.conv_init = conv(3, num_filters, 7, 2,
                                  padding=[(3, 3), (3, 3)], use_bias=False)
        self.bn_init = norm(num_filters)
        width = num_filters
        for i, count in enumerate(stage_sizes):
            features = num_filters * 2 ** i
            for j in range(count):
                strides = 2 if i > 0 and j == 0 else 1
                self.add_module(f"stage{i + 1}_block{j + 1}",
                                block(width, features, strides, conv, norm))
                width = features * block.expansion
        self.head = Dense(width, num_classes, torch.float32)
        self._init_params(generator or torch.Generator().manual_seed(0))

    @torch.no_grad()
    def _init_params(self, g: torch.Generator) -> None:
        init_flax_(self, g)
        for mod in self.modules():
            if isinstance(mod, (BottleneckBlock, BasicBlock)):
                getattr(mod, mod.zero_init).weight.zero_()

    def forward(self, x):
        x = x.to(self.compute_dtype)
        if self.s2d_stem:
            x = space_to_depth(x, 2)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = max_pool(x, 3, 2, padding=[(1, 1), (1, 1)])
        for name, mod in self.named_children():
            if name.startswith("stage"):
                x = mod(x)
        return self.head(x.mean((2, 3)).float())


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3],
                    block=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3],
                    block=BottleneckBlock)
