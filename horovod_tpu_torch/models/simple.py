"""Small models for examples and smoke tests (counterpart of
``horovod_tpu/models/simple.py``; the nets of the reference's
examples/*_mnist.py).  fp32; names are flax's auto-names."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, Dense, init_flax_, max_pool

__all__ = ["MLP", "ConvNet"]


class MLP(nn.Module):
    """Flatten, then ``Dense -> ReLU`` per width of ``features``, then the
    classifier.  ``in_features``: the flattened input's width."""

    def __init__(self, in_features: int, features: Sequence[int] = (128, 64),
                 num_classes: int = 10,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        widths = [in_features, *features, num_classes]
        for i in range(len(widths) - 1):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1]))
        self.depth = len(widths) - 1
        init_flax_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.depth):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.depth - 1:
                x = F.relu(x)
        return x


class ConvNet(nn.Module):
    """The two-conv MNIST net: "SAME" 3x3 convs of 32 and 64 channels,
    each with ReLU and a 2x2 max pool, an NHWC flatten, Dense 128, the
    classifier.  Input ``[N, H, W]`` or NCHW with one channel."""

    def __init__(self, num_classes: int = 10, image_size: int = 28,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = Conv2d(1, 32, 3)
        self.Conv_1 = Conv2d(32, 64, 3)
        side = image_size // 4
        self.Dense_0 = Dense(side * side * 64, 128)
        self.Dense_1 = Dense(128, num_classes)
        init_flax_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x):
        if x.dim() == 3:
            x = x[:, None]
        x = max_pool(F.relu(self.Conv_0(x)), 2, 2)
        x = max_pool(F.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # (h, w, c), flax's order
        return self.Dense_1(F.relu(self.Dense_0(x)))
