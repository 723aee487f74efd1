"""VGG (counterpart of ``horovod_tpu/models/vgg.py``).

Configurations D (VGG-16) and E (VGG-19): "SAME" 3x3 convs with bias and
ReLU, 2x2 stride-2 "VALID" max pools, three Dense layers in the compute
dtype on fp32 parameters, fp32 logits.  No BatchNorm.  The classifier
flattens in NHWC order (h, w, c), as flax does, so the first Dense's rows
line up with the JAX model's; its width follows ``image_size`` (25088 at
224).  Names are flax's auto-names (``Conv_0`` .. ``Conv_12``,
``Dense_0`` .. ``Dense_2``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, Dense, init_flax_, max_pool

__all__ = ["VGG", "VGG16", "VGG19"]

# 'M' = 2x2 max pool
_VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M")
_VGG19 = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


class VGG(nn.Module):
    """Input: NCHW images (channels_last) of ``image_size``; parameters
    made on the CPU from ``generator`` (seed 0 when omitted)."""

    def __init__(self, cfg: Sequence = _VGG16, num_classes: int = 1000,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 image_size: int = 224,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = tuple(cfg)
        self.compute_dtype = compute_dtype
        width, side, k = 3, image_size, 0
        for spec in self.cfg:
            if spec == "M":
                side //= 2
                continue
            self.add_module(f"Conv_{k}", Conv2d(width, spec, 3,
                                                dtype=compute_dtype))
            width, k = spec, k + 1
        self.Dense_0 = Dense(side * side * width, 4096, compute_dtype)
        self.Dense_1 = Dense(4096, 4096, compute_dtype)
        self.Dense_2 = Dense(4096, num_classes, compute_dtype)
        init_flax_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x):
        x = x.to(self.compute_dtype)
        k = 0
        for spec in self.cfg:
            if spec == "M":
                x = max_pool(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"Conv_{k}")(x))
                k += 1
        x = x.permute(0, 2, 3, 1).flatten(1)  # (h, w, c), flax's order
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x).float()


def VGG16(num_classes: int = 1000, compute_dtype=torch.bfloat16,
          image_size: int = 224, **kwargs) -> VGG:
    return VGG(_VGG16, num_classes, compute_dtype, image_size, **kwargs)


def VGG19(num_classes: int = 1000, compute_dtype=torch.bfloat16,
          image_size: int = 224, **kwargs) -> VGG:
    return VGG(_VGG19, num_classes, compute_dtype, image_size, **kwargs)
