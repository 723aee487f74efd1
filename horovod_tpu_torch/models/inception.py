"""Inception V3 (counterpart of ``horovod_tpu/models/inception.py``).

Canonical V3 geometry: the stem, 3x InceptionA, the B reduction, 4x
InceptionC, the D reduction, 2x InceptionE, a global mean (in place of
the fixed 8x8 pool, so any input size works; 299 canonical), the
classifier; no aux head.  Every conv is :class:`ConvBN`: conv (no bias)
in the compute dtype, BatchNorm (eps 1e-3, statistics in fp32), ReLU;
"SAME" pads unless a layer says "VALID"; the 3x3 average pools count
their pads.  Input: NCHW images (channels_last); output fp32 logits.

The flax modules are unnamed, so flax names them by class and call order
(``ConvBN_0``, ``InceptionA_0``, ..., ``Dense_0``; inside a ConvBN
``Conv_0`` and ``BatchNorm_0``); the port builds its modules in the same
order under the same names, and
:func:`~horovod_tpu_torch.models.convert.variables_from_jax` maps the
trees one to one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv2d, Dense, avg_pool, init_flax_, max_pool

__all__ = ["ConvBN", "InceptionA", "InceptionB", "InceptionC", "InceptionD",
           "InceptionE", "InceptionV3"]

_BN_EPS = 1e-3


class ConvBN(nn.Module):
    def __init__(self, in_features: int, features: int, kernel, strides=1,
                 padding="SAME", dtype=torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv2d(in_features, features, kernel, strides, padding,
                             use_bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(features, momentum=0.9, eps=_BN_EPS)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class _Named(nn.Module):
    """Children named ``ConvBN_<k>`` in the order they are made; the
    branches hold them in plain lists, so each is registered once."""

    def __init__(self, dtype):
        super().__init__()
        self._dtype, self._k = dtype, 0

    def convbn(self, *args, **kwargs) -> ConvBN:
        mod = ConvBN(*args, dtype=self._dtype, **kwargs)
        self.add_module(f"ConvBN_{self._k}", mod)
        self._k += 1
        return mod


def _pool_avg(x):
    return avg_pool(x, 3, 1, padding="SAME")


class InceptionA(_Named):
    def __init__(self, c_in: int, pool_features: int, dtype=torch.bfloat16):
        super().__init__(dtype)
        self.b1 = [self.convbn(c_in, 64, 1)]
        self.b5 = [self.convbn(c_in, 48, 1), self.convbn(48, 64, 5)]
        self.b3 = [self.convbn(c_in, 64, 1), self.convbn(64, 96, 3),
                   self.convbn(96, 96, 3)]
        self.bp = [self.convbn(c_in, pool_features, 1)]
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b5, x),
                          _chain(self.b3, x),
                          _chain(self.bp, _pool_avg(x))], 1)


class InceptionB(_Named):  # 17x17 reduction
    def __init__(self, c_in: int, dtype=torch.bfloat16):
        super().__init__(dtype)
        self.b3 = [self.convbn(c_in, 384, 3, 2, "VALID")]
        self.bd = [self.convbn(c_in, 64, 1), self.convbn(64, 96, 3),
                   self.convbn(96, 96, 3, 2, "VALID")]
        self.out_features = 384 + 96 + c_in

    def forward(self, x):
        return torch.cat([_chain(self.b3, x), _chain(self.bd, x),
                          max_pool(x, 3, 2)], 1)


class InceptionC(_Named):
    def __init__(self, c_in: int, channels_7x7: int, dtype=torch.bfloat16):
        super().__init__(dtype)
        c7 = channels_7x7
        self.b1 = [self.convbn(c_in, 192, 1)]
        self.b7 = [self.convbn(c_in, c7, 1), self.convbn(c7, c7, (1, 7)),
                   self.convbn(c7, 192, (7, 1))]
        self.bb = [self.convbn(c_in, c7, 1), self.convbn(c7, c7, (7, 1)),
                   self.convbn(c7, c7, (1, 7)), self.convbn(c7, c7, (7, 1)),
                   self.convbn(c7, 192, (1, 7))]
        self.bp = [self.convbn(c_in, 192, 1)]
        self.out_features = 4 * 192

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b7, x),
                          _chain(self.bb, x),
                          _chain(self.bp, _pool_avg(x))], 1)


class InceptionD(_Named):  # 8x8 reduction
    def __init__(self, c_in: int, dtype=torch.bfloat16):
        super().__init__(dtype)
        self.b3 = [self.convbn(c_in, 192, 1),
                   self.convbn(192, 320, 3, 2, "VALID")]
        self.b7 = [self.convbn(c_in, 192, 1), self.convbn(192, 192, (1, 7)),
                   self.convbn(192, 192, (7, 1)),
                   self.convbn(192, 192, 3, 2, "VALID")]
        self.out_features = 320 + 192 + c_in

    def forward(self, x):
        return torch.cat([_chain(self.b3, x), _chain(self.b7, x),
                          max_pool(x, 3, 2)], 1)


class InceptionE(_Named):
    def __init__(self, c_in: int, dtype=torch.bfloat16):
        super().__init__(dtype)
        self.b1 = [self.convbn(c_in, 320, 1)]
        self.b3 = [self.convbn(c_in, 384, 1)]
        self.b3_split = [self.convbn(384, 384, (1, 3)),
                         self.convbn(384, 384, (3, 1))]
        self.bb = [self.convbn(c_in, 448, 1), self.convbn(448, 384, 3)]
        self.bb_split = [self.convbn(384, 384, (1, 3)),
                         self.convbn(384, 384, (3, 1))]
        self.bp = [self.convbn(c_in, 192, 1)]
        self.out_features = 320 + 2 * 384 + 2 * 384 + 192

    def forward(self, x):
        b3 = _chain(self.b3, x)
        bb = _chain(self.bb, x)
        return torch.cat([_chain(self.b1, x)]
                         + [m(b3) for m in self.b3_split]
                         + [m(bb) for m in self.bb_split]
                         + [_chain(self.bp, _pool_avg(x))], 1)


def _chain(mods, x):
    for m in mods:
        x = m(x)
    return x


class InceptionV3(nn.Module):
    """Parameters made on the CPU from ``generator`` (seed 0 when
    omitted)."""

    def __init__(self, num_classes: int = 1000,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = self.compute_dtype = compute_dtype
        self.ConvBN_0 = ConvBN(3, 32, 3, 2, "VALID", dtype=d)
        self.ConvBN_1 = ConvBN(32, 32, 3, padding="VALID", dtype=d)
        self.ConvBN_2 = ConvBN(32, 64, 3, dtype=d)
        self.ConvBN_3 = ConvBN(64, 80, 1, padding="VALID", dtype=d)
        self.ConvBN_4 = ConvBN(80, 192, 3, padding="VALID", dtype=d)
        c = 192
        blocks = [("InceptionA", InceptionA, (32,)),
                  ("InceptionA", InceptionA, (64,)),
                  ("InceptionA", InceptionA, (64,)),
                  ("InceptionB", InceptionB, ()),
                  ("InceptionC", InceptionC, (128,)),
                  ("InceptionC", InceptionC, (160,)),
                  ("InceptionC", InceptionC, (160,)),
                  ("InceptionC", InceptionC, (192,)),
                  ("InceptionD", InceptionD, ()),
                  ("InceptionE", InceptionE, ()),
                  ("InceptionE", InceptionE, ())]
        seen: dict = {}
        self.tower = []
        for kind, cls, args in blocks:
            k = seen[kind] = seen.get(kind, -1) + 1
            mod = cls(c, *args, dtype=d)
            self.add_module(f"{kind}_{k}", mod)
            self.tower.append(mod)
            c = mod.out_features
        self.Dense_0 = Dense(c, num_classes, d)
        init_flax_(self, generator or torch.Generator().manual_seed(0))

    def forward(self, x):
        x = x.to(self.compute_dtype)
        x = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        x = max_pool(x, 3, 2)
        x = self.ConvBN_4(self.ConvBN_3(x))
        x = max_pool(x, 3, 2)
        for mod in self.tower:
            x = mod(x)
        return self.Dense_0(x.mean((2, 3))).float()
