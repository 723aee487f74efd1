"""Gradient compression (counterpart of ``horovod_tpu/ops/compression.py``;
reference: horovod/torch/compression.py).

Cast floating gradients to a narrower wire dtype before the allreduce and
back after.  ``ErrorFeedbackCompressor`` is not ported yet (ROADMAP A2).
"""

from __future__ import annotations

import torch

__all__ = [
    "Compressor",
    "NoneCompressor",
    "BFloat16Compressor",
    "FP16Compressor",
    "Compression",
]


class Compressor:
    """Interface.  ``compress`` keeps the SHAPE and may narrow the dtype;
    ``decompress`` restores the original dtype and never changes the
    shape."""

    @staticmethod
    def compress(tensor):
        """tensor -> ``(wire_tensor, ctx)``; ``ctx`` is what
        ``decompress`` needs (``None`` = nothing to undo)."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Identity."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        del ctx
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point() and tensor.dtype != cls.wire_dtype:
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class BFloat16Compressor(_CastCompressor):
    """Cast floats to bf16 on the wire."""

    wire_dtype = torch.bfloat16


class FP16Compressor(_CastCompressor):
    """Cast floats to fp16 on the wire (the reference's compressor)."""

    wire_dtype = torch.float16


class Compression:
    """Namespace matching ``hvd.Compression``."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BFloat16Compressor
