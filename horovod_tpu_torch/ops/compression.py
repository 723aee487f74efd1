"""Gradient compression (counterpart of ``horovod_tpu/ops/compression.py``;
reference: horovod/torch/compression.py).

Cast floating gradients to a narrower wire dtype before the allreduce and
back after.  :class:`ErrorFeedbackCompressor` carries each stream's
quantization residual into its next compression.
"""

from __future__ import annotations

import torch

__all__ = [
    "Compressor",
    "NoneCompressor",
    "BFloat16Compressor",
    "FP16Compressor",
    "ErrorFeedbackCompressor",
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


class ErrorFeedbackCompressor(Compressor):
    """Residual-carrying (error-feedback) compressor.

    A cast compressor throws its quantization error away on every call;
    this one keeps the residual ``x - dec(enc(x))`` per tensor ``key``
    (in the tensor's own dtype) and adds it back before the next
    compression of that key, so the error is carried, not compounded.
    Stateful: one instance per job, an explicit ``key`` per tensor stream
    (the default is only safe for a single stream).  A shape change
    resets that key's residual.  Not a member of :class:`Compression`,
    which holds stateless classes only.
    """

    def __init__(self, inner=BFloat16Compressor):
        self._inner = inner
        self._residuals: dict = {}

    def compress(self, tensor, *, key: str = "default"):
        prev = self._residuals.get(key)
        if prev is not None and prev.shape == tensor.shape:
            tensor = tensor + prev.to(tensor.dtype)
        wire, ctx = self._inner.compress(tensor)
        # what the wire failed to carry, in the original dtype
        restored = self._inner.decompress(wire, ctx)
        self._residuals[key] = tensor - restored.to(tensor.dtype)
        return wire, ctx

    def decompress(self, tensor, ctx):
        return self._inner.decompress(tensor, ctx)

    def reset(self) -> None:
        """Drop every residual (a new stream, or a re-formed world)."""
        self._residuals.clear()


class Compression:
    """Namespace matching ``hvd.Compression``."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BFloat16Compressor
