"""Live MFU profiler: model FLOPs over measured step time (counterpart of
``horovod_tpu/obs/profile.py``).

* **Device peak FLOP/s** — :data:`PEAK_FLOPS`, keyed by a substring of
  the CUDA device name (``torch.cuda.get_device_name``) and the compute
  dtype: the one table of the port (``bench`` imports it).  The
  reference's TPU table has no counterpart here.  A CPU or an unknown
  card has no peak: :func:`peak_flops` answers None, and the profiler
  falls back to :data:`CPU_PEAK_ESTIMATE` with ``perf.mfu_estimate``
  raised, as the reference does, so a CPU MFU is never a claim.
* **Model FLOPs per step** — :func:`transformer_step_flops` (the 6N +
  12·L·s·d rule) and :func:`analytic_step_flops` (keyed off the bench's
  model names), the reference's.  PyTorch has no compiled cost analysis:
  :func:`flops_from_compiled` reads any object whose ``cost_analysis()``
  answers in XLA's shape and None otherwise.
* **Live gauges** — :class:`MFUProfiler` divides FLOPs by measured step
  time and publishes ``perf.mfu``, ``perf.model_tflops``,
  ``perf.step_ms`` and ``perf.mfu_estimate``.

No torch import at module scope.
"""

from __future__ import annotations

from typing import Optional

__all__ = [
    "PEAK_FLOPS",
    "CPU_PEAK_ESTIMATE",
    "peak_flops",
    "flops_from_compiled",
    "transformer_step_flops",
    "analytic_step_flops",
    "MFUProfiler",
]

# Dense peak FLOP/s by device-name substring and compute dtype: NVIDIA's
# H100 SXM data sheet (bf16 tensor cores; fp32 outside them).  fp32 runs
# there only with TF32 off: PyTorch's default is off for matmuls but ON
# for cuDNN convolutions, so ``train.build_step`` turns it off for fp32.
# fp8 computes in bf16 (e4m3 is only the activations' storage).
PEAK_FLOPS = {"H100": {"bf16": 989e12, "fp32": 67e12, "fp8": 989e12}}

# Order-of-magnitude stand-in for a few CPU cores: keeps the MFU gauges
# exercised on the CPU, never a claim (``perf.mfu_estimate`` is 1).
CPU_PEAK_ESTIMATE = 1e11


def peak_flops(device_name: str, dtype: str = "bf16") -> Optional[float]:
    """The dense peak for ``dtype`` on the named device, or None."""
    for key, peaks in PEAK_FLOPS.items():
        if key in device_name:
            return peaks.get(dtype)
    return None


def flops_from_compiled(compiled) -> Optional[float]:
    """FLOPs of one execution from ``compiled.cost_analysis()`` (XLA's
    shape: a dict, or a one-element list of one); None where the object
    exposes none, which is every PyTorch callable."""
    try:
        ca = compiled.cost_analysis()
    except Exception:
        return None
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    try:
        v = float(ca.get("flops", 0.0))
    except (AttributeError, TypeError, ValueError):
        return None
    return v if v > 0 else None


# -- analytic counts ---------------------------------------------------------

def _transformer_param_count(cfg) -> int:
    """Parameter count of the reference's GPT for a config (wte + learned
    wpe + per-block qkv/proj/mlp/2LN + final LN + untied head)."""
    d = cfg.emb_dim
    kv_dim = cfg.kv_heads * cfg.head_dim
    mlp_hidden = cfg.mlp_ratio * d
    per_block = (
        d * (d + 2 * kv_dim) + (d + 2 * kv_dim)   # qkv (+bias)
        + d * d + d                                # proj
        + d * mlp_hidden + mlp_hidden              # mlp up
        + mlp_hidden * d + d                       # mlp down
        + 4 * d                                    # 2 x LayerNorm
    )
    n = cfg.vocab_size * d + cfg.num_layers * per_block
    n += 2 * d                                     # final LayerNorm
    n += d * cfg.vocab_size                        # untied head
    if cfg.pos_embedding == "learned":
        n += cfg.max_len * d
    return n


def transformer_step_flops(cfg, batch_size: int, seq_len: int,
                           training: bool = True) -> float:
    """Model FLOPs of one step over ``batch_size`` sequences of
    ``seq_len`` tokens: 6N per token (2N forward, 4N backward) plus the
    attention term 12·L·s·d per token; ``training=False`` gives the
    forward-only 2N + 4·L·s·d."""
    n = _transformer_param_count(cfg)
    tokens = batch_size * seq_len
    per_tok_mat = (6 if training else 2) * n
    per_tok_attn = (12 if training else 4) * cfg.num_layers * seq_len \
        * cfg.emb_dim
    return float(tokens) * (per_tok_mat + per_tok_attn)


# Forward FLOPs per image at 224x224 (published per-model numbers,
# 2 x MACs); training approximated as 3 x forward.
_CONV_FWD_FLOPS_224 = {
    "resnet18": 3.6e9,
    "resnet50": 8.2e9,
    "resnet101": 15.2e9,
    "vgg16": 31.0e9,
    "vgg19": 39.0e9,
    "inception3": 11.4e9,
}


def analytic_step_flops(model_name: str, batch_size: int,
                        seq_len: Optional[int] = None,
                        image_size: int = 224) -> Optional[float]:
    """Training FLOPs of one step for a bench model name; None for a
    model the tables do not know."""
    if model_name.startswith("gpt-"):
        from ..models.transformer import GPT_CONFIGS  # noqa: PLC0415

        cfg = GPT_CONFIGS.get(model_name[len("gpt-"):])
        if cfg is None or not seq_len:
            return None
        return transformer_step_flops(cfg, batch_size, seq_len)
    fwd = _CONV_FWD_FLOPS_224.get(model_name)
    if fwd is None:
        return None
    scale = (image_size / 224.0) ** 2
    return 3.0 * fwd * scale * batch_size


class MFUProfiler:
    """Publishes the live perf gauges for one measured step loop.
    ``flops_per_step`` is per device; ``observe(step_secs)`` costs three
    divisions and three gauge stores."""

    def __init__(self, flops_per_step: Optional[float],
                 device_kind: str, dtype: str = "bf16", *,
                 source: str = "analytic", registry=None):
        from .registry import get_registry  # noqa: PLC0415

        self.flops_per_step = flops_per_step
        self.device_kind = device_kind
        peak = peak_flops(device_kind, dtype)
        # no peak for the device: the CPU stand-in, flagged as a guess
        self.estimate = peak is None
        self.peak = CPU_PEAK_ESTIMATE if peak is None else peak
        self.source = source
        self.mfu: Optional[float] = None
        self.step_ms: Optional[float] = None
        reg = registry if registry is not None else get_registry()
        self._g_mfu = reg.gauge("perf.mfu")
        self._g_tflops = reg.gauge("perf.model_tflops")
        self._g_step_ms = reg.gauge("perf.step_ms")
        self._g_estimate = reg.gauge("perf.mfu_estimate")
        self._g_estimate.set(1.0 if self.estimate else 0.0)

    def observe(self, step_secs: float) -> Optional[float]:
        """One measured step (or a timed window's mean): update the
        gauges, return the MFU (None when FLOPs are unknown)."""
        if step_secs <= 0:
            return self.mfu
        self.step_ms = step_secs * 1e3
        self._g_step_ms.set(self.step_ms)
        if not self.flops_per_step:
            return None
        achieved = self.flops_per_step / step_secs
        self.mfu = achieved / self.peak
        self._g_mfu.set(self.mfu)
        self._g_tflops.set(achieved / 1e12)
        return self.mfu

    def summary(self) -> dict:
        """The record-embeddable view."""
        return {
            "mfu": round(self.mfu, 4) if self.mfu is not None else None,
            "model_tflops": (
                round(self.flops_per_step / (self.step_ms / 1e3) / 1e12, 4)
                if self.flops_per_step and self.step_ms else None
            ),
            "step_ms": (round(self.step_ms, 3)
                        if self.step_ms is not None else None),
            "flops_per_step": self.flops_per_step,
            "flops_source": self.source,
            "device": self.device_kind,
            "peak_flops": self.peak,
            "estimate": bool(self.estimate),
        }
