"""The serving MFU accountant's interface (counterpart of
``horovod_tpu/obs/profile.py::MFUProfiler``).

The reference publishes live ``perf.*`` gauges from each measured decode
step.  Those gauges are the observability planes, ROADMAP A13: until that
ports them this profiler records nothing, and its summary says so.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["MFUProfiler"]


class MFUProfiler:
    """The reference's constructor and methods; records nothing (A13)."""

    def __init__(self, flops_per_step: Optional[float], device_kind: str,
                 dtype: str = "bf16", *, source: str = "cost_analysis",
                 registry=None):
        self.flops_per_step = flops_per_step
        self.device_kind = device_kind
        self.source = source

    def observe(self, step_secs: float) -> None:
        return None

    def summary(self) -> dict:
        return {"flops_per_step": self.flops_per_step,
                "flops_source": self.source, "device": self.device_kind,
                "recorded": False}
