"""What the per-layer readers share (each metric's reader is a file of
its own under ``metrics/``, which calls one of these).  A reader that
finds nothing to read returns None: the metric is then left out."""

from __future__ import annotations

import statistics

from .flops import PEAK_BF16_FLOPS
from .session import percentile
from .trace import total


def kernels(ctx) -> list:
    """The traced device ops the reader's data file names (substrings of
    the kernel names, under ``"kernels"``)."""
    if ctx.profile is None or not ctx.data:
        return []
    return ctx.profile.matching(ctx.data["kernels"])


def mfu_pct(ctx):
    """The whole step's model FLOPs over the window's seconds, as a share
    of the card's dense bf16 peak (%), from the traced run's unprofiled
    window."""
    w = ctx.window
    if not w.step_s or w.seconds <= 0:
        return None
    flops = ctx.family.step_flops(ctx.config, ctx.traffic) * len(w.step_s)
    return 100.0 * flops / w.seconds / PEAK_BF16_FLOPS


def host_issue_ms(ctx):
    """The median over the window's steps of the host's time from the
    step's call to its return, before the loss is read (ms)."""
    return statistics.median(ctx.window.issue_s) * 1e3 if ctx.window.issue_s \
        else None


def step_ms_p95(ctx):
    """The 95th percentile of the window's step times, the call to the
    host holding its loss (ms)."""
    return percentile(ctx.window.step_s, 95) * 1e3 if ctx.window.step_s \
        else None


def device_ms(ctx):
    """Device ms a traced step of the named kernels (their union)."""
    ops = kernels(ctx)
    if not ops:
        return None
    return total((s, e) for _, s, e, _ in ops) / 1e3 / ctx.profile.steps


def idle_pct(ctx):
    """The share of the traced window in which no device op runs (%)."""
    p = ctx.profile
    if p is None or p.window_us <= 0:
        return None
    return 100.0 * (1.0 - p.busy_us() / p.window_us)
