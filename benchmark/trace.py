"""The traced steps: ``torch.profiler`` (CUPTI) around a few steady
steps, read back from its Chrome trace into device intervals and the
harness's host spans, and the interval arithmetic the per-layer readers
share.  Times are microseconds on the trace's clock."""

from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("bench.step", "bench.issue", "bench.loss_read")
NAME_CHARS = 160


def merged(intervals) -> list:
    """The union of ``(start, end)`` intervals as sorted, disjoint ones."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def total(intervals) -> float:
    return sum(e - s for s, e in merged(intervals))


class Profile:
    """The device activity and host spans of ``steps`` traced steps
    (the first traced step is left out of the window: the profiler
    starts inside it)."""

    def __init__(self, events: list, steps: int):
        spans = {n: [] for n in SPANS}
        self.ops: list = []  # (name, start, end, stream)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                ts = float(e["ts"])
                self.ops.append((e.get("name", ""), ts, ts + float(e["dur"]),
                                 (e.get("args") or {}).get("stream")))
            elif cat == "user_annotation" and e.get("name") in spans:
                ts = float(e["ts"])
                spans[e["name"]].append((ts, ts + float(e["dur"])))
        self.spans = {n: sorted(v) for n, v in spans.items()}
        steps_seen = self.spans["bench.step"]
        if len(steps_seen) < 2:
            raise RuntimeError(f"the trace holds {len(steps_seen)} step "
                               f"spans; no window to read")
        self.start, self.end = steps_seen[1][0], steps_seen[-1][1]
        self.steps = len(steps_seen) - 1
        self.ops = [(n, max(s, self.start), min(e, self.end), st)
                    for n, s, e, st in self.ops
                    if e > self.start and s < self.end]

    @property
    def window_us(self) -> float:
        return self.end - self.start

    def busy_us(self) -> float:
        return total((s, e) for _, s, e, _ in self.ops)

    def matching(self, patterns) -> list:
        """The device ops whose name holds any of ``patterns``."""
        return [op for op in self.ops if any(p in op[0] for p in patterns)]

    def idle_gaps(self) -> list:
        """``(label, us)`` of every stretch of the window in which no
        device op runs, labelled by the harness's host span open at its
        middle (``bench.issue``, ``bench.loss_read``, else
        ``between_steps``)."""
        busy = merged((s, e) for _, s, e, _ in self.ops)
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        out = []
        for s, e in zip(edges[::2], edges[1::2]):
            if e > s:
                mid = (s + e) / 2
                label = next((n for n in ("bench.issue", "bench.loss_read")
                              if any(a <= mid < b for a, b in self.spans[n])),
                             "between_steps")
                out.append((label, e - s))
        return out

    def breakdown(self) -> dict:
        """The ten device ops that took most time in the window (summed by
        name) and the ten longest idle gaps, in seconds."""
        by_name: dict = {}
        for n, s, e, _ in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_gaps(), key=lambda g: -g[1])[:10]
        return {"device_ops": [[n[:NAME_CHARS], us / 1e6] for n, us in top],
                "idle_gaps": [[n, us / 1e6] for n, us in gaps]}


def profile_steps(run_step, steps: int, sync) -> Profile:
    """Trace ``steps`` calls of ``run_step(span)`` under ``torch.profiler``
    (CPU and CUDA activity); ``run_step`` opens the harness's spans with
    ``span(name)``.  The Chrome trace goes to a temporary file under
    ``TMPDIR`` and is deleted once read."""
    from torch.profiler import (  # noqa: PLC0415
        ProfilerActivity, profile, record_function)

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run_step(record_function)
        sync()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Profile(events, steps)
