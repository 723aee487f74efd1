"""Chrome-tracing timeline for the eager path (a copy of
``horovod_tpu/runtime/timeline.py``; the path rules come from the port's
``obs.pathspec``).

Reference: horovod/common/timeline.cc (311 LoC) — rank 0 writes a Chrome
trace-event JSON; a dedicated writer thread drains a lock-free queue so the
hot loop never blocks on file IO; per-tensor state machine NEGOTIATING ->
TOP_LEVEL -> ACTIVITY (timeline.h:77).

Same design here, with two deliberate departures:

* **Every rank records** (the reference gates on rank 0).  Events are
  stamped ``pid = rank``, each rank writes its own file — the
  ``HVDTPU_TIMELINE`` value is a template (``{rank}``), a directory, or
  a plain path that gets a rank tag inserted (:func:`resolve_path`) —
  and the launcher merges them at job end into one trace with a lane
  per rank (obs/timeline_merge.py).  Negotiation skew across ranks is
  invisible in a rank-0-only trace; it is the whole point of this one.
* **Crash-safe streaming format**: one comma-terminated event per line,
  flushed per drained batch, no required ``]`` terminator (Chrome's
  trace format explicitly allows the unclosed-array form for streaming).
  A rank killed mid-job — the normal case under elastic respawn — leaves
  a trace that still loads; clean shutdown appends a ``trace_complete``
  metadata event plus the terminator so the file is also plain valid
  JSON.

Device-level timing belongs to the device profiler (torch.profiler in
the port) and is deliberately not duplicated — this timeline covers the
host-side negotiation/queue phases the device profiler can't see
(SURVEY.md §5.1).

Enable with HVDTPU_TIMELINE=/path/trace.json (reference: HOROVOD_TIMELINE,
operations.cc:403-411); cycle markers via HVDTPU_TIMELINE_MARK_CYCLES.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Optional

# Activity names mirror reference common.h:31-59.
NEGOTIATE = "NEGOTIATE"
QUEUE = "QUEUE"
EXECUTE = "EXECUTE"
CYCLE = "CYCLE"


def resolve_path(raw: str, rank: int) -> str:
    """Map the ``HVDTPU_TIMELINE`` value to this rank's file — shared
    template/dir/plain-path + epoch-tag rules in obs/pathspec.py, so
    ``--timeline-filename t.json`` yields ``t.rank.<k>.json`` per rank
    (``t.e<E>.rank.<k>.json`` under elastic) and the launcher's merge
    — which globs with the same module — writes the original ``t.json``.
    """
    from ..obs import pathspec  # noqa: PLC0415

    return pathspec.resolve(raw, "trace", rank)


class Timeline:
    """Facade; no-ops unless enabled (so the engine can call it
    unconditionally, as the reference does via Initialized() checks)."""

    def __init__(self, path: Optional[str], rank: int, mark_cycles: bool = False):
        self._enabled = bool(path)
        self._rank = rank
        self._mark_cycles = mark_cycles
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._writer: Optional[threading.Thread] = None
        self._start = time.perf_counter()
        if self._enabled:
            self._path = path
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._writer = threading.Thread(
                target=self._write_loop, name="hvdtpu_timeline", daemon=True
            )
            self._writer.start()

    @property
    def enabled(self) -> bool:
        return self._enabled

    def _ts(self) -> float:
        return (time.perf_counter() - self._start) * 1e6  # us

    def _emit(self, ph: str, name: str, cat: str, tid: str = "ops", **extra):
        if self._enabled:
            self._queue.put(
                {"ph": ph, "name": name, "cat": cat, "pid": self._rank,
                 "tid": tid, "ts": self._ts(), **extra}
            )

    # -- per-tensor state machine (reference timeline.h:77-126) ------------
    def negotiate_start(self, tensor_name: str, op: str):
        self._emit("B", f"{NEGOTIATE}_{op}", "negotiate", tid=tensor_name)

    def negotiate_rank_ready(self, tensor_name: str, rank: int):
        self._emit(
            "i", f"rank_{rank}_ready", "negotiate", tid=tensor_name, s="t"
        )

    def negotiate_end(self, tensor_name: str, op: str):
        self._emit("E", f"{NEGOTIATE}_{op}", "negotiate", tid=tensor_name)

    def start(self, tensor_name: str, op: str):
        self._emit("B", op, "op", tid=tensor_name)

    def activity_start(self, tensor_name: str, activity: str):
        self._emit("B", activity, "activity", tid=tensor_name)

    def activity_end(self, tensor_name: str):
        self._emit("E", "", "activity", tid=tensor_name)

    def end(self, tensor_name: str, op: str):
        self._emit("E", op, "op", tid=tensor_name)

    def mark_cycle(self):
        if self._mark_cycles:
            self._emit("i", "CYCLE_START", "cycle", s="g")

    def counter(self, name: str, values: dict):
        """Chrome-trace counter event ("ph": "C"): a numeric series over
        time — used by straggler attribution to plot arrival skew per
        collective alongside the op lanes."""
        self._emit("C", name, "counter", tid="counters", args=dict(values))

    # -- writer ------------------------------------------------------------
    def _write_loop(self):
        """Streaming-tolerant writer: every event line ends with a comma
        and the batch is flushed, so the on-disk trace is loadable at any
        kill point (obs/timeline_merge.load_events repairs the tail; the
        Chrome trace format accepts the unclosed array as-is)."""
        with open(self._path, "w") as f:
            f.write("[\n")
            while True:
                try:
                    ev = self._queue.get(timeout=0.5)
                except queue.Empty:
                    f.flush()
                    continue
                if ev is None:
                    break
                f.write(json.dumps(ev))
                f.write(",\n")
                # drain whatever else is queued before flushing once
                while True:
                    try:
                        ev = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if ev is None:
                        f.flush()
                        self._terminate(f)
                        return
                    f.write(json.dumps(ev))
                    f.write(",\n")
                f.flush()
            self._terminate(f)

    def _terminate(self, f) -> None:
        # Clean shutdown: the terminator event keeps the trailing comma
        # legal, so a completed trace is ALSO plain valid JSON.
        f.write(json.dumps(
            {"ph": "M", "name": "trace_complete", "pid": self._rank,
             "tid": "meta", "ts": self._ts()}
        ))
        f.write("\n]\n")

    def shutdown(self):
        if self._enabled:
            self._queue.put(None)
            self._writer.join(timeout=5)
            self._enabled = False


def from_env(rank: int) -> Timeline:
    raw = os.environ.get("HVDTPU_TIMELINE")
    return Timeline(
        resolve_path(raw, rank) if raw else None,
        rank,
        mark_cycles=os.environ.get("HVDTPU_TIMELINE_MARK_CYCLES", "0")
        in ("1", "true"),
    )
