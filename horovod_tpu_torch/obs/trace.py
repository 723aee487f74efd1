"""Request-level distributed tracing: Dapper-style causal spans over
the existing observability planes.

The metrics plane answers "how slow is ttft" as one opaque
histogram sample; the flight recorder answers "what died".
Neither answers *where a specific request's time went*.  This module is
the missing causal layer (Sigelman et al. 2010, PAPERS.md): every
serve request's rid doubles as its **trace id**, and each stage of its
life — launcher-side ingest, schedule broadcast, admission, prefill,
per-N-token decode windows, finish, result fetch — is recorded as a
**span** ``(trace, name, t0, dur, epoch, args)`` into a bounded
per-process ring.  Training gets the same treatment at step
granularity: engine cycles emit negotiate/execute spans, the overlap
plane records each bucket's fill (``overlap/bucket{i}``), and the
training step its phases (:class:`phase`, trace ``train.steps``), so
negotiation vs wire vs compute per step lands in the same merged view.

:class:`phase` also opens a ``torch.profiler`` range (``hvd.<name>``)
while a profiler records: the span then sits in the profiler's Chrome
trace on the same clock as the device's kernels and copies, whose
launches it contains.

Design rules, inherited from the planes this rides on:

* **Deterministic sampling** (:func:`sampled`) — the decision is a pure
  function of the trace id (sha1, not ``hash()``: PYTHONHASHSEED must
  not change the sampled set), so every rank and the launcher reach the
  SAME verdict with no coordination.  A rank-divergent span set would
  make trace-merge blame a healthy rank for "missing" spans — the
  replication invariant applies to sampling decisions.
* **Bounded memory** — a fixed-capacity ring per process
  (``HVDTPU_TRACE_CAPACITY``, default 8192 spans), overwrite-counted
  like the flight recorder: a week-long serving job records forever
  without growing.
* **Zero cost when off** — every producer call site gates on
  :func:`enabled` (one env read, cached); unset ``HVDTPU_TRACE`` means
  no ring, no locks, no span dicts.
* **Per-span epoch** — a span records the elastic epoch it happened
  in, not the env at dump time: a survivor rank's single dump carries
  spans from every epoch it lived through, which is how a replayed
  request's waterfall shows both incarnations (and the recovery gap
  between them) explicitly.
* **Death-path flush** — the ring dumps through the shared flush
  (obs/flightrec.py ``on_death``), over the shared pathspec rules
  (stem ``spans``), so a crashed rank's spans survive it exactly like
  its metrics and its black box.

The launcher-side consumer is ``obs/trace_merge.py``: it globs every
rank's span file (the launcher's own, tagged ``launcher``, included),
merges them into a Chrome-trace waterfall with one lane per request,
and derives the latency-decomposition report (ttft/tpot components,
p50/p99 each).

A copy of the reference's ``horovod_tpu/obs/trace.py``.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

from torch.autograd import profiler as _profiler

from ..utils import env as envmod

SCHEMA = "hvdtpu-trace-v1"
DEFAULT_CAPACITY = 8192
MIN_CAPACITY = 64

# Injection point consumed in :func:`flush` — `trace_flush:action=
# trace_drop` suppresses one rank's span dump, the deterministic chaos
# input trace-merge's missing-rank handling is tested against
# (the replica_push/drop_replica pattern).
FAULT_POINT = "trace_flush"

# the trace id of the training step's phases in the ring
TRAIN_TRACE = "train.steps"

__all__ = [
    "SCHEMA",
    "TraceBuffer",
    "enabled",
    "sample_rate",
    "sampled",
    "get_buffer",
    "reset_buffer",
    "add_span",
    "span",
    "phase",
    "TRAIN_TRACE",
    "resolve_dump_path",
    "flush",
]


def enabled() -> bool:
    """True when a span dump target is armed (``HVDTPU_TRACE``).  The
    one gate every producer call site checks before paying for a span."""
    return bool(os.environ.get(envmod.TRACE))


def sample_rate() -> float:
    return envmod.env_float(envmod.TRACE_SAMPLE_RATE, 1.0)


# hvdtpu: deterministic
def sampled(trace_id: str, rate: Optional[float] = None) -> bool:
    """Deterministic sampling verdict for one trace id.

    Pure function of (trace_id, rate): sha1 of the id mapped onto
    [0, 1) and compared to the rate.  Every process holding the same id
    and rate — every serving rank, the launcher's ingest pump, the
    client — derives the identical verdict, so a sampled request's
    spans exist on ALL ranks or NONE, never a rank-divergent subset.
    """
    if rate is None:
        rate = sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = int(hashlib.sha1(trace_id.encode()).hexdigest()[:8], 16)
    return (h / float(0x100000000)) < rate


def _current_epoch() -> int:
    return envmod.env_int("HVDTPU_ELASTIC_EPOCH", 0)


class TraceBuffer:
    """Fixed-capacity ring of span dicts.

    Spans are appended until capacity, then overwritten oldest-first
    (``dropped`` counts the casualties — the dump is honest about what
    the ring forgot).  The lock is REENTRANT for the same reason as
    every other obs-plane lock: the death-path flush may interrupt the
    owning thread mid-:meth:`add` from a signal handler."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = envmod.env_int(
                envmod.TRACE_CAPACITY, DEFAULT_CAPACITY
            )
        self.capacity = max(int(capacity), MIN_CAPACITY)
        self._slots: List[Optional[dict]] = [None] * self.capacity
        self._seq = 0
        self._lock = threading.RLock()

    def add(self, span_doc: dict) -> None:
        with self._lock:
            self._slots[self._seq % self.capacity] = span_doc
            self._seq += 1

    @property
    def recorded(self) -> int:
        return self._seq

    @property
    def dropped(self) -> int:
        return max(0, self._seq - self.capacity)

    def snapshot(self) -> List[dict]:
        """Chronological copy of the surviving window (oldest first)."""
        with self._lock:
            n = min(self._seq, self.capacity)
            start = self._seq % self.capacity if self._seq > self.capacity \
                else 0
            out = []
            for i in range(n):
                slot = self._slots[(start + i) % self.capacity]
                if slot is not None:
                    out.append(slot)
            return out

    def dump(self, path: str, *, rank) -> dict:
        """Write the dump-schema JSON document atomically; returns it."""
        doc = {
            "schema": SCHEMA,
            "rank": rank,
            "pid": os.getpid(),
            "wall_time": time.time(),
            "capacity": self.capacity,
            "recorded": self.recorded,
            "dropped": self.dropped,
            "sample_rate": sample_rate(),
            "spans": self.snapshot(),
        }
        from . import pathspec  # noqa: PLC0415

        pathspec.write_json_atomic(path, doc)
        return doc


# -- process-global buffer ---------------------------------------------------

_buffer: Optional[TraceBuffer] = None
# Reentrant: flush() runs on the fatal-signal death path and the
# interrupted thread may hold this very lock.
_buffer_lock = threading.RLock()
_flush_armed = False


def get_buffer() -> TraceBuffer:
    """The process-global span ring.  First use arms the death-path
    flush (a no-op unless ``HVDTPU_TRACE`` is set at flush time), so a
    crashed rank's spans land next to its flight-recorder ring."""
    global _buffer, _flush_armed
    if _buffer is None:
        with _buffer_lock:
            if _buffer is None:
                _buffer = TraceBuffer()
                if not _flush_armed:
                    from .flightrec import on_death  # noqa: PLC0415

                    on_death(_death_flush)
                    _flush_armed = True
    return _buffer


def reset_buffer() -> None:
    """Drop the global buffer (tests)."""
    global _buffer
    with _buffer_lock:
        _buffer = None


def add_span(trace: str, name: str, t0: float, t1: float,
             epoch: Optional[int] = None, **args) -> None:
    """Record one completed span: ``[t0, t1]`` wall-clock seconds
    (``time.time()`` — spans from different processes on one host align
    without clock negotiation).  ``epoch=None`` stamps the current
    elastic epoch; serving code passes its rendezvous epoch explicitly
    because a survivor's env still names the epoch it was SPAWNED in.
    ``args`` must be JSON-serializable scalars/lists."""
    doc = {
        "trace": trace,
        "name": name,
        "t0": t0,
        "dur": max(t1 - t0, 0.0),
        "epoch": _current_epoch() if epoch is None else int(epoch),
    }
    if args:
        doc["args"] = args
    get_buffer().add(doc)


@contextmanager
def span(trace: str, name: str, epoch: Optional[int] = None, **args):
    """Context-manager form of :func:`add_span` for call sites that
    wrap one straight-line block."""
    t0 = time.time()
    try:
        yield
    finally:
        add_span(trace, name, t0, time.time(), epoch=epoch, **args)


class phase:
    """One phase of a training step, as a context manager: the forward,
    the backward, the gradient reduction, the optimizer's update.

    While a ``torch.profiler`` session records, it opens
    ``record_function("hvd.<name>")``: the span lands in the profiler's
    trace as a ``user_annotation``, on the clock of the device's kernels,
    so each kernel can be joined to the phase whose host time holds its
    launch.  With :func:`enabled`, it records ``add_span("train.steps",
    name, ...)`` into the ring, on the wall clock, with ``args``.  With
    neither, it costs the profiler's flag and :func:`enabled`'s one env
    read: no range is opened and no ring made (``record_function`` costs
    microseconds even with no profiler running)."""

    __slots__ = ("name", "args", "_range", "_t0")

    def __init__(self, name: str, **args):
        self.name = name
        self.args = args
        self._range = None
        self._t0 = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(f"hvd.{self.name}")
            self._range.__enter__()
        if enabled():
            self._t0 = time.time()
        return self

    def __exit__(self, *exc) -> None:
        if self._t0 is not None:
            add_span(TRAIN_TRACE, self.name, self._t0, time.time(),
                     **self.args)
        if self._range is not None:
            self._range.__exit__(*exc)


def _resolve_rank() -> str:
    return envmod.artifact_rank()


def resolve_dump_path(raw: str, rank: Optional[str] = None) -> str:
    """``HVDTPU_TRACE`` value -> this rank's span file, via the shared
    pathspec rules (dir / {rank} template / plain path, epoch tag) —
    the merge CLI globs with the same module, so they cannot drift."""
    from . import pathspec  # noqa: PLC0415

    return pathspec.resolve(
        raw, "spans", _resolve_rank() if rank is None else rank
    )


def flush(path: Optional[str] = None) -> Optional[str]:
    """Dump the global span ring; ``path=None`` resolves from the env.
    Returns the written path, or None when tracing is not armed (or a
    ``trace_flush:action=trace_drop`` chaos fault suppressed this
    flush — the deterministic missing-rank input trace-merge is tested
    against; the suppression itself is black-boxed)."""
    raw = path or os.environ.get(envmod.TRACE)
    if not raw:
        return None
    from ..testing.faults import maybe_fail  # noqa: PLC0415

    if maybe_fail(FAULT_POINT) == "trace_drop":
        return None
    resolved = resolve_dump_path(raw) if path is None else path
    get_buffer().dump(resolved, rank=_resolve_rank())
    return resolved


def _death_flush() -> None:
    try:
        flush()
    except Exception:
        pass  # a span dump must never break the death path
