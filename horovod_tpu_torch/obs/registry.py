"""Tagged metrics registry: the quantitative side of the observability
plane.

The reference ships three debugging pillars — the Chrome-trace timeline
(timeline.cc), the stall inspector (stall_inspector.cc) and
HOROVOD_LOG_LEVEL — but nothing *quantitative* survives a job: cycle
times, fusion efficiency and cache hit rates die with the process.  This
registry is the container for those numbers: Counter / Gauge / Histogram
instruments keyed by (name, tags), cheap enough to update from the
engine's cycle loop, dumped as one JSON document per rank at process
exit when ``HVDTPU_METRICS_DUMP`` is set (the launcher aggregates the
per-rank dumps into the ``--stats-summary`` table, obs/summary.py).

Thread model: instruments are updated from the single-producer engine
thread (plus occasional updates from checkpoint/elastic call sites).
Updates are plain int/float mutations — atomic enough under the GIL and
deliberately lock-free so a 100 Hz cycle loop pays nanoseconds, not a
mutex, per sample.  ``snapshot()`` may observe a value mid-train; that
is fine for monitoring data.

A copy of the reference's ``horovod_tpu/obs/registry.py``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

METRICS_DUMP_ENV = "HVDTPU_METRICS_DUMP"

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "CollectorRetired",
    "get_registry",
    "reset_registry",
    "dump_metrics",
    "resolve_dump_path",
    "METRICS_DUMP_ENV",
]


class CollectorRetired(Exception):
    """Raised by a collector whose owner is gone; the registry prunes it
    (other exceptions are swallowed but the collector is kept)."""


# Geometric bucket bounds shared by every histogram (prometheus-style
# 1/2.5/5 per decade, µs-to-hours span): fixed and global so per-rank
# dumps aggregate without bound negotiation.
_BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    m * (10.0 ** e) for e in range(-3, 8) for m in (1.0, 2.5, 5.0)
)


class _Instrument:
    kind = "instrument"

    def __init__(self, name: str, tags: Dict[str, str]):
        self.name = name
        self.tags = dict(tags)

    def as_dict(self) -> dict:
        raise NotImplementedError


class Counter(_Instrument):
    """Monotonic count (events, bytes, errors)."""

    kind = "counter"

    def __init__(self, name: str, tags: Dict[str, str]):
        super().__init__(name, tags)
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def as_dict(self) -> dict:
        return {"name": self.name, "type": self.kind, "tags": self.tags,
                "value": self.value}


class Gauge(_Instrument):
    """Last-written value (queue depth, current fusion threshold)."""

    kind = "gauge"

    def __init__(self, name: str, tags: Dict[str, str]):
        super().__init__(name, tags)
        self.value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def as_dict(self) -> dict:
        return {"name": self.name, "type": self.kind, "tags": self.tags,
                "value": self.value}


class Histogram(_Instrument):
    """Streaming distribution: exact count/sum/min/max plus fixed
    geometric buckets for approximate quantiles.  O(1) memory per
    instrument regardless of sample count — safe on the cycle loop."""

    kind = "histogram"

    def __init__(self, name: str, tags: Dict[str, str]):
        super().__init__(name, tags)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._buckets = [0] * (len(_BUCKET_BOUNDS) + 1)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        # manual bisect over the fixed bounds (no per-call allocation)
        lo, hi = 0, len(_BUCKET_BOUNDS)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= _BUCKET_BOUNDS[mid]:
                hi = mid
            else:
                lo = mid + 1
        self._buckets[lo] += 1

    def quantile(self, q: float) -> Optional[float]:
        """Approximate q-quantile: the upper bound of the bucket holding
        the q-th sample (min/max clamp the ends)."""
        if self.count == 0:
            return None
        target = q * self.count
        seen = 0
        for i, c in enumerate(self._buckets):
            seen += c
            if seen >= target:
                if i >= len(_BUCKET_BOUNDS):
                    return self.max
                bound = _BUCKET_BOUNDS[i]
                return min(bound, self.max) if self.max is not None else bound
        return self.max

    def as_dict(self) -> dict:
        mean = (self.sum / self.count) if self.count else None
        return {
            "name": self.name, "type": self.kind, "tags": self.tags,
            "count": self.count, "sum": self.sum,
            "min": self.min, "max": self.max, "mean": mean,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }


def _key(name: str, tags: Dict[str, str]) -> Tuple:
    return (name, tuple(sorted(tags.items())))


class MetricsRegistry:
    """Process-local instrument store.  Instrument creation takes a lock
    (rare); updates on the returned instrument objects are lock-free."""

    def __init__(self):
        # REENTRANT: snapshot()/instrument creation run on the signal
        # death path (the registry dump is an on_death callback, and the
        # live stream's final delta snapshots from inside the fatal-
        # signal flush).  A signal landing while the owning thread is
        # mid-_get would self-deadlock on a plain Lock — the same shape
        # as a SIGTERM landing inside a SIGUSR1 flush.
        self._lock = threading.RLock()
        self._instruments: Dict[Tuple, _Instrument] = {}
        self._collectors: List[Callable[["MetricsRegistry"], None]] = []

    def _get(self, cls, name: str, tags: Dict[str, str]):
        key = _key(name, tags)
        inst = self._instruments.get(key)
        if inst is None:
            with self._lock:
                inst = self._instruments.get(key)
                if inst is None:
                    inst = cls(name, tags)
                    self._instruments[key] = inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as {inst.kind}, "
                f"requested {cls.kind}"
            )
        return inst

    def counter(self, name: str, **tags: str) -> Counter:
        return self._get(Counter, name, tags)

    def gauge(self, name: str, **tags: str) -> Gauge:
        return self._get(Gauge, name, tags)

    def histogram(self, name: str, **tags: str) -> Histogram:
        return self._get(Histogram, name, tags)

    def remove_matching(self, prefix: str) -> int:
        """Drop every instrument whose name starts with ``prefix``
        (elastic incarnation resets — e.g. straggler attribution must
        start clean after a rendezvous).  Callers holding handles to a
        removed instrument keep a detached object; the next registry
        lookup under the same (name, tags) mints a fresh one."""
        with self._lock:
            doomed = [
                key for key, inst in self._instruments.items()
                if inst.name.startswith(prefix)
            ]
            for key in doomed:
                del self._instruments[key]
        return len(doomed)

    def register_collector(
        self, fn: Callable[["MetricsRegistry"], None]
    ) -> None:
        """Register a pre-snapshot hook that publishes externally-held
        state (e.g. the engine's ``stats`` dict) into instruments.  Runs
        inside :meth:`snapshot`, never on the hot path.  A collector
        whose owner is gone raises :class:`CollectorRetired` and is
        dropped — long-lived processes creating many engines must not
        accumulate dead hooks."""
        with self._lock:
            self._collectors.append(fn)

    def snapshot(self) -> List[dict]:
        retired = []
        for fn in list(self._collectors):
            try:
                fn(self)
            except CollectorRetired:
                retired.append(fn)
            except Exception:
                pass  # a broken collector must not lose the other metrics
        if retired:
            with self._lock:
                self._collectors = [
                    fn for fn in self._collectors if fn not in retired
                ]
        with self._lock:
            instruments = sorted(
                self._instruments.values(),
                key=lambda i: (i.name, tuple(sorted(i.tags.items()))),
            )
        return [i.as_dict() for i in instruments]

    def dump(self, path: str, *, rank) -> dict:
        """Write the dump-schema JSON document to ``path`` atomically.
        Returns the document."""
        doc = {
            "schema": "hvdtpu-metrics-v1",
            "rank": rank,
            "pid": os.getpid(),
            "wall_time": time.time(),
            "metrics": self.snapshot(),
        }
        from . import pathspec  # noqa: PLC0415

        pathspec.write_json_atomic(path, doc)
        return doc


# -- process-global registry + env-driven exit dump -------------------------

_registry: Optional[MetricsRegistry] = None
# Reentrant for the same reason as flightrec's module locks: the death
# flush calls get_registry()/dump_metrics() from signal context, and the
# interrupted thread may be inside this very lock.
_registry_lock = threading.RLock()
_atexit_installed = False


def _resolve_rank() -> str:
    from ..utils.env import artifact_rank  # noqa: PLC0415

    return artifact_rank()


def resolve_dump_path(raw: str, rank: Optional[str] = None) -> str:
    """Map the ``HVDTPU_METRICS_DUMP`` value to this rank's file —
    shared template/dir/plain-path + epoch-tag rules in obs/pathspec.py
    (the aggregator globs with the same module, so they cannot drift)."""
    from . import pathspec  # noqa: PLC0415

    return pathspec.resolve(
        raw, "metrics", _resolve_rank() if rank is None else rank
    )


def dump_metrics(path: Optional[str] = None) -> Optional[str]:
    """Dump the global registry; ``path=None`` resolves from the env.
    Returns the written path, or None when dumping is not configured."""
    raw = path or os.environ.get(METRICS_DUMP_ENV)
    if not raw:
        return None
    resolved = resolve_dump_path(raw) if path is None else path
    get_registry().dump(resolved, rank=_resolve_rank())
    return resolved


def _atexit_dump() -> None:
    try:
        dump_metrics()
    except Exception:
        pass  # never let a metrics dump break interpreter teardown


def get_registry() -> MetricsRegistry:
    """The process-global registry.  First use arms the exit dump (a
    no-op unless ``HVDTPU_METRICS_DUMP`` is set at dump time) — routed
    through the shared death-path flush (obs/flightrec.py), so it fires
    not just at clean exit but on every catchable death: excepthooks
    and fatal signals included.  A signal-killed rank leaves its
    metrics dump alongside its flight-recorder ring."""
    global _registry, _atexit_installed
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = MetricsRegistry()
                if not _atexit_installed:
                    from .flightrec import on_death  # noqa: PLC0415

                    on_death(_atexit_dump)
                    _atexit_installed = True
    return _registry


def reset_registry() -> None:
    """Drop the global registry (tests)."""
    global _registry
    with _registry_lock:
        _registry = None
