"""Observability hooks of the runtime (counterpart of
``horovod_tpu/obs``, ROADMAP A13).  Private: the top level's ``obs``
raises ``NotPortedError`` until A13 ports the planes and this package
becomes ``obs``.

The runtime modules call the reference's hooks under the reference's
names — ``get_registry()`` counters, gauges and histograms,
``flightrec.record`` / ``record_exception``, ``progress.tick``,
``trace.enabled`` / ``add_span``, ``straggler.record`` — so that porting
the planes replaces the bodies here and no call site.  Until then:

* the registry is in memory only (no dump, no scrape, no live stream):
  its instruments hold their values, which the engine's and the
  checkpoint tiers' callers read;
* the flight recorder, tracer and straggler attribution record nothing;
* ``progress`` is the reference's collective-path progress beat, whole
  (:mod:`.progress`): the elastic launcher's deadlock watchdog reads it;
* ``pathspec`` carries the path rules the timeline and the autotune log
  need and the atomic writers of the checkpoint tiers (:mod:`.pathspec`);
* the serving plane's: ``slo`` (:mod:`.slo`, whole: the ``--slo-*``
  objectives and their burn-rate books), ``goodput`` (:mod:`.goodput`:
  ``TokenGoodput`` whole, the wall-clock ledger's hooks record nothing),
  ``memplane`` (:mod:`.memplane`: ``alloc_guard`` keeps its ``mem_alloc``
  fault point, the census records nothing) and ``profile``
  (:mod:`.profile`: ``MFUProfiler`` records nothing).
"""

from __future__ import annotations

import threading
from types import SimpleNamespace
from typing import Callable, Dict, List, Tuple

__all__ = ["get_registry", "CollectorRetired",
           "flightrec", "progress", "trace", "straggler", "pathspec",
           "slo", "goodput", "memplane", "profile"]


class Counter:
    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v


class CollectorRetired(Exception):
    """Raised by a snapshot collector whose owner is gone: the registry
    drops it."""


class Registry:
    """Tagged instruments by name, created on first use."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._items: Dict[Tuple, object] = {}
        self._collectors: List[Callable] = []

    def _get(self, cls, name: str, tags: dict):
        key = (cls.__name__, name, tuple(sorted(tags.items())))
        with self._lock:
            item = self._items.get(key)
            if item is None:
                item = self._items[key] = cls()
            return item

    def counter(self, name: str, **tags) -> Counter:
        return self._get(Counter, name, tags)

    def gauge(self, name: str, **tags) -> Gauge:
        return self._get(Gauge, name, tags)

    def histogram(self, name: str, **tags) -> Histogram:
        return self._get(Histogram, name, tags)

    def register_collector(self, fn: Callable) -> None:
        with self._lock:
            self._collectors.append(fn)

    def snapshot(self) -> None:
        """Run the collectors (which publish, e.g., the engine's stats as
        gauges); a retired one is dropped."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn(self)
            except CollectorRetired:
                with self._lock:
                    self._collectors.remove(fn)


_registry = Registry()


def get_registry() -> Registry:
    return _registry


def _noop(*args, **kwargs) -> None:
    return None


flightrec = SimpleNamespace(record=_noop, record_exception=_noop)
trace = SimpleNamespace(enabled=lambda: False, add_span=_noop,
                        sampled=lambda *args: False,
                        sample_rate=lambda: 1.0)
straggler = SimpleNamespace(record=_noop, record_waits=_noop, reset=_noop)

from . import goodput, memplane, pathspec, profile, progress, slo  # noqa: E402,I001
