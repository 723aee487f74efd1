"""Per-rank live metrics streaming: the worker half of the telemetry
plane.

The metrics dumps are post-mortem — per-rank JSON dumps at
process exit, aggregated once the job is over.  This module makes the
same registry inspectable *while the job runs*: a daemon thread snapshots
the metrics registry every ``HVDTPU_LIVE_STATS_SECS`` seconds, diffs it
against the previous snapshot, and publishes a compact delta document to
the launcher's KV store over the existing HMAC-signed PUT path
(run/rendezvous.py) — no new listening sockets on workers, and the same
trust model as every other KV payload.

Wire contract (consumed by obs/live.py's launcher aggregator):

* key: ``obs/live/{epoch}/{rank}/{seq}`` — one key per publish, so the
  aggregator never loses a delta to an overwrite; it deletes keys as it
  consumes them (the launcher owns the store's memory).
* value: JSON ``{"v": 1, "rank", "epoch", "seq", "t", "phase",
  "progress", "full", "metrics": [compact instruments...]}`` where
  ``metrics`` carries only the instruments that changed since the last
  publish (all of them on the first, ``full: true``).  Every entry
  carries the instrument's *current* value, never an increment, so a
  lost or reordered delta heals itself the next time the instrument
  moves.

Compact instrument encoding (≈60% smaller than the dump schema):

* counter/gauge: ``{"n", "k": "c"|"g", "g": tags?, "v": value}``
* histogram: ``{"n", "k": "h", "g": tags?, "c": count, "s": sum,
  "mn": min, "mx": max, "q50", "q90", "q99"}``

A copy of the reference's ``horovod_tpu/obs/stream.py``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..utils import env as envmod
from ..utils.logging import get_logger
from .registry import get_registry

LOG = get_logger("obs.stream")

LIVE_SCOPE = "obs/live"

__all__ = [
    "LIVE_SCOPE",
    "snapshot_map",
    "encode_delta",
    "expand_metric",
    "apply_delta",
    "StreamPublisher",
    "maybe_start_from_env",
    "stop_stream",
]

_KIND_SHORT = {"counter": "c", "gauge": "g", "histogram": "h"}
_KIND_LONG = {v: k for k, v in _KIND_SHORT.items()}


def metric_key(metric: dict) -> str:
    """Stable identity of one instrument inside a snapshot: name plus
    sorted tags (the same identity the registry itself keys on)."""
    tags = metric.get("tags") or {}
    if not tags:
        return metric["name"]
    return metric["name"] + "{" + ",".join(
        f"{k}={v}" for k, v in sorted(tags.items())
    ) + "}"


def snapshot_map(metrics: List[dict]) -> Dict[str, dict]:
    """Dump-schema snapshot list -> {identity: metric dict}."""
    return {metric_key(m): m for m in metrics}


def _compact(metric: dict) -> dict:
    out = {"n": metric["name"], "k": _KIND_SHORT[metric["type"]]}
    if metric.get("tags"):
        out["g"] = metric["tags"]
    if metric["type"] == "histogram":
        out.update(
            c=metric["count"], s=metric["sum"],
            mn=metric["min"], mx=metric["max"],
            q50=metric["p50"], q90=metric["p90"], q99=metric["p99"],
        )
    else:
        out["v"] = metric["value"]
    return out


def expand_metric(compact: dict) -> dict:
    """Compact wire form -> dump-schema form (the aggregator's working
    representation, so live views and end-of-job dumps compare 1:1)."""
    kind = _KIND_LONG[compact["k"]]
    out = {"name": compact["n"], "type": kind,
           "tags": dict(compact.get("g") or {})}
    if kind == "histogram":
        count = compact["c"]
        out.update(
            count=count, sum=compact["s"],
            min=compact["mn"], max=compact["mx"],
            mean=(compact["s"] / count) if count else None,
            p50=compact["q50"], p90=compact["q90"], p99=compact["q99"],
        )
    else:
        out["value"] = compact["v"]
    return out


def encode_delta(
    prev: Dict[str, dict], cur: Dict[str, dict]
) -> List[dict]:
    """The compact entries for every instrument that changed (or
    appeared) between two snapshot maps, plus a ``{"rm": key}``
    tombstone per instrument that *disappeared* — instrument removal
    (the elastic-rendezvous straggler reset) must reach the launcher
    view, or stale blame would survive a re-formed world forever."""
    out: List[dict] = [
        {"rm": key} for key in prev if key not in cur
    ]
    out.extend(_compact(m) for key, m in cur.items() if prev.get(key) != m)
    return out


def apply_delta(view: Dict[str, dict], delta: List[dict]) -> None:
    """Apply a wire delta onto an aggregator-side view map in place."""
    for compact in delta:
        if "rm" in compact:
            view.pop(compact["rm"], None)
            continue
        m = expand_metric(compact)
        view[metric_key(m)] = m


class StreamPublisher:
    """One worker's snapshot-diff-publish loop.  Publishes every
    ``interval`` seconds whether or not anything changed — an empty
    delta is the liveness signal the aggregator's "ranks reporting"
    count rests on.  Publish failures are swallowed: the launcher going
    away must never take the training process with it."""

    def __init__(self, kv, rank, epoch: int, interval: float):
        self.kv = kv
        self.rank = rank
        self.epoch = int(epoch)
        self.interval = float(interval)
        self._prev: Dict[str, dict] = {}
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def publish_once(self) -> Optional[bytes]:
        """Snapshot, diff, publish one document; returns the payload
        (tests), or None when the PUT failed."""
        from . import progress as obs_progress  # noqa: PLC0415

        cur = snapshot_map(get_registry().snapshot())
        full = self._seq == 0
        delta = encode_delta({} if full else self._prev, cur)
        doc = {
            "v": 1,
            "rank": int(self.rank),
            "epoch": self.epoch,
            "seq": self._seq,
            "t": time.time(),
            "phase": obs_progress.phase(),
            "progress": obs_progress.value(),
            "full": full,
            "metrics": delta,
        }
        payload = json.dumps(doc, separators=(",", ":")).encode()
        try:
            self.kv.put(
                f"{LIVE_SCOPE}/{self.epoch}", f"{self.rank}/{self._seq}",
                payload,
            )
        except Exception:
            return None  # launcher down/restarting; try again next beat
        self._prev = cur
        self._seq += 1
        return payload

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="hvdtpu_live_stream", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.publish_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        # Final flush: the last partial interval's metrics (often the
        # job's concluding straggler attributions) must reach the
        # launcher's end-of-job drain round.  Best-effort like every
        # other publish.
        self.publish_once()


_current: Optional[StreamPublisher] = None
# Reentrant: _death_flush runs on the fatal-signal path, and a second
# signal interrupting the owning thread inside this lock (the
# launcher's SIGUSR1-then-SIGTERM escalation) must not self-deadlock
# the dying rank — same rationale as flightrec.py's module locks.
_current_lock = threading.RLock()
_atexit_installed = False


def _env_config() -> Optional[Tuple[str, float, str, int]]:
    interval = envmod.env_float(envmod.LIVE_STATS, 0.0)
    if interval <= 0:
        return None
    addr = (os.environ.get(envmod.LIVE_KV)
            or os.environ.get("HVDTPU_ELASTIC_KV"))
    if not addr:
        return None
    rank = envmod.resolve_rank(0)
    epoch = envmod.env_int("HVDTPU_ELASTIC_EPOCH", 0)
    return addr, interval, str(rank), epoch


def maybe_start_from_env() -> Optional[StreamPublisher]:
    """Start (once per process) the live publisher when the launcher
    armed it: ``HVDTPU_LIVE_STATS_SECS > 0`` and a KV endpoint present.
    Called from ``hvd.init()`` and the elastic heartbeat start, so both
    launch modes stream without user code changes."""
    global _current, _atexit_installed
    # The memory plane's env opt-in rides the same worker-init hook:
    # HVDTPU_MEM_CENSUS=1 arms the census collector here regardless of
    # whether streaming itself is on (the exit dump consumes it too).
    try:
        from . import memplane  # noqa: PLC0415

        memplane.maybe_install_from_env()
    except Exception:
        pass
    cfg = _env_config()
    if cfg is None:
        return None
    with _current_lock:
        if _current is not None:
            return _current
        addr, interval, rank, epoch = cfg
        from ..run.rendezvous import KVStoreClient  # noqa: PLC0415

        pub = StreamPublisher(
            KVStoreClient(addr), rank=rank, epoch=epoch, interval=interval
        )
        pub.start()
        if not _atexit_installed:
            # Exit flush: publish the final partial interval.  Routed
            # through the shared death-path flush (obs/flightrec.py) so
            # the final live delta also survives excepthook/signal
            # deaths; registered after the registry's dump hook, so
            # (LIFO) it runs BEFORE the process's metrics dump.
            # Deliberately non-destructive — a dump-only flush (the
            # SIGUSR1 black-box request) happens MID-RUN and must not
            # stop the publisher; at real exit the daemon thread dies
            # with the process and the delta published here is the
            # flush that matters.
            from .flightrec import on_death  # noqa: PLC0415

            on_death(_death_flush)
            _atexit_installed = True
        LOG.debug("live stats streaming to %s every %.2fs", addr, interval)
        _current = pub
        return pub


def _death_flush() -> None:
    """Publish the current delta without tearing the publisher down
    (the shared death-path flush runs this on every flush trigger,
    including mid-run dump-only ones)."""
    with _current_lock:
        pub = _current
    if pub is not None:
        pub.publish_once()


def stop_stream() -> None:
    """Stop the process publisher (tests, or in-process re-launch)."""
    global _current
    # Detach under the lock, stop outside it: stop() joins the publisher
    # thread and issues the final (network) publish — holding the lock
    # through that would stall maybe_start_from_env()/_death_flush
    # callers, including the fatal-signal flush.
    with _current_lock:
        pub, _current = _current, None
    if pub is not None:
        pub.stop()
