"""Per-rank wall-clock goodput ledger: where every second went.

Sixteen PRs of machinery emit *events* — flight-recorder phase
transitions and rendezvous records (obs/flightrec.py), progress beats
(obs/progress.py), decode/step spans (obs/trace.py) — but nothing adds
them up: after a chaos run nobody can say what fraction of the job's
wall-clock was productive work versus compile, collective waits,
checkpoint stalls or elastic recovery.  This module is the accountant.

* :class:`GoodputLedger` — an exhaustive interval ledger over the
  caller's clock.  Exactly one of the eight classes is "open" at any
  instant; :meth:`enter` closes the open interval and opens the next,
  so the per-class totals tile ``[start, now]`` with no gap and no
  overlap and the fractions sum to 1.0 by construction.  Pure function
  of the timestamps the caller supplies — decision-table tests drive a
  fake clock, production passes ``time.time()``.
* **Per-epoch lost-time attribution** — every second spent in
  ``recovery`` is additionally charged to its *cause* (``rendezvous``,
  ``respawn``, ``stall``) under the elastic epoch it happened in, so
  "epoch 3 cost 12s, all rendezvous" is a statement the ledger can
  make, not a grep over logs.
* :func:`classify_event` / :func:`ledger_from_events` — the mapping
  from the event vocabulary flightrec already records (``phase``,
  ``rendezvous``, ``ckpt.begin``/``ckpt.commit``, restores, signals)
  to ledger transitions, so a post-hoc ledger can be rebuilt from any
  rank's black box.
* :func:`install` — live wiring: subscribes to the flight recorder's
  event tap and registers a metrics collector, so ``goodput.fraction``
  and ``goodput.secs{class=…}`` gauges appear in every dump and live
  stream without any hot-path cost beyond the events already recorded.
* :class:`TokenGoodput` — the serving-side variant: tokens actually
  generated over slot-step capacity (a fleet decoding 3 tokens/step on
  a 4-slot pool has token goodput 0.75), published beside the
  KV-occupancy gauges by the serving loop.

A copy of the reference's ``horovod_tpu/obs/goodput.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "CLASSES",
    "LOST_CAUSES",
    "GoodputLedger",
    "TokenGoodput",
    "classify_event",
    "ledger_from_events",
    "install",
    "uninstall",
    "get_ledger",
    "publish",
]

# The exhaustive wall-clock partition.  `productive_step` is the only
# class that counts toward goodput.fraction; everything else is the
# overhead taxonomy the roadmap's hardware campaign needs itemized.
CLASSES: Tuple[str, ...] = (
    "init",
    "compile",
    "productive_step",
    "collective_wait",
    "checkpoint",
    "recovery",
    "idle",
    "degraded",
)

# What recovery seconds are attributed to, per elastic epoch:
# rendezvous (world re-forming), respawn (a fresh incarnation replaying
# state), stall (a wedged peer burning everyone's budget).
LOST_CAUSES: Tuple[str, ...] = ("rendezvous", "respawn", "stall")

# Classes that are excursions FROM productive time: leaving one via
# resume() returns to the class that was open when it began.
_EXCURSIONS = ("checkpoint", "collective_wait")


class GoodputLedger:
    """Exhaustive interval ledger over a caller-supplied clock.

    Thread-safe (the live tap records from whatever thread hits the
    flight recorder), but all time arithmetic is pure: no call reads a
    clock.  Non-monotonic timestamps are clamped — a backwards wall
    clock yields a zero-length interval, never a negative one."""

    def __init__(self, start: float, epoch: int = 0,
                 cls: str = "init"):
        if cls not in CLASSES:
            raise ValueError(f"unknown goodput class {cls!r}")
        self._lock = threading.RLock()
        self._start = float(start)
        self._now = float(start)
        self._cls = cls
        self._cause: Optional[str] = None
        self._epoch = int(epoch)
        self._resume_to = "productive_step"
        self._secs: Dict[str, float] = {c: 0.0 for c in CLASSES}
        # epoch -> class -> secs (the per-incarnation breakdown)
        self._by_epoch: Dict[int, Dict[str, float]] = {}
        # epoch -> cause -> secs (recovery attribution only)
        self._lost: Dict[int, Dict[str, float]] = {}

    # ------------------------------------------------------------ state

    @property
    def current(self) -> str:
        return self._cls

    @property
    def epoch(self) -> int:
        return self._epoch

    def _close(self, now: float) -> None:
        dt = max(float(now) - self._now, 0.0)
        self._now = max(float(now), self._now)
        if dt <= 0.0:
            return
        self._secs[self._cls] += dt
        per = self._by_epoch.setdefault(self._epoch, {})
        per[self._cls] = per.get(self._cls, 0.0) + dt
        if self._cls == "recovery":
            cause = self._cause or "rendezvous"
            lost = self._lost.setdefault(self._epoch, {})
            lost[cause] = lost.get(cause, 0.0) + dt

    # ------------------------------------------------------- transitions

    def enter(self, cls: str, now: float,
              cause: Optional[str] = None) -> None:
        """Close the open interval at ``now`` and open ``cls``.
        ``cause`` tags recovery time for the lost-time attribution
        (ignored for other classes)."""
        if cls not in CLASSES:
            raise ValueError(f"unknown goodput class {cls!r}")
        with self._lock:
            if cls in _EXCURSIONS and self._cls not in _EXCURSIONS:
                self._resume_to = self._cls
            self._close(now)
            self._cls = cls
            self._cause = cause if cls == "recovery" else None

    def resume(self, now: float) -> None:
        """Return from a checkpoint / collective-wait excursion to the
        class that was open when it began."""
        with self._lock:
            self.enter(self._resume_to, now)

    def epoch_start(self, epoch: int, now: float,
                    cause: str = "rendezvous") -> None:
        """An elastic epoch boundary: everything from here until the
        next class transition is recovery, charged to ``cause`` under
        the NEW epoch — the epoch that paid for it."""
        with self._lock:
            self._close(now)
            self._epoch = int(epoch)
            self._cls = "recovery"
            self._cause = cause if cause in LOST_CAUSES else "rendezvous"

    # ---------------------------------------------------------- reading

    def secs(self, now: Optional[float] = None) -> Dict[str, float]:
        """Per-class totals including the open interval (closed at
        ``now`` when given, at the last transition otherwise)."""
        with self._lock:
            out = dict(self._secs)
            if now is not None:
                dt = max(float(now) - self._now, 0.0)
                out[self._cls] += dt
            return out

    def fractions(self, now: Optional[float] = None) -> Dict[str, float]:
        """Per-class share of total wall-clock; sums to 1.0 (±fp) by
        construction whenever any time has elapsed."""
        secs = self.secs(now)
        total = sum(secs.values())
        if total <= 0.0:
            return {c: 0.0 for c in CLASSES}
        return {c: secs[c] / total for c in CLASSES}

    def by_epoch(self, now: Optional[float] = None
                 ) -> Dict[int, Dict[str, float]]:
        with self._lock:
            out = {e: dict(per) for e, per in self._by_epoch.items()}
            if now is not None:
                dt = max(float(now) - self._now, 0.0)
                if dt > 0.0:
                    per = out.setdefault(self._epoch, {})
                    per[self._cls] = per.get(self._cls, 0.0) + dt
            return out

    def lost(self, now: Optional[float] = None
             ) -> Dict[int, Dict[str, float]]:
        """Recovery seconds by (epoch, cause) — the lost-time bill."""
        with self._lock:
            out = {e: dict(c) for e, c in self._lost.items()}
            if now is not None and self._cls == "recovery":
                dt = max(float(now) - self._now, 0.0)
                if dt > 0.0:
                    cause = self._cause or "rendezvous"
                    per = out.setdefault(self._epoch, {})
                    per[cause] = per.get(cause, 0.0) + dt
            return out

    # -------------------------------------------------------- publishing

    def publish(self, reg, now: float) -> None:
        """Land the ledger in a metrics registry: ``goodput.fraction``
        (the productive share), ``goodput.secs{class=…}`` per class,
        and ``goodput.lost_secs{cause=…}`` for the recovery bill."""
        fr = self.fractions(now)
        secs = self.secs(now)
        reg.gauge("goodput.fraction").set(
            round(fr.get("productive_step", 0.0), 6))
        for cls in CLASSES:
            reg.gauge("goodput.secs", **{"class": cls}).set(
                round(secs[cls], 3))
        totals: Dict[str, float] = {}
        for per in self.lost(now).values():
            for cause, s in per.items():
                totals[cause] = totals.get(cause, 0.0) + s
        for cause, s in totals.items():
            reg.gauge("goodput.lost_secs", cause=cause).set(round(s, 3))

    def summary(self, now: Optional[float] = None) -> dict:
        """The drain/stats-summary document: fractions, seconds, and
        the per-epoch lost-time attribution."""
        return {
            "fraction": round(
                self.fractions(now).get("productive_step", 0.0), 6),
            "secs": {c: round(s, 3)
                     for c, s in self.secs(now).items() if s > 0.0},
            "lost": {
                str(e): {c: round(s, 3) for c, s in per.items()}
                for e, per in sorted(self.lost(now).items())
            },
        }


# -- event classification ----------------------------------------------------

# phase events (obs/progress.py) name the workload phase directly.
_PHASE_CLASS = {
    "init": "init",
    "compile": "compile",
    "steady": "productive_step",
}


def classify_event(kind: str, name: str = ""
                   ) -> Optional[Tuple[str, Optional[str]]]:
    """Map one flight-recorder event to a ledger transition.

    Returns ``(class, cause)`` to enter, ``("resume", None)`` for an
    excursion end (checkpoint commit), or None for events that carry no
    wall-clock meaning (collective enqueue/complete and friends tick
    too often to be transitions — the phase events already bracket
    them)."""
    if kind == "phase":
        cls = _PHASE_CLASS.get(name)
        return (cls, None) if cls else None
    if kind == "rendezvous":
        return ("recovery", "rendezvous")
    if kind == "ckpt.begin":
        return ("checkpoint", None)
    if kind in ("ckpt.commit", "ckpt.error"):
        return ("resume", None)
    if kind.startswith("ckpt.restore"):
        return ("recovery", "respawn")
    if kind == "init" and name in ("serve_replay",):
        return ("recovery", "respawn")
    if kind == "stall":
        return ("recovery", "stall")
    if kind in ("signal", "exception"):
        # Post-fault time until the process dies (or re-rendezvouses)
        # is not productive and not yet attributed: degraded.
        return ("degraded", None)
    return None


def ledger_from_events(events: List[dict], start: Optional[float] = None,
                       end: Optional[float] = None,
                       epoch: int = 0) -> GoodputLedger:
    """Fold a flight-recorder event list (dump schema: dicts with
    ``t``/``kind``/``name``/``cycle``) into a ledger — the post-hoc
    accountant over any rank's black box."""
    events = sorted(
        (e for e in events if isinstance(e.get("t"), (int, float))),
        key=lambda e: e["t"],
    )
    if start is None:
        start = events[0]["t"] if events else 0.0
    ledger = GoodputLedger(start, epoch=epoch)
    for e in events:
        verdict = classify_event(str(e.get("kind", "")),
                                 str(e.get("name", "")))
        if verdict is None:
            continue
        cls, cause = verdict
        t = max(float(e["t"]), start)
        if cls == "resume":
            ledger.resume(t)
        elif str(e.get("kind")) == "rendezvous":
            cycle = e.get("cycle")
            ledger.epoch_start(
                int(cycle) if isinstance(cycle, int) and cycle >= 0
                else ledger.epoch + 1, t, cause=cause or "rendezvous")
        else:
            ledger.enter(cls, t, cause=cause)
    if end is not None:
        # Close the trailing interval so fractions cover [start, end].
        ledger.enter(ledger.current, end)
    return ledger


# -- serving token goodput ---------------------------------------------------


class TokenGoodput:
    """Decode-capacity utilization: tokens actually generated over the
    slot-step capacity that elapsed — ``tokens ÷ (steps × slots)``, and
    per wall-clock, ``tokens ÷ (slot-seconds)`` against the pool.  A
    4-slot pool decoding 3 tokens per step has token goodput 0.75; an
    idle pool decays toward 0.  Pure function of the caller's clock,
    like the ledger."""

    def __init__(self, slots: int, start: float):
        self.slots = max(int(slots), 1)
        self._start = float(start)
        self._tokens = 0
        self._steps = 0

    def observe_step(self, tokens: int) -> None:
        """One decode step completed, emitting ``tokens`` (0 on an idle
        step — idle capacity is exactly what the fraction must see)."""
        self._steps += 1
        self._tokens += max(int(tokens), 0)

    @property
    def tokens(self) -> int:
        return self._tokens

    def fraction(self) -> float:
        """Share of slot-step capacity converted into tokens."""
        if self._steps <= 0:
            return 0.0
        return self._tokens / float(self._steps * self.slots)

    def per_slot_second(self, now: float) -> float:
        """Tokens per slot-second of pool existence."""
        elapsed = max(float(now) - self._start, 1e-9)
        return self._tokens / (elapsed * self.slots)

    def publish(self, reg, now: float) -> None:
        reg.gauge("serve.goodput.token_fraction").set(
            round(self.fraction(), 6))
        reg.gauge("serve.goodput.tokens_per_slot_sec").set(
            round(self.per_slot_second(now), 4))


# -- live wiring -------------------------------------------------------------

_ledger: Optional[GoodputLedger] = None
_lock = threading.RLock()
_tap_installed = False


def get_ledger() -> Optional[GoodputLedger]:
    return _ledger


def _on_event(kind: str, name: str, cycle: int, t: float) -> None:
    ledger = _ledger
    if ledger is None:
        return
    verdict = classify_event(kind, name)
    if verdict is None:
        return
    cls, cause = verdict
    if cls == "resume":
        ledger.resume(t)
    elif kind == "rendezvous":
        ledger.epoch_start(
            cycle if isinstance(cycle, int) and cycle >= 0
            else ledger.epoch + 1, t, cause=cause or "rendezvous")
    else:
        ledger.enter(cls, t, cause=cause)


def _collect(reg) -> None:
    # A pre-snapshot hook, not a retiring collector: the ledger may be
    # re-armed after a reset and the hook must keep working.
    ledger = _ledger
    if ledger is not None:
        ledger.publish(reg, time.time())


_collector_reg = None  # the registry instance _collect is registered on


def install(now: Optional[float] = None, epoch: int = 0) -> GoodputLedger:
    """Arm the live ledger: one module-global :class:`GoodputLedger`
    fed by the flight recorder's event tap (every phase / rendezvous /
    ckpt event already being recorded becomes a transition), published
    into the process registry by a pre-snapshot collector.  Idempotent
    per process; re-installing resets the ledger (a fresh incarnation
    starts a fresh book — its flight-recorder rendezvous event charges
    the recovery to the new epoch)."""
    global _ledger, _tap_installed, _collector_reg
    from . import flightrec  # noqa: PLC0415
    from .registry import get_registry  # noqa: PLC0415

    with _lock:
        _ledger = GoodputLedger(
            time.time() if now is None else now, epoch=epoch)
        if not _tap_installed:
            flightrec.add_observer(_on_event)
            _tap_installed = True
        # reset_registry() mints a fresh registry without our hook, so
        # registration is per registry INSTANCE, not per process.
        reg = get_registry()
        if _collector_reg is not reg:
            reg.register_collector(_collect)
            _collector_reg = reg
    return _ledger


def uninstall() -> None:
    """Drop the live ledger (tests).  The tap stays registered but
    becomes a no-op; the collector retires itself on next snapshot."""
    global _ledger
    with _lock:
        _ledger = None


def publish(reg, now: Optional[float] = None) -> None:
    """Publish the live ledger into ``reg`` (no-op when not armed)."""
    ledger = _ledger
    if ledger is not None:
        ledger.publish(reg, time.time() if now is None else now)
