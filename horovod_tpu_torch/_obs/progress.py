"""Collective-path progress beat: counter, phase, and the launcher policy
(a copy of ``horovod_tpu/obs/progress.py``).

The elastic KV heartbeat (elastic/context.py) proves a *process* is
alive; it deliberately cannot see a deadlocked *training thread* — the
beat thread keeps beating through one, and the hang is only surfaced by
peers' collective timeouts, burning their retry budget.

This module closes that gap with three pieces:

* **Worker side** — a process-global monotonic counter ticked from the
  collective path itself (the eager engine after every performed
  response; the elastic context after every KV collective).  If the
  training thread wedges, the counter freezes even though the beat
  thread lives.
* **Phase** — ``init`` until the first tick, ``steady`` after it, and an
  explicit ``compile`` that user code (or frameworks) can set around
  legitimately long non-collective phases (kernel builds, data loading).
  The next tick returns the phase to ``steady``.
* **Waiting flag** — a rank *blocked inside* an elastic wait (it has
  contributed to a collective, or is parked in rendezvous waiting for
  the world to form) reports ``waiting``.  Its counter is frozen too,
  but it is frozen *because of someone else*: killing it would shoot
  every innocent peer of one hung rank.  The culpable rank — the one
  wedged in user code or before contributing — is the one frozen while
  NOT waiting, and that is the only one the policy kills.
* **Launcher side** — :class:`ProgressPolicy`, the workload-aware
  staleness rule: the beat payload piggybacks
  ``(counter, phase, waiting)`` on the existing heartbeat, and the
  policy applies *separate budgets* to steady-state (no collective
  completed in ``steady_timeout`` while not waiting → the thread is
  declared dead, the rank killed and respawned directly) and
  init/compile (``grace_timeout``; 0 = never kill, because "has not
  issued a collective yet" is indistinguishable from "legitimately
  computing").  Like the exit/heartbeat rules, windows are measured
  entirely on the launcher's clock from when it *observes* a change —
  immune to cross-host skew.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Dict, Optional, Tuple

__all__ = [
    "tick",
    "value",
    "phase",
    "set_phase",
    "reset",
    "waiting",
    "in_wait",
    "beat_payload",
    "beat_epoch",
    "parse_beat",
    "ProgressPolicy",
    "PHASE_INIT",
    "PHASE_COMPILE",
    "PHASE_STEADY",
]

PHASE_INIT = "init"
PHASE_COMPILE = "compile"
PHASE_STEADY = "steady"

_lock = threading.Lock()
_count = 0
_phase = PHASE_INIT
_waiting_depth = 0


def tick(n: int = 1, *, to_steady: bool = True) -> int:
    """Record ``n`` completed collectives; returns the new count.

    A USER-level collective proves the workload reached steady state,
    so the phase snaps there.  Framework-internal collectives (the
    epoch-start state sync) pass ``to_steady=False``: they advance the
    counter — the launcher sees liveness — but must not end the
    init/compile grace before the user's first step (whose kernel build
    may legitimately outlast the steady budget) has even started."""
    global _count, _phase
    changed = None
    with _lock:
        _count += n
        if to_steady and _phase != PHASE_STEADY:
            changed = _phase
            _phase = PHASE_STEADY
        count = _count
    if changed is not None:
        # Phase transitions are rare (once per phase), so the flight-
        # recorder event costs nothing on the per-tick hot path.
        from . import flightrec  # noqa: PLC0415

        flightrec.record("phase", name=PHASE_STEADY, detail=changed)
    return count


def value() -> int:
    return _count


def phase() -> str:
    return _phase


def set_phase(name: str) -> None:
    """Declare a workload phase.  ``compile`` buys the grace budget for
    a legitimately long non-collective stretch (mid-training recompile,
    giant data shuffle); the next completed collective returns the phase
    to ``steady`` automatically."""
    global _phase
    if name not in (PHASE_INIT, PHASE_COMPILE, PHASE_STEADY):
        raise ValueError(
            f"unknown phase {name!r}; expected one of "
            f"{(PHASE_INIT, PHASE_COMPILE, PHASE_STEADY)}"
        )
    with _lock:
        prev, _phase = _phase, name
    if prev != name:
        from . import flightrec  # noqa: PLC0415

        flightrec.record("phase", name=name, detail=prev)


def reset() -> None:
    """Zero the counter and phase (tests, or re-launch in-process)."""
    global _count, _phase, _waiting_depth
    with _lock:
        _count = 0
        _phase = PHASE_INIT
        _waiting_depth = 0


@contextlib.contextmanager
def waiting():
    """Mark the calling thread as blocked in an elastic wait — it has
    done its part (contributed / checked in) and is parked on peers or
    the launcher.  The beat reports it, and the progress policy exempts
    it: its freeze is someone else's fault."""
    global _waiting_depth
    with _lock:
        _waiting_depth += 1
    try:
        yield
    finally:
        with _lock:
            _waiting_depth -= 1


def in_wait() -> bool:
    return _waiting_depth > 0


def beat_payload(epoch: Optional[int] = None) -> bytes:
    """The heartbeat body: wall clock (legacy liveness field) plus the
    progress counter, phase and waiting flag, one JSON object per beat.
    ``epoch`` stamps the sender's rendezvous epoch so the launcher can
    discard a dead incarnation's stale beat instead of attributing it to
    the respawned successor."""
    doc = {"t": time.time(), "p": _count, "ph": _phase,
           "w": _waiting_depth > 0}
    if epoch is not None:
        doc["e"] = int(epoch)
    return json.dumps(doc).encode()


def beat_epoch(raw: bytes) -> Optional[int]:
    """The sender's epoch stamp, or None for legacy/unstamped beats."""
    try:
        e = json.loads(raw.decode()).get("e")
        return int(e) if e is not None else None
    except Exception:
        return None


def parse_beat(
    raw: bytes,
) -> Tuple[Optional[int], Optional[str], bool]:
    """Extract ``(progress, phase, waiting)`` from a beat body.  Legacy
    beats (bare ``repr(time.time())``) and garbage parse to
    ``(None, None, False)``: process liveness still works, the progress
    policy just has no data."""
    try:
        doc = json.loads(raw.decode())
        return (int(doc["p"]), str(doc.get("ph") or PHASE_STEADY),
                bool(doc.get("w", False)))
    except Exception:
        return None, None, False


class ProgressPolicy:
    """Launcher-side staleness judge for progress beats.

    ``observe(rank, raw_beat, now)`` returns a human-readable reason
    string when the rank should be declared dead, else None.  State is
    per-rank; call :meth:`forget` when a rank exits or is respawned so
    the successor incarnation gets fresh windows.

    Budgets:

    * ``steady_timeout`` — seconds without a new collective completing
      while the worker reports steady-state.  0 disables the policy.
    * ``grace_timeout`` — the same window while the worker reports
      init/compile.  0 (the default) never kills during those phases:
      the process heartbeat still covers frozen processes, and a worker
      that simply does not use collectives must not be shot for it.
    """

    def __init__(self, steady_timeout: float = 0.0,
                 grace_timeout: float = 0.0):
        self.steady_timeout = float(steady_timeout or 0.0)
        self.grace_timeout = float(grace_timeout or 0.0)
        # rank -> (progress, phase, waiting, launcher time last changed)
        self._seen: Dict[int, Tuple] = {}

    @property
    def enabled(self) -> bool:
        return self.steady_timeout > 0 or self.grace_timeout > 0

    def forget(self, rank: int) -> None:
        self._seen.pop(rank, None)

    def observe(self, rank: int, raw: bytes, now: float) -> Optional[str]:
        if not self.enabled:
            return None
        progress, ph, is_waiting = parse_beat(raw)
        if progress is None:
            return None  # legacy/garbled beat: no progress visibility
        seen = self._seen.get(rank)
        state = (progress, ph, is_waiting)
        if seen is None or seen[:3] != state:
            # Window (re)starts when the launcher OBSERVES a change in
            # the counter, the declared phase, or the waiting flag — a
            # worker that drops into `compile` or unblocks from a wait
            # gets a fresh window.
            self._seen[rank] = state + (now,)
            return None
        if is_waiting:
            # Blocked inside an elastic wait: it contributed / checked
            # in and is parked on peers.  Frozen, but not at fault —
            # the culpable rank is the one frozen while NOT waiting.
            return None
        budget = (
            self.steady_timeout if ph == PHASE_STEADY else self.grace_timeout
        )
        if budget <= 0:
            return None
        age = now - seen[3]
        if age <= budget:
            return None
        return (
            f"no collective completed in {age:.0f}s outside any "
            f"collective wait (phase {ph!r}, budget {budget:.0f}s, "
            f"progress counter stuck at {progress})"
        )
