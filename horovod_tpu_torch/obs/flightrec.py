"""Per-rank flight recorder: the black box that survives the crash
(counterpart of ``horovod_tpu/obs/flightrec.py``).

A fatal signal (including the launcher's own kill escalation) skips
``atexit``, so the rank that most needs to leave evidence would leave
none.  This module is the fix:

* **An always-on, bounded, in-memory event ring per rank** — fixed
  capacity, preallocated, O(1) per event (slots are mutated in place).
  Events are ``(seq, t, kind, name, cycle, detail)``: collective
  enqueue/negotiate/execute/complete with op name and negotiation cycle,
  engine phases, elastic rendezvous/epoch events, checkpoint begin /
  shard / commit and the recovery tier's ``ckpt.replica_push`` /
  ``ckpt.restore``, fault injections, health alerts, and the last
  exception.
* **A shared death-path flush** — :func:`flush` dumps the ring (when
  ``HVDTPU_FLIGHTREC_DUMP`` names a target) and then runs every
  :func:`on_death` callback (the metrics dump, the span dump, the live
  stream's final delta), LIFO like atexit.  :func:`install_death_hooks`
  arms it on ``sys.excepthook``, ``threading.excepthook`` and handlers
  for SIGTERM / SIGABRT / SIGUSR1 (SIGUSR1 is dump-only: the process
  keeps running).  Fatal signals are re-delivered with the default
  disposition afterwards, so exit statuses stay truthful.
* **A flush thread** — Python runs signal handlers on the main thread
  only, between bytecodes: a rank whose main thread waits inside a CUDA
  or NCCL call would not dump before the launcher's SIGKILL.  The hooks
  therefore also point ``signal.set_wakeup_fd`` at a pipe that a daemon
  thread reads; the C-level handler writes the signal's number there at
  once, and the thread flushes while the main thread is still blocked.
  (Not armed when something else already owns the wakeup fd.)
* **Honest limits** — SIGKILL without a grace, and a process that
  ``abort()``s from C++ (NCCL's watchdog, on a collective timeout) leave
  no dump: the post-mortem reports them as "no black box", and names the
  ranks that did dump.

The launcher-side consumer is ``obs/postmortem.py``.
"""

from __future__ import annotations

import atexit
import os
import signal
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from ..utils import env as envmod

SCHEMA = "hvdtpu-flightrec-v1"
DEFAULT_CAPACITY = 512
MIN_CAPACITY = 8

# Fatal signals the death hooks intercept.  SIGUSR1 is the dump-only
# member: flush and keep running (the launcher's kill escalation sends
# it before SIGTERM so even the SIGTERM-ignoring die leave a ring).
_FATAL_SIGNALS = ("SIGTERM", "SIGABRT")
_DUMP_SIGNAL = "SIGUSR1"

__all__ = [
    "SCHEMA",
    "FlightRecorder",
    "get_recorder",
    "reset_recorder",
    "record",
    "record_exception",
    "dump_flight_recorder",
    "resolve_dump_path",
    "add_observer",
    "remove_observer",
    "on_death",
    "flush",
    "install_death_hooks",
]

# Event tap: consumers (the goodput ledger) that want every recorded
# event as it happens, without polling snapshots.  Observers run OUTSIDE
# the ring lock, exception-swallowed — a broken consumer must not cost
# the black box an event or deadlock a dying rank.
_observers: List[Callable[[str, str, int, float], None]] = []


def add_observer(fn: Callable[[str, str, int, float], None]) -> None:
    """Register ``fn(kind, name, cycle, t)`` to run after every recorded
    event (module-level and recorder-method paths both).  Idempotent."""
    with _recorder_lock:
        if fn not in _observers:
            _observers.append(fn)


def remove_observer(fn) -> None:
    with _recorder_lock:
        if fn in _observers:
            _observers.remove(fn)


def _notify(kind: str, name: str, cycle: int, t: float) -> None:
    for fn in list(_observers):
        try:
            fn(kind, name, cycle, t)
        except Exception:
            pass


class FlightRecorder:
    """Fixed-capacity ring of structured events.

    All slots are preallocated as mutable lists and overwritten in
    place, so steady-state recording allocates nothing that outlives the
    call (Python's transient float boxing aside) and the memory bound is
    exactly ``capacity`` slots regardless of job length.  The lock is
    reentrant: a fatal-signal handler interrupting the owning thread
    mid-:meth:`record` must still be able to :meth:`snapshot`."""

    _FIELDS = ("seq", "t", "kind", "name", "cycle", "detail")

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = envmod.env_int(
                envmod.FLIGHTREC_CAPACITY, DEFAULT_CAPACITY
            )
        self.capacity = max(int(capacity), MIN_CAPACITY)
        self._slots: List[list] = [
            [0, 0.0, "", "", -1, ""] for _ in range(self.capacity)
        ]
        self._seq = 0
        self._lock = threading.RLock()
        self._last_exc: Optional[dict] = None

    # ------------------------------------------------------------- record

    def record(self, kind: str, name: str = "", cycle: int = -1,
               detail: str = "") -> None:
        """O(1), allocation-free in steady state: reserve the next slot
        and overwrite its six fields in place."""
        t = time.time()
        with self._lock:
            slot = self._slots[self._seq % self.capacity]
            slot[0] = self._seq
            slot[1] = t
            slot[2] = kind
            slot[3] = name
            slot[4] = cycle
            slot[5] = detail
            self._seq += 1
        _notify(kind, name, cycle, t)

    def record_exception(self, exc: BaseException,
                         where: str = "") -> None:
        """Remember the last exception (full, outside the ring — it is
        the single most valuable record and must not be overwritten) and
        drop an ``exception`` event into the ring."""
        doc = {
            "type": type(exc).__name__,
            "message": str(exc)[:500],
            "where": where,
            "traceback": "".join(
                traceback.format_exception(type(exc), exc, exc.__traceback__)
            )[-4000:],
        }
        with self._lock:
            self._last_exc = doc
        self.record("exception", name=type(exc).__name__,
                    detail=str(exc)[:200])

    # ----------------------------------------------------------- inspect

    @property
    def recorded(self) -> int:
        return self._seq

    @property
    def overwritten(self) -> int:
        return max(0, self._seq - self.capacity)

    def snapshot(self) -> List[Dict]:
        """Chronological copy of the live window (oldest surviving event
        first).  Taken under the lock so a concurrent record cannot tear
        a slot mid-read."""
        with self._lock:
            n = min(self._seq, self.capacity)
            start = self._seq % self.capacity if self._seq > self.capacity \
                else 0
            out = []
            for i in range(n):
                slot = self._slots[(start + i) % self.capacity]
                out.append(dict(zip(self._FIELDS, slot)))
            return out

    def dump(self, path: str, *, rank, trigger: str) -> dict:
        """Write the dump-schema JSON document atomically; returns it."""
        with self._lock:
            last_exc = dict(self._last_exc) if self._last_exc else None
        doc = {
            "schema": SCHEMA,
            "rank": rank,
            "pid": os.getpid(),
            "wall_time": time.time(),
            "trigger": trigger,
            "epoch": envmod.env_int("HVDTPU_ELASTIC_EPOCH", 0),
            "capacity": self.capacity,
            "recorded": self.recorded,
            "overwritten": self.overwritten,
            "last_exception": last_exc,
            "events": self.snapshot(),
        }
        from . import pathspec  # noqa: PLC0415

        pathspec.write_json_atomic(path, doc)
        return doc


# -- process-global recorder -------------------------------------------------

# Both module locks are REENTRANT: a fatal signal interrupting the
# owning thread mid-critical-section re-enters flush()/get_recorder()
# from the handler on the SAME thread — a plain Lock would self-
# deadlock the dying rank exactly when its dump matters most (e.g. the
# launcher's SIGUSR1 immediately followed by SIGTERM).
_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.RLock()


def get_recorder() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def reset_recorder() -> None:
    """Drop the global recorder and sticky flush trigger (tests)."""
    global _recorder, _sticky_trigger
    with _recorder_lock:
        _recorder = None
    with _death_lock:
        _sticky_trigger = None


def record(kind: str, name: str = "", cycle: int = -1,
           detail: str = "") -> None:
    """Record one event on the process-global ring (always on)."""
    get_recorder().record(kind, name=name, cycle=cycle, detail=detail)


def record_exception(exc: BaseException, where: str = "") -> None:
    get_recorder().record_exception(exc, where=where)
    # The memory plane's OOM black box rides the same death path: a
    # RESOURCE_EXHAUSTED exception additionally drops a ``mem.oom``
    # event (last census + dominant owner) so the post-mortem can name
    # WHAT was resident when the allocator gave up, not just that it
    # did.  Defensive import: a stripped tree without the plane must
    # still record the exception itself.
    try:
        from . import memplane  # noqa: PLC0415

        memplane.maybe_record_oom(exc, where=where)
    except Exception:
        pass


def _resolve_rank() -> str:
    return envmod.artifact_rank()


def resolve_dump_path(raw: str, rank: Optional[str] = None) -> str:
    """``HVDTPU_FLIGHTREC_DUMP`` value -> this rank's file, via the same
    shared pathspec rules (dir / {rank} template / plain path, epoch
    tag) the metrics and timeline artifacts use."""
    from . import pathspec  # noqa: PLC0415

    return pathspec.resolve(
        raw, "flightrec", _resolve_rank() if rank is None else rank
    )


def dump_flight_recorder(path: Optional[str] = None,
                         trigger: str = "explicit") -> Optional[str]:
    """Dump the global ring; ``path=None`` resolves from the env.
    Returns the written path, or None when dumping is not configured."""
    raw = path or os.environ.get(envmod.FLIGHTREC_DUMP)
    if not raw:
        return None
    resolved = resolve_dump_path(raw) if path is None else path
    get_recorder().dump(resolved, rank=_resolve_rank(), trigger=trigger)
    return resolved


# -- shared death-path flush -------------------------------------------------

_death_callbacks: List[Callable[[], None]] = []
_death_lock = threading.RLock()  # reentrant: see _recorder_lock
# One flush at a time across threads (the flush thread and a signal
# handler on the main thread can both be flushing): a fatal signal's
# handler re-raises only after the other flush's writes have landed.
# Reentrant, so a handler interrupting its own thread's flush proceeds.
_flush_lock = threading.RLock()
_atexit_armed = False
_hooks_installed = False
_prev_signal_handlers: Dict[int, object] = {}
_sticky_trigger: Optional[str] = None

# Triggers that mean "this process is dying abnormally".  Once one of
# these flushed, a later routine flush (the atexit leg still runs after
# an excepthook, and after a caught-and-returned worker error) must not
# overwrite the dump's trigger with a benign-looking "atexit".
_DEATH_TRIGGER_PREFIXES = ("excepthook", "threading.excepthook",
                           "exception", "signal:")


def on_death(fn: Callable[[], None]) -> None:
    """Register a flusher to run on every death path (and at clean
    exit).  First registration arms the atexit leg; the signal and
    excepthook legs are armed by :func:`install_death_hooks`.  Callbacks
    run LIFO (atexit semantics: later-armed subsystems flush first) and
    exceptions are swallowed — one broken flusher must not cost the
    others their dump."""
    global _atexit_armed
    with _death_lock:
        if fn not in _death_callbacks:
            _death_callbacks.append(fn)
        if not _atexit_armed:
            atexit.register(_atexit_flush)
            _atexit_armed = True


def flush(trigger: str) -> None:
    """The one flush every death path converges on: ring dump first
    (the black box is the point), then every registered flusher.  Safe
    to call repeatedly — later flushes refresh the dump with newer
    events, but a death trigger is sticky: the atexit leg running after
    an excepthook must not relabel the dump as a routine exit."""
    global _sticky_trigger
    is_death = trigger.startswith(_DEATH_TRIGGER_PREFIXES) and \
        trigger != f"signal:{_DUMP_SIGNAL}"
    with _death_lock:
        if is_death and _sticky_trigger is None:
            _sticky_trigger = trigger
        effective = _sticky_trigger or trigger
    with _flush_lock:
        try:
            dump_flight_recorder(trigger=effective)
        except Exception:
            pass
        with _death_lock:
            callbacks = list(_death_callbacks)
        for fn in reversed(callbacks):
            try:
                fn()
            except Exception:
                pass


def _atexit_flush() -> None:
    flush("atexit")


def install_death_hooks() -> None:
    """Arm the flush on every catchable death path.  Idempotent; safe
    to call from any thread (signal handlers are skipped off the main
    thread — the excepthook and atexit legs still arm).  Previously
    installed hooks/handlers are chained, not clobbered."""
    global _hooks_installed, _atexit_armed
    with _death_lock:
        if _hooks_installed:
            return
        _hooks_installed = True
        if not _atexit_armed:
            atexit.register(_atexit_flush)
            _atexit_armed = True

    prev_excepthook = sys.excepthook

    def _excepthook(tp, value, tb):
        try:
            if isinstance(value, BaseException):
                record_exception(value, where="excepthook")
            flush("excepthook")
        except Exception:
            pass
        prev_excepthook(tp, value, tb)

    sys.excepthook = _excepthook

    prev_thread_hook = threading.excepthook

    def _thread_hook(args):
        try:
            if args.exc_value is not None:
                record_exception(
                    args.exc_value,
                    where=f"thread:{getattr(args.thread, 'name', '?')}",
                )
            flush("threading.excepthook")
        except Exception:
            pass
        prev_thread_hook(args)

    threading.excepthook = _thread_hook

    armed = False
    for sig_name in _FATAL_SIGNALS + (_DUMP_SIGNAL,):
        signum = getattr(signal, sig_name, None)
        if signum is None:  # pragma: no cover - platform without it
            continue
        try:
            prev = signal.signal(signum, _signal_handler)
        except (ValueError, OSError):
            # not the main thread, or an unblockable signal on this
            # platform — the excepthook/atexit legs still cover us
            continue
        _prev_signal_handlers[int(signum)] = prev
        armed = True
    if armed:
        _arm_flush_thread()


def _arm_flush_thread() -> None:
    """Point the interpreter's signal wakeup fd at a pipe and flush from
    a daemon thread for every fatal or dump signal written to it: the
    dump then lands even while the main thread is blocked in C code.
    Left alone when another wakeup fd is installed (an event loop)."""
    try:
        r, w = os.pipe()
        os.set_blocking(w, False)
        prev = signal.set_wakeup_fd(w, warn_on_full_buffer=False)
    except (ValueError, OSError):
        return
    if prev != -1:
        signal.set_wakeup_fd(prev)
        os.close(r)
        os.close(w)
        return
    watched = set()
    for sig_name in _FATAL_SIGNALS + (_DUMP_SIGNAL,):
        signum = getattr(signal, sig_name, None)
        if signum is not None:
            watched.add(int(signum))

    def _reader() -> None:
        while True:
            try:
                data = os.read(r, 64)
            except OSError:
                return
            if not data:
                return
            for signum in data:
                if signum not in watched:
                    continue
                name = signal.Signals(signum).name
                try:
                    record("signal", name=name, detail="flush thread")
                    flush(f"signal:{name}")
                except Exception:
                    pass

    threading.Thread(target=_reader, daemon=True,
                     name="hvdtpu_flightrec_flush").start()


def _signal_handler(signum, frame):
    try:
        name = signal.Signals(signum).name
    except ValueError:  # pragma: no cover - unknown signal number
        name = str(signum)
    try:
        record("signal", name=name)
        flush(f"signal:{name}")
    except Exception:
        pass
    prev = _prev_signal_handlers.get(int(signum))
    if name == _DUMP_SIGNAL:
        # Dump-only: the rank keeps running (or hanging) — but a user
        # handler installed before ours (e.g. checkpoint-on-preemption:
        # SLURM delivers SIGUSR1 ahead of the kill) must still fire.
        if callable(prev) and prev is not _signal_handler:
            prev(signum, frame)
        return
    if callable(prev) and prev is not _signal_handler:
        # The real frame, not None: a prior handler inspecting
        # frame.f_lineno (a common diagnostic pattern) must not crash
        # inside signal delivery.
        prev(signum, frame)
        return
    # Default/ignored before us: restore the default disposition and
    # re-deliver so the exit status is the real signal, not a fake
    # sys.exit code (launchers and schedulers key off it).
    signal.signal(signum, signal.SIG_DFL)
    signal.raise_signal(signum)
