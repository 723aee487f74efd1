"""Race rules (HVDC108-110): guarded-by inference over the launcher's
own thread architecture, built on :mod:`racer`.

These rules report violations of an *evident* locking protocol: a field
whose post-init accesses overwhelmingly hold one lock has a guard, and
the minority sites outside it are the race windows.  Classes that never
escape to a second thread are exempt wholesale (the RacerD ownership
rule); so are init-only writes and synchronization-primitive fields.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from . import racer
from .core import ModuleModel, SEV_ERROR, SEV_WARNING, Finding
from .lockgraph import shared_callgraph
from .registry import make_finding, rule

# The three rules walk one analysis; memoized per closed graph instance
# (same lifetime discipline as the signal-reachability memo).
_RACE_MEMO: List[tuple] = []


def _analysis(models: List[ModuleModel]) -> racer.RaceAnalysis:
    graph = shared_callgraph(models)
    for held, result in _RACE_MEMO:
        if held is graph:
            return result
    result = racer.analyze(graph)
    del _RACE_MEMO[:]
    _RACE_MEMO.append((graph, result))
    return result


def _model_by_relpath(models: List[ModuleModel],
                      relpath: str) -> ModuleModel:
    for m in models:
        if m.relpath == relpath:
            return m
    raise KeyError(relpath)


def _held_text(held: frozenset) -> str:
    if not held:
        return "no locks"
    return ", ".join(sorted(h.split("::", 1)[-1] for h in held))


@rule("HVDC108", "unguarded-write", SEV_ERROR,
      "write to a field outside its inferred guard lock",
      scope="project")
def hvdc108(models: List[ModuleModel]) -> List[Finding]:
    """A field whose post-init accesses overwhelmingly hold one lock
    has an inferred guard; a *write* outside it races every guarded
    access — lost updates, torn containers (dict resize mid-read), and
    heisenbugs that only fire under load.  Only classes that escape to
    a second thread (spawn threads, register callbacks, subclass
    Thread, or live in a module global) are checked, and ``__init__``
    writes before the object is shared are exempt.

    Minimal failing example::

        class Pump:
            def __init__(self):
                self._lock = threading.Lock()
                self._inflight = {}
                threading.Thread(target=self._run).start()
            def _run(self):
                with self._lock:
                    self._inflight["a"] = 1   # guarded...
            def admit(self, rid):
                with self._lock:
                    self._inflight[rid] = 0   # ...guarded...
            def shutdown(self):
                self._inflight.clear()        # HVDC108: no lock held

    Fix: take the inferred guard around the write (or, if the site is
    provably single-threaded — e.g. after every worker joined —
    baseline it with that reason)."""
    analysis = _analysis(models)
    out: List[Finding] = []
    for report in analysis.reports:
        model = _model_by_relpath(models, report.module)
        for a in report.unguarded_writes:
            out.append(make_finding(
                "HVDC108", model, a.line, 0,
                f"write to {report.cls}.{a.attr} holding "
                f"{_held_text(a.guaranteed)} but its inferred guard is "
                f"{report.guard_display!r} (held at {report.guarded}/"
                f"{report.counted} post-init accesses): write/write "
                f"race with the guarded sites — take "
                f"{report.guard_display!r} here",
                f"{a.func[1]}|{report.cls}.{a.attr}",
            ))
    return out


@rule("HVDC109", "unguarded-read", SEV_WARNING,
      "read of a field outside its inferred guard lock",
      scope="project")
def hvdc109(models: List[ModuleModel]) -> List[Finding]:
    """A read outside a field's inferred guard races the guarded
    writes: it can observe a container mid-mutation (RuntimeError:
    dict changed size during iteration) or a torn multi-field update.
    Warning, not error — some unguarded reads are deliberate snapshots
    where staleness is acceptable; those get a baseline entry saying
    so, which is exactly the documentation a reviewer needs.

    Minimal failing example::

        class Pump:
            def __init__(self):
                self._lock = threading.Lock()
                self._inflight = {}
                threading.Thread(target=self._run).start()
            def _run(self):
                with self._lock:
                    self._inflight["a"] = 1
            def admit(self, rid):
                with self._lock:
                    self._inflight[rid] = 0
            def stats(self):
                return len(self._inflight)    # HVDC109: racy read

    Fix: snapshot under the guard (``with self._lock: n =
    len(self._inflight)``) — or baseline with the reason staleness is
    fine here."""
    analysis = _analysis(models)
    out: List[Finding] = []
    for report in analysis.reports:
        model = _model_by_relpath(models, report.module)
        for a in report.unguarded_reads:
            out.append(make_finding(
                "HVDC109", model, a.line, 0,
                f"read of {report.cls}.{a.attr} holding "
                f"{_held_text(a.guaranteed)} but its inferred guard is "
                f"{report.guard_display!r} (held at {report.guarded}/"
                f"{report.counted} post-init accesses): races the "
                f"guarded writes — snapshot under "
                f"{report.guard_display!r} or baseline why staleness "
                f"is acceptable",
                f"{a.func[1]}|{report.cls}.{a.attr}",
            ))
    return out


@rule("HVDC110", "check-then-act", SEV_WARNING,
      "branch checks a guarded field without the lock its body takes",
      scope="project")
def hvdc110(models: List[ModuleModel]) -> List[Finding]:
    """Checking a guarded field *outside* its lock and then acting on
    it *inside* the lock is not atomic: the world can change between
    the check and the acquisition (the stale-heartbeat/double-ingest
    shape — two supervisors both see a dead shard and both adopt it).
    The check must move inside the critical section, re-validated
    under the lock.

    Minimal failing example::

        class Registry:
            def __init__(self):
                self._lock = threading.Lock()
                self._owners = {}
                threading.Thread(target=self._run).start()
            def _run(self):
                with self._lock:
                    self._owners["s0"] = "a"
            def get_owner(self, s):
                with self._lock:
                    return self._owners.get(s)
            def adopt(self, shard, me):
                if shard not in self._owners:     # check: no lock
                    with self._lock:
                        self._owners[shard] = me  # act: under lock

    Fix: hoist the ``with`` above the ``if`` and re-test inside — the
    double-checked form needs the inner check regardless, so keep only
    the locked one."""
    analysis = _analysis(models)
    out: List[Finding] = []
    for pair in analysis.check_act:
        model = _model_by_relpath(models, pair.module)
        out.append(make_finding(
            "HVDC110", model, pair.test_line, 0,
            f"check of {pair.cls}.{pair.attr} holding "
            f"{_held_text(pair.test_held)} but the act at line "
            f"{pair.act_line} writes it under "
            f"{_held_text(pair.act_held)}: not atomic — the field can "
            f"change between check and lock acquisition; move the "
            f"check inside the critical section",
            f"{pair.func[1]}|{pair.cls}.{pair.attr}",
        ))
    return out
