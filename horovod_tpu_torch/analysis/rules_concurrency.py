"""Concurrency rules (HVDC1xx), aimed at the library's own thread and
signal architecture: engine background thread, obs snapshot/stream
threads, elastic heartbeat/monitor threads, and the flight recorder's
death hooks.

The lock rules follow RacerD's bet (Blackshear et al., 2018): lock-
discipline bugs are catchable *syntactically* from per-function
summaries — no interleaving exploration — if you accept a conservative
notion of "may acquire" and "may block".
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from . import astutil, signals
from .core import ModuleModel, SEV_ERROR, SEV_WARNING, Finding
from .lockgraph import CallGraph, nodes_under_with, shared_callgraph
from .registry import make_finding, rule

FuncKey = Tuple[str, str]

# Built once per run (the CLI analyzes one model set per process);
# Project rules share ONE closed call graph per model set — the memo
# lives in lockgraph.shared_callgraph so the mesh-taint family reuses
# the same graph instead of re-indexing every file.
def _graph(models: List[ModuleModel]) -> CallGraph:
    return shared_callgraph(models)


def _model_by_relpath(models: List[ModuleModel],
                      relpath: str) -> ModuleModel:
    for m in models:
        if m.relpath == relpath:
            return m
    raise KeyError(relpath)


# ---------------------------------------------------------------------------
# HVDC101 — inconsistent lock acquisition order
# ---------------------------------------------------------------------------


@rule("HVDC101", "lock-order-inversion", SEV_ERROR,
      "two locks acquired in opposite orders on different paths",
      scope="project")
def hvdc101(models: List[ModuleModel]) -> List[Finding]:
    """Thread A holding lock L1 while taking L2, and thread B holding
    L2 while taking L1, deadlock the moment both run — classically
    between the engine cycle thread and a teardown path.  The pass
    builds held-while-acquiring edges from each ``with``-body (including
    locks acquired by functions it calls) and flags any pair reachable
    in both orders.

    Minimal failing example::

        def a():
            with _table_lock:
                with _stats_lock: ...
        def b():
            with _stats_lock:
                with _table_lock: ...   # inversion: deadlock window

    Fix: pick one global order (document it where the locks are
    defined) and restructure the odd path out — usually by narrowing
    the outer critical section until the second acquisition is outside
    it."""
    graph = _graph(models)
    # edge (outer, inner) -> witness (module, line, via)
    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
    for key, summary in graph.summaries.items():
        for site in summary.locks:
            region = nodes_under_with(site.with_node)
            inner: Dict[str, Tuple[int, str]] = {}
            for node in region:
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for inner_site in summary.locks:
                        if inner_site.with_node is node and \
                                inner_site.lock_id != site.lock_id:
                            inner.setdefault(
                                inner_site.lock_id,
                                (node.lineno, "directly"),
                            )
            for callee in graph.callees_in_region(key, region):
                cs = graph.summaries[callee]
                for lock_id in cs.all_locks:
                    if lock_id != site.lock_id:
                        inner.setdefault(
                            lock_id,
                            (site.line, f"via {cs.qualname}()"),
                        )
            for lock_id, (line, via) in inner.items():
                edges.setdefault(
                    (site.lock_id, lock_id),
                    (key[0], line, via),
                )
    out: List[Finding] = []
    reported: Set[Tuple[str, str]] = set()
    for (a, b), (module, line, via) in sorted(edges.items()):
        if (b, a) not in edges or (b, a) in reported:
            continue
        reported.add((a, b))
        other_mod, other_line, other_via = edges[(b, a)]
        model = _model_by_relpath(models, module)
        out.append(make_finding(
            "HVDC101", model, line, 0,
            f"lock order inversion: {_short(a)} -> {_short(b)} here "
            f"({via}), but {_short(b)} -> {_short(a)} at "
            f"{other_mod}:{other_line} ({other_via}) — a deadlock "
            f"window the moment both paths run concurrently",
            f"order:{_short(a)}<->{_short(b)}",
        ))
    return out


def _short(lock_id: str) -> str:
    return lock_id.split("::", 1)[-1]


# ---------------------------------------------------------------------------
# HVDC102 — blocking call while holding a lock
# ---------------------------------------------------------------------------


@rule("HVDC102", "blocking-call-under-lock", SEV_WARNING,
      "blocking call (sleep/subprocess/socket/join/IO) under a lock",
      scope="project")
def hvdc102(models: List[ModuleModel]) -> List[Finding]:
    """A blocking call made while holding a lock turns every other
    thread that touches the lock into a hostage of the slow operation —
    the engine cycle loop stalls behind a 30 s socket timeout, or a
    heartbeat thread freezes behind a thread join.  (This is how the
    launcher's monitor can declare a perfectly healthy rank dead.)

    Minimal failing example::

        with self._lock:
            self._thread.join(timeout=30)   # everyone else now waits

    Fix: snapshot/flip state under the lock, then do the slow work
    outside it (pop-then-join, copy-then-publish)."""
    graph = _graph(models)
    out: List[Finding] = []
    for key, summary in graph.summaries.items():
        model = _model_by_relpath(models, key[0])
        for site in summary.locks:
            region = nodes_under_with(site.with_node)
            hits: List[Tuple[int, str]] = []
            for node in region:
                if isinstance(node, ast.Call):
                    from .lockgraph import _is_blocking_call  # noqa: PLC0415

                    what = _is_blocking_call(node)
                    if what is not None:
                        hits.append((node.lineno, what))
            seen_callees: Set[FuncKey] = set()
            for callee in graph.callees_in_region(key, region):
                if callee in seen_callees or callee == key:
                    continue
                seen_callees.add(callee)
                cs = graph.summaries[callee]
                if not cs.may_block:
                    continue
                # One finding per blocking callee, first witness only —
                # a full cross-product of witnesses is noise.
                what, via = sorted(cs.may_block.items())[0]
                hits.append((
                    site.line,
                    f"{what} inside {cs.qualname}() [{cs.module}]"
                    + (f" ({via})" if via != "directly" else ""),
                ))
            for line, what in sorted(set(hits)):
                out.append(make_finding(
                    "HVDC102", model, line, 0,
                    f"blocking call {what} while holding "
                    f"{site.display!r} (acquired line {site.line}): "
                    f"every thread contending this lock stalls behind "
                    f"it — move the slow work outside the critical "
                    f"section",
                    f"{summary.qualname}|{site.display}",
                ))
    return out


# ---------------------------------------------------------------------------
# HVDC103/104/107 — signal-path constraints
# ---------------------------------------------------------------------------


# Four rules walk the same reachability set; computing roots re-walks
# every function's AST, so share one result per graph instance.
_REACH_MEMO: List[tuple] = []


def _signal_reachability(models: List[ModuleModel]):
    graph = _graph(models)
    for held, reach in _REACH_MEMO:
        if held is graph:
            return graph, reach
    roots = signals.find_roots(graph)
    reach = signals.reachable_from(graph, roots)
    del _REACH_MEMO[:]
    _REACH_MEMO.append((graph, reach))
    return graph, reach


@rule("HVDC103", "nonreentrant-lock-in-signal-path", SEV_ERROR,
      "signal-reachable code takes a non-reentrant threading.Lock",
      scope="project")
def hvdc103(models: List[ModuleModel]) -> List[Finding]:
    """A signal handler runs on whatever thread the interpreter picks,
    *between any two bytecodes* — including while that same thread
    holds the lock the handler is about to take.  A plain
    ``threading.Lock`` then self-deadlocks the dying rank exactly when
    its black box matters most (a SIGTERM landing inside a SIGUSR1
    flush deadlocked that way).  Locks on any path reachable from a
    registered signal handler or death callback must be
    ``threading.RLock``.

    Minimal failing example::

        _lock = threading.Lock()          # not reentrant
        def _flush(): ...
        def handler(signum, frame):
            with _lock:                   # interrupted owner == us
                _flush()
        signal.signal(signal.SIGTERM, handler)

    Fix: ``threading.RLock()`` for every lock on the death path (and
    keep those critical sections tiny)."""
    graph, reach = _signal_reachability(models)
    out: List[Finding] = []
    for key, chain in sorted(reach.items()):
        summary = graph.summaries.get(key)
        if summary is None:
            continue
        model = _model_by_relpath(models, key[0])
        for site in summary.locks:
            if site.kind != "Lock":
                continue  # RLock fine; unknown kind: stay quiet
            out.append(make_finding(
                "HVDC103", model, site.line, 0,
                f"{site.display!r} is a non-reentrant threading.Lock "
                f"acquired on a signal-reachable path "
                f"[{signals.format_chain(chain)}]: a signal landing on "
                f"the owning thread self-deadlocks — use "
                f"threading.RLock",
                f"{summary.qualname}|{site.display}",
            ))
    return out


_LOG_RECEIVERS = {"LOG", "log", "logger", "logging"}
_LOG_METHODS = {"debug", "info", "warning", "error", "exception",
                "critical"}


@rule("HVDC104", "logging-in-signal-path", SEV_WARNING,
      "signal-reachable code logs via the logging module",
      scope="project")
def hvdc104(models: List[ModuleModel]) -> List[Finding]:
    """``logging`` handlers serialize on an internal non-reentrant
    lock: a signal handler logging while the interrupted thread was
    mid-``LOG.info`` deadlocks the same way HVDC103 does — and stream
    handlers may write to a file descriptor the dying process already
    closed.  The death path writes its evidence through the flight
    recorder's dump (atomic file replace), never through ``logging``.

    Minimal failing example::

        def on_sigterm(signum, frame):
            LOG.warning("dying")          # logging lock may be held
        signal.signal(signal.SIGTERM, on_sigterm)

    Fix: record into the flight-recorder ring (lock-free slot write
    under an RLock) and let the dump carry the message."""
    graph, reach = _signal_reachability(models)
    out: List[Finding] = []
    for key, chain in sorted(reach.items()):
        info = graph.funcs.get(key)
        if info is None:
            continue
        model = _model_by_relpath(models, key[0])
        from .lockgraph import _own_statements  # noqa: PLC0415

        for node in _own_statements(info.node):
            if not isinstance(node, ast.Call):
                continue
            name = astutil.call_name(node)
            recv = astutil.receiver_name(node)
            if name in _LOG_METHODS and recv in _LOG_RECEIVERS:
                out.append(make_finding(
                    "HVDC104", model, node.lineno, 0,
                    f"{recv}.{name}() on a signal-reachable path "
                    f"[{signals.format_chain(chain)}]: the logging "
                    f"module's handler lock is not reentrant — record "
                    f"to the flight recorder instead",
                    f"{info.qualname}",
                ))
    return out


@rule("HVDC106", "blocking-call-in-signal-path", SEV_WARNING,
      "signal-reachable code makes an unbounded blocking call",
      scope="project")
def hvdc106(models: List[ModuleModel]) -> List[Finding]:
    """The death path races the kill escalation: the launcher gives a
    dying rank ``--dump-grace-secs`` (default 5 s) between SIGTERM and
    SIGKILL.  A sleep, subprocess, or socket wait on that path spends
    the grace budget on *not writing the black box* — and a handler
    parked in a blocking syscall can't be interrupted by further
    signals the way running bytecode can.

    Minimal failing example::

        def _flush():
            time.sleep(1.0)            # burns the dump grace window
            dump()
        on_death(_flush)

    Fix: bound or remove the wait; if the call is genuinely required
    and bounded (e.g. a best-effort final publish with a timeout), keep
    it and carry a baseline entry saying so.  Ring/metrics dump file
    writes are exempt: writing the dump is the point."""
    graph, reach = _signal_reachability(models)
    out: List[Finding] = []
    for key, chain in sorted(reach.items()):
        summary = graph.summaries.get(key)
        if summary is None:
            continue
        model = _model_by_relpath(models, key[0])
        for b in summary.blocking:
            if b.what == "open()":
                continue  # dumps are the death path's purpose
            out.append(make_finding(
                "HVDC106", model, b.line, 0,
                f"blocking call {b.what} on a signal-reachable path "
                f"[{signals.format_chain(chain)}]: it spends the dump "
                f"grace window and defers further signal delivery — "
                f"bound it or move it off the death path",
                f"{summary.qualname}",
            ))
    return out


@rule("HVDC107", "unbounded-growth-in-signal-path", SEV_WARNING,
      "signal-reachable loop grows a container without bound",
      scope="project")
def hvdc107(models: List[ModuleModel]) -> List[Finding]:
    """The death path may run when the process is *already* dying of
    OOM; a flush that accumulates into an unbounded container
    (``while True: buf.append(...)``) can fail the very allocation it
    needs to write the black box.  Death-path work must be O(capacity):
    preallocated slots, bounded snapshots.

    Minimal failing example::

        def _flush():
            events = []
            while True:
                events.append(ring.next())    # grows until OOM

    Fix: iterate a bounded snapshot (the flight recorder's ring is
    fixed-capacity for exactly this reason)."""
    graph, reach = _signal_reachability(models)
    out: List[Finding] = []
    for key, chain in sorted(reach.items()):
        info = graph.funcs.get(key)
        if info is None:
            continue
        model = _model_by_relpath(models, key[0])
        for node in ast.walk(info.node):
            if not isinstance(node, ast.While):
                continue
            if not (isinstance(node.test, ast.Constant)
                    and node.test.value):
                continue  # only `while True:`-shaped loops
            if _loop_has_exit(node):
                continue
            for call in astutil.iter_calls(node):
                if astutil.call_name(call) in ("append", "extend") and \
                        isinstance(call.func, ast.Attribute):
                    out.append(make_finding(
                        "HVDC107", model, call.lineno, 0,
                        f"unbounded accumulation in a while-True loop "
                        f"on a signal-reachable path "
                        f"[{signals.format_chain(chain)}]: the death "
                        f"path may be running out of memory already — "
                        f"bound the loop",
                        f"{info.qualname}",
                    ))
    return out


def _loop_has_exit(node: ast.While) -> bool:
    for child in ast.walk(node):
        if isinstance(child, (ast.Break, ast.Return)):
            return True
    return False


# ---------------------------------------------------------------------------
# HVDC105 — broad except swallowing shutdown exceptions
# ---------------------------------------------------------------------------

_SHUTDOWN_TYPES = {
    "HorovodShutdownError", "RankDroppedError",
    "WorkersAvailableException",
}
_BROAD_TYPES = {"Exception", "BaseException", "RuntimeError"}
# Calls whose failure modes include the typed shutdown exceptions the
# elastic recovery loop keys on (a torch.distributed collective on a
# broken world raises torch's DistBackendError, a RuntimeError).
_SHUTDOWN_RAISERS = astutil.COLLECTIVE_NAMES | \
    astutil.TORCH_COLLECTIVE_NAMES | {
        "rendezvous", "sync", "result", "synchronize",
    }
_COLLECTIVE_SPELLINGS = astutil.COLLECTIVE_NAMES | \
    astutil.TORCH_COLLECTIVE_NAMES


@rule("HVDC105", "shutdown-exception-swallowed", SEV_ERROR,
      "broad except around collectives swallows shutdown errors")
def hvdc105(model: ModuleModel) -> List[Finding]:
    """``HorovodShutdownError`` (and subclasses) is the signal the
    elastic recovery loop keys on: it must PROPAGATE from a failed
    collective up to ``elastic.run``'s retry loop.  A broad
    ``except Exception:`` (or bare ``except:``, or
    ``except RuntimeError:`` — the shutdown types subclass it) that
    discards the exception converts "world broke, roll back and
    re-rendezvous" into "carry on with a half-finished collective" —
    the rank then diverges from the re-formed world or hangs.

    Minimal failing example::

        try:
            total = hvd.allreduce(grad)
        except Exception:
            total = grad                 # shutdown error swallowed:
                                         # rank skips the recovery path

    Fix: catch the shutdown types first and re-raise (or let them fly)::

        except HorovodShutdownError:
            raise
        except Exception:
            total = grad

    Handlers that re-raise, or that *use* the caught exception (store
    it, wrap it, set it on a future), are not flagged."""
    out: List[Finding] = []
    fmap = astutil.enclosing_function_map(model)
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.Try):
            continue
        # Does the try body submit anything that raises shutdown types?
        raiser: Optional[str] = None
        for stmt in node.body:
            for call in astutil.iter_calls(stmt):
                name = astutil.call_name(call)
                if name in _SHUTDOWN_RAISERS and (
                    astutil.is_collective_call(call, model)
                    or name not in _COLLECTIVE_SPELLINGS
                ):
                    raiser = name
                    break
            if raiser:
                break
        if raiser is None:
            continue
        narrowed = False
        for handler in node.handlers:
            caught = _caught_names(handler)
            if caught & _SHUTDOWN_TYPES:
                narrowed = True  # typed handler runs first: fine
                continue
            broad = (handler.type is None) or (caught & _BROAD_TYPES)
            if not broad or narrowed:
                continue
            if _handler_handles(handler):
                continue
            label = ", ".join(sorted(caught)) if caught else "bare except"
            out.append(make_finding(
                "HVDC105", model, handler.lineno, handler.col_offset,
                f"'{label}' swallows HorovodShutdownError raised by "
                f"'{raiser}' in the try body: elastic recovery needs "
                f"it to propagate — add `except HorovodShutdownError: "
                f"raise` above, or re-raise it here",
                astutil.context_for_line(model, handler.lineno, fmap),
            ))
    return out


def _caught_names(handler: ast.ExceptHandler) -> Set[str]:
    out: Set[str] = set()
    t = handler.type
    if t is None:
        return out
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    for e in elts:
        if isinstance(e, ast.Name):
            out.add(e.id)
        elif isinstance(e, ast.Attribute):
            out.add(e.attr)
    return out


def _handler_handles(handler: ast.ExceptHandler) -> bool:
    """The handler is fine when it re-raises or meaningfully uses the
    caught exception (defers it, wraps it, sets it on a future)."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
    var = handler.name
    if var:
        for node in ast.walk(handler):
            if isinstance(node, ast.Name) and node.id == var and \
                    isinstance(node.ctx, ast.Load):
                return True
    return False
