"""Guarded-by inference: which lock protects which field, and who cheats.

RacerD's bet (Blackshear et al., 2018), applied to the launcher's own
thread architecture: data races are catchable *compositionally* — per
access site, record the set of locks lexically held; close that set
interprocedurally over the call graph (a helper only ever called with
``self._lock`` held is a guarded site even though it takes no lock
itself); then, per ``(class, field)``, infer the *dominant guard* — the
lock held at the overwhelming majority of post-init accesses — and
report the accesses outside it.  No interleaving exploration, no
points-to: lock identity is the same textual-but-qualified scheme the
lock-order pass uses.

Three analyses feed the HVDC108/109/110 rules in
:mod:`rules_races`:

* **Access collection** — every ``self.<attr>`` read/write in every
  method (container mutations like ``self._q.append`` count as writes),
  each tagged with the locks held *lexically* at the site.
* **Entry-lock closure** — a fixpoint over the call graph computing,
  for every function, the set of locks *guaranteed* held on entry: the
  intersection over all callers of (locks held at the call site ∪ the
  caller's own guarantee).  Thread entry points (``Thread(target=...)``
  targets, registered callbacks, signal handlers) are forced to the
  empty set — a new thread starts with no locks.
* **Escape analysis** — the RacerD ownership rule: a class is only
  *racy* if its instances can reach a second thread (it spawns threads
  from its methods, subclasses ``Thread``, registers ``self`` /
  ``self.method`` with a callback registry, or an instance is bound to
  a module global).  Unescaped classes are never reported; this is the
  single biggest false-positive filter.

Init-only writes are exempt: ``__init__`` runs before the object is
shared (up to the first escape call *inside* ``__init__`` — writes
after ``self._thread.start()`` are counted), and so do helpers whose
only callers are ``__init__``.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from . import astutil, signals
from .core import ModuleModel
from .lockgraph import CallGraph, _lock_expr, _qualify, lock_kinds

FuncKey = Tuple[str, str]          # (module relpath, qualname)
ClassKey = Tuple[str, str]         # (module relpath, class name)
FieldKey = Tuple[str, str, str]    # (module relpath, class, attr)

# Method calls on a field that mutate the receiver in place: a write to
# the field's contents for race purposes (two threads appending to one
# list race exactly like two threads assigning it).
MUTATOR_NAMES = {
    "append", "appendleft", "extend", "extendleft", "add", "insert",
    "remove", "discard", "pop", "popleft", "popitem", "update", "clear",
    "setdefault", "sort", "reverse", "put", "put_nowait",
}

# Calls that hand a callable (or the whole object) to machinery that may
# invoke it on another thread: callback registries, executors, timers.
REGISTRAR_NAMES = {
    "Thread", "Timer", "submit", "start_new_thread", "add_observer",
    "add_callback", "add_done_callback", "add_listener", "register",
    "subscribe", "on_death", "observe", "watch", "spawn", "call_soon",
    "call_later", "schedule",
}

# Field kinds that are synchronization primitives, not shared data: the
# lock IS the guard, threads/events are internally synchronized.
_SYNC_CTORS = {
    "Lock", "RLock", "Condition", "Event", "Semaphore",
    "BoundedSemaphore", "Barrier", "Thread", "Timer", "Queue",
    "SimpleQueue", "LifoQueue", "PriorityQueue", "ThreadPoolExecutor",
    "local",
}
_LOCKISH_RE = re.compile(r"(lock|mutex|cond|cv)s?$", re.IGNORECASE)

# Inference knobs (exported so tests can pin them).  A guard is inferred
# when at least GUARD_FRACTION of the counted accesses hold one lock and
# at least GUARD_MIN_SITES of them do; fields below that bar have no
# discernible discipline to enforce and stay quiet (RacerD reports
# violations of an evident protocol, not the absence of one).
GUARD_FRACTION = 0.7
GUARD_MIN_SITES = 2


@dataclass
class Access:
    """One ``self.<attr>`` touch, with its lexical lock context."""

    module: str
    cls: str
    attr: str
    write: bool
    line: int
    func: FuncKey
    held: FrozenSet[str]          # locks lexically held at the site
    init_exempt: bool = False
    # held ∪ the enclosing function's guaranteed entry locks; filled by
    # analyze() once the fixpoint has run.
    guaranteed: FrozenSet[str] = frozenset()


@dataclass
class CheckActPair:
    """A guarded field read in a branch test whose body writes the same
    field under a lock the test did not hold (check-then-act)."""

    module: str
    cls: str
    attr: str
    test_line: int
    act_line: int
    func: FuncKey
    test_held: FrozenSet[str]
    act_held: FrozenSet[str]


@dataclass
class FieldReport:
    module: str
    cls: str
    attr: str
    guard: str                    # qualified lock id
    guard_display: str            # as written ("self._lock")
    counted: int                  # post-init sites considered
    guarded: int                  # sites holding the guard
    unguarded_writes: List[Access] = field(default_factory=list)
    unguarded_reads: List[Access] = field(default_factory=list)


@dataclass
class RaceAnalysis:
    reports: List[FieldReport] = field(default_factory=list)
    check_act: List[CheckActPair] = field(default_factory=list)
    # class -> why it escapes (diagnostics / tests)
    escapes: Dict[ClassKey, str] = field(default_factory=dict)
    # function -> guaranteed-held lock set (the fixpoint result)
    entry_locks: Dict[FuncKey, FrozenSet[str]] = field(
        default_factory=dict)


def _norm_lock(lock_id: str) -> str:
    """Collapse subscripts/call arguments in a lock identity so the
    shard-striped pattern (``with self._locks[shard]:`` under one index
    name here, another there, or via a ``lock_of(shard)`` helper)
    resolves to ONE guard instead of fragmenting per spelling."""
    out = []
    depth = 0
    for ch in lock_id:
        if ch in "[(":
            if depth == 0:
                out.append(ch + "*")
            depth += 1
        elif ch in "])":
            depth -= 1
            if depth == 0:
                out.append(ch)
        elif depth == 0:
            out.append(ch)
    return "".join(out)


def _self_attr_base(node: ast.expr) -> Optional[str]:
    """``self.x`` / ``self.x[k]`` / ``self.x[k].y`` -> 'x' (the first
    attribute off ``self`` — the field whose contents are reached)."""
    seen_attr: Optional[str] = None
    cur = node
    while True:
        if isinstance(cur, ast.Attribute):
            seen_attr = cur.attr
            cur = cur.value
        elif isinstance(cur, ast.Subscript):
            cur = cur.value
        elif isinstance(cur, ast.Name):
            return seen_attr if cur.id == "self" else None
        else:
            return None


def _direct_self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _FuncScan:
    """Everything one lexical walk of a function yields: field
    accesses, held-lock sets per call site, and If-nodes with context
    (for the check-then-act pass)."""

    def __init__(self) -> None:
        self.accesses: List[Access] = []
        # (ast.Call node, frozenset held) in source order
        self.calls: List[Tuple[ast.Call, FrozenSet[str]]] = []
        self.ifs: List[Tuple[ast.If, FrozenSet[str]]] = []


def _scan_function(model: ModuleModel, key: FuncKey,
                   info: astutil.FunctionInfo,
                   kinds: Optional[Dict[str, str]] = None) -> _FuncScan:
    if kinds is None:
        kinds = lock_kinds(model)
    scan = _FuncScan()
    cls = info.cls
    consumed: Set[int] = set()  # Attribute node ids already classified

    def record(attr: Optional[str], write: bool, line: int,
               held: FrozenSet[str]) -> None:
        if attr is None or cls is None:
            return
        scan.accesses.append(Access(
            module=model.relpath, cls=cls, attr=attr, write=write,
            line=line, func=key, held=held,
        ))

    def visit(node: ast.AST, held: FrozenSet[str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            return  # nested defs run on their own schedule
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = set(held)
            for item in node.items:
                display = _lock_expr(item, kinds)
                if display is not None:
                    inner.add(_norm_lock(_qualify(model, cls, display)))
                visit(item.context_expr, held)
                if item.optional_vars is not None:
                    visit(item.optional_vars, held)
            inner_f = frozenset(inner)
            for stmt in node.body:
                visit(stmt, inner_f)
            return
        if isinstance(node, ast.If):
            scan.ifs.append((node, held))
        if isinstance(node, ast.Call):
            scan.calls.append((node, held))
            # self._q.append(x): a write to the field the receiver
            # chain bottoms out at.
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in MUTATOR_NAMES:
                base = _self_attr_base(f.value)
                if base is not None:
                    record(base, True, node.lineno, held)
                    for sub in ast.walk(f.value):
                        consumed.add(id(sub))
        if isinstance(node, (ast.Subscript, ast.Attribute)) and \
                isinstance(node.ctx, (ast.Store, ast.Del)):
            # self.x = v / self.x[k] = v / del self.x[k]
            base = _self_attr_base(node)
            if base is not None and id(node) not in consumed:
                record(base, True, node.lineno, held)
                for sub in ast.walk(node):
                    consumed.add(id(sub))
        if isinstance(node, ast.Attribute) and \
                isinstance(node.ctx, ast.Load) and \
                id(node) not in consumed:
            attr = _direct_self_attr(node)
            if attr is not None:
                record(attr, False, node.lineno, held)
                consumed.add(id(node))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    empty: FrozenSet[str] = frozenset()
    for child in ast.iter_child_nodes(info.node):
        visit(child, empty)
    return scan


# ---------------------------------------------------------------------------
# escape analysis + thread entry points
# ---------------------------------------------------------------------------


def _callable_targets(graph: CallGraph, caller: FuncKey,
                      args: List[ast.expr]) -> List[FuncKey]:
    """Resolve callable-valued arguments (``target=self._run``, a bare
    function name, a nested closure) to function keys."""
    out: List[FuncKey] = []
    for arg in args:
        out.extend(signals._resolve_handler(graph, caller, arg))
    return out


def _spawn_args(node: ast.Call) -> List[ast.expr]:
    """The argument expressions of a spawn/registrar call that may hold
    the callable (every positional + target=/function=/callback= kw)."""
    exprs = list(node.args)
    for kw in node.keywords:
        if kw.arg in ("target", "function", "callback", "fn", "func",
                      "cb", "hook", None):
            exprs.append(kw.value)
    return exprs


def find_escapes_and_entries(
    graph: CallGraph,
) -> Tuple[Dict[ClassKey, str], Set[FuncKey]]:
    """Per-class escape witnesses + the thread-entry function set.

    A function is a thread entry when another thread may call it with no
    locks held: ``Thread(target=f)`` targets, executor submissions,
    callback registrations, signal handlers, and — transitively — every
    nested closure defined inside an entry (it runs on the entry's
    thread)."""
    escapes: Dict[ClassKey, str] = {}
    entries: Set[FuncKey] = set()

    def mark_escape(ckey: ClassKey, why: str) -> None:
        escapes.setdefault(ckey, why)

    for key, info in graph.funcs.items():
        module, qualname = key
        model = graph._module_model(module)
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            name = astutil.call_name(node)
            if name not in REGISTRAR_NAMES:
                continue
            spawn_args = _spawn_args(node)
            # the spawning class escapes: its methods (or closures over
            # self) now run on a second thread / foreign callback
            if info.cls is not None and name in (
                    "Thread", "Timer", "submit", "start_new_thread"):
                mark_escape(
                    (module, info.cls),
                    f"spawns a thread in {qualname}() (line "
                    f"{node.lineno})",
                )
            # self or self.m handed to a registry
            for arg in spawn_args:
                if isinstance(arg, ast.Name) and arg.id == "self" and \
                        info.cls is not None:
                    mark_escape(
                        (module, info.cls),
                        f"registers self via {name}() in {qualname}() "
                        f"(line {node.lineno})",
                    )
                attr = _direct_self_attr(arg)
                if attr is not None and info.cls is not None:
                    mark_escape(
                        (module, info.cls),
                        f"hands self.{attr} to {name}() in "
                        f"{qualname}() (line {node.lineno})",
                    )
                # a typed receiver: pump.submit(obj.run) etc.
                if isinstance(arg, ast.Attribute) and \
                        isinstance(arg.value, ast.Name) and \
                        arg.value.id != "self":
                    tcls = info.type_env.get(arg.value.id)
                    if tcls is not None:
                        for ck in _class_keys(graph, tcls):
                            mark_escape(
                                ck,
                                f"{arg.value.id}.{arg.attr} handed to "
                                f"{name}() in {module}::{qualname}()",
                            )
            for target in _callable_targets(graph, key, spawn_args):
                entries.add(target)
                tinfo = graph.funcs.get(target)
                if tinfo is not None and tinfo.cls is not None:
                    mark_escape(
                        (target[0], tinfo.cls),
                        f"{tinfo.qualname} runs on a thread spawned in "
                        f"{module}::{qualname}() (line {node.lineno})",
                    )

    # signal handlers / death callbacks run with arbitrary lock state on
    # whatever thread the interpreter interrupts: entry with ∅ is the
    # conservative choice for guarantee purposes.
    entries.update(signals.find_roots(graph))

    # Thread subclasses: run() is an entry, the class escapes.
    for model in graph.models:
        for node in ast.walk(model.tree):
            if isinstance(node, ast.ClassDef):
                for base in node.bases:
                    text = astutil.expr_text(base)
                    if text.rsplit(".", 1)[-1] == "Thread":
                        mark_escape(
                            (model.relpath, node.name),
                            "subclasses threading.Thread",
                        )
                        run_key = (model.relpath, f"{node.name}.run")
                        if run_key in graph.funcs:
                            entries.add(run_key)
            # module-global instance: `PUMP = IngestPump(...)` at module
            # level is reachable from any importing thread.
            if isinstance(node, ast.Module):
                for stmt in node.body:
                    if isinstance(stmt, ast.Assign) and \
                            isinstance(stmt.value, ast.Call):
                        cname = astutil.call_name(stmt.value)
                        if cname:
                            for ck in _class_keys(graph, cname):
                                mark_escape(
                                    ck,
                                    f"module-global instance in "
                                    f"{model.relpath}",
                                )

    # closures nested inside an entry run on the entry's thread
    changed = True
    while changed:
        changed = False
        for key in list(graph.funcs):
            module, qualname = key
            if key in entries or ".<locals>." not in qualname:
                continue
            outer = qualname.rsplit(".<locals>.", 1)[0]
            if (module, outer) in entries:
                entries.add(key)
                changed = True
    return escapes, entries


def _class_keys(graph: CallGraph, cls_name: str) -> List[ClassKey]:
    out = []
    for (module, qualname), info in graph.funcs.items():
        if info.cls == cls_name and qualname == f"{cls_name}.__init__":
            out.append((module, cls_name))
    if not out:
        # class with no __init__ in the analyzed set: match any method
        seen = set()
        for (module, _qn), info in graph.funcs.items():
            if info.cls == cls_name and (module, cls_name) not in seen:
                seen.add((module, cls_name))
                out.append((module, cls_name))
    return out


# ---------------------------------------------------------------------------
# entry-lock fixpoint (the guarantee closure)
# ---------------------------------------------------------------------------


def compute_entry_locks(
    graph: CallGraph,
    scans: Dict[FuncKey, _FuncScan],
    entries: Set[FuncKey],
) -> Dict[FuncKey, FrozenSet[str]]:
    """For every function, the lock set guaranteed held on entry: the
    intersection (meet) over in-edges of ``held-at-callsite ∪ caller's
    guarantee``.  Entry points and in-edge-less functions get ∅.  The
    lattice is finite and the transfer monotone, so the recompute loop
    converges; the round bound matches the lock-summary closure."""
    in_edges: Dict[FuncKey, List[Tuple[FuncKey, FrozenSet[str]]]] = {}
    for key, scan in scans.items():
        info = graph.funcs[key]
        for call, held in scan.calls:
            desc = astutil.call_descriptor(call, info.type_env)
            for callee in graph.resolve(key, desc):
                if callee != key:
                    in_edges.setdefault(callee, []).append((key, held))

    TOP = None  # "never observed called": unconstrained
    H: Dict[FuncKey, Optional[FrozenSet[str]]] = {}
    for key in graph.funcs:
        if key in entries or not in_edges.get(key):
            H[key] = frozenset()
        else:
            H[key] = TOP
    for _round in range(50):
        changed = False
        for key, edges in in_edges.items():
            if key in entries:
                continue
            contribs = []
            for caller, held in edges:
                hc = H.get(caller)
                if hc is None:
                    continue  # TOP caller constrains nothing
                contribs.append(held | hc)
            if not contribs:
                continue
            new = frozenset.intersection(*contribs)
            if H[key] is None or new != H[key]:
                # meet with the old value keeps the descent monotone
                H[key] = new if H[key] is None else (H[key] & new)
                changed = True
        if not changed:
            break
    # residual TOP = dead cycles; treat as ∅ (same as roots)
    return {k: (v if v is not None else frozenset())
            for k, v in H.items()}


# ---------------------------------------------------------------------------
# per-class field facts + guard inference
# ---------------------------------------------------------------------------


def _class_sync_attrs(graph: CallGraph,
                      ckey: ClassKey) -> Tuple[Set[str], bool]:
    """(attrs that hold synchronization primitives, class-owns-a-lock).
    Detected from ``self.x = threading.Lock()``-shaped assignments in
    any method plus the lockish-name convention."""
    module, cls = ckey
    sync: Set[str] = set()
    owns_lock = False
    for (mod, _qn), info in graph.funcs.items():
        if mod != module or info.cls != cls:
            continue
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Assign) or \
                    len(node.targets) != 1:
                continue
            attr = _direct_self_attr(node.targets[0])
            if attr is None or not isinstance(node.value, ast.Call):
                continue
            cname = astutil.call_name(node.value)
            if cname in _SYNC_CTORS:
                sync.add(attr)
                if cname in ("Lock", "RLock"):
                    owns_lock = True
            elif cname == "defaultdict" and any(
                    isinstance(a, ast.Attribute) and
                    a.attr in ("Lock", "RLock")
                    for a in node.value.args):
                sync.add(attr)       # dict-of-locks (shard striping)
                owns_lock = True
    return sync, owns_lock


def _init_exemptions(graph: CallGraph, scans: Dict[FuncKey, _FuncScan],
                     in_init_only: Set[FuncKey]) -> None:
    """Mark init-only writes exempt in place.  ``__init__`` writes are
    exempt up to the first escape-shaped call inside it (after
    ``self._thread.start()`` the object is shared); helpers called only
    from ``__init__`` are wholly exempt."""
    for key, scan in scans.items():
        info = graph.funcs[key]
        qualname = key[1]
        is_init = info.cls is not None and \
            qualname == f"{info.cls}.__init__"
        if not is_init:
            if key in in_init_only:
                for a in scan.accesses:
                    a.init_exempt = True
            continue
        escape_line = None
        for call, _held in scan.calls:
            name = astutil.call_name(call)
            if name in ("Thread", "Timer", "submit",
                        "start_new_thread") or name == "start":
                if escape_line is None or call.lineno < escape_line:
                    escape_line = call.lineno
            elif name in REGISTRAR_NAMES:
                for arg in _spawn_args(call):
                    if (isinstance(arg, ast.Name) and arg.id == "self") \
                            or _direct_self_attr(arg) is not None:
                        if escape_line is None or \
                                call.lineno < escape_line:
                            escape_line = call.lineno
        for a in scan.accesses:
            if escape_line is None or a.line < escape_line:
                a.init_exempt = True


def _init_only_callees(graph: CallGraph,
                       scans: Dict[FuncKey, _FuncScan]) -> Set[FuncKey]:
    """Methods whose every observed caller is their class's __init__
    (the one-hop "called before sharing" extension of the init rule)."""
    callers: Dict[FuncKey, Set[FuncKey]] = {}
    for key, scan in scans.items():
        info = graph.funcs[key]
        for call, _held in scan.calls:
            desc = astutil.call_descriptor(call, info.type_env)
            for callee in graph.resolve(key, desc):
                if callee != key:
                    callers.setdefault(callee, set()).add(key)
    out: Set[FuncKey] = set()
    for key, cs in callers.items():
        info = graph.funcs.get(key)
        if info is None or info.cls is None:
            continue
        init_key = (key[0], f"{info.cls}.__init__")
        if cs and all(c == init_key for c in cs):
            out.add(key)
    return out


def analyze(graph: CallGraph) -> RaceAnalysis:
    """Run the full race pipeline over a closed call graph."""
    scans: Dict[FuncKey, _FuncScan] = {}
    kinds_by_module: Dict[str, Dict[str, str]] = {}
    for key, info in graph.funcs.items():
        model = graph._module_model(key[0])
        kinds = kinds_by_module.get(key[0])
        if kinds is None:
            kinds = kinds_by_module[key[0]] = lock_kinds(model)
        scans[key] = _scan_function(model, key, info, kinds)

    escapes, entries = find_escapes_and_entries(graph)
    entry_locks = compute_entry_locks(graph, scans, entries)
    _init_exemptions(graph, scans, _init_only_callees(graph, scans))

    # attach guarantees
    for key, scan in scans.items():
        base = entry_locks.get(key, frozenset())
        for a in scan.accesses:
            a.guaranteed = a.held | base

    # group post-init accesses by field, for escaped lock-owning classes
    by_field: Dict[FieldKey, List[Access]] = {}
    class_cache: Dict[ClassKey, Tuple[Set[str], bool]] = {}
    for key, scan in scans.items():
        for a in scan.accesses:
            ckey = (a.module, a.cls)
            if ckey not in class_cache:
                class_cache[ckey] = _class_sync_attrs(graph, ckey)
            sync_attrs, owns_lock = class_cache[ckey]
            if not owns_lock or ckey not in escapes:
                continue
            if a.attr in sync_attrs or _LOCKISH_RE.search(a.attr):
                continue
            by_field.setdefault((a.module, a.cls, a.attr), []).append(a)

    analysis = RaceAnalysis(escapes=escapes, entry_locks=entry_locks)
    guards: Dict[FieldKey, str] = {}
    for fkey, accesses in sorted(by_field.items()):
        counted = [a for a in accesses if not a.init_exempt]
        writes = [a for a in counted if a.write]
        if not writes:
            continue  # immutable after construction: nothing to race
        cover: Dict[str, int] = {}
        wcover: Dict[str, int] = {}
        for a in counted:
            for lock in a.guaranteed:
                cover[lock] = cover.get(lock, 0) + 1
                if a.write:
                    wcover[lock] = wcover.get(lock, 0) + 1
        # A lock qualifies as the guard on either kind of evidence:
        # (a) it covers the overwhelming majority of ALL post-init
        #     accesses (the classic dominant-guard protocol), or
        # (b) it covers the overwhelming majority of the WRITES — the
        #     mutation side is disciplined, so the unguarded reads are
        #     racing it (the stats()/snapshot shape, where one guarded
        #     writer drowns under many lockless readers).
        # Either way at least one write must hold it: a lock that only
        # ever wraps reads is guarding something else.
        qualifying = []
        for lock, wg in wcover.items():
            tg = cover[lock]
            by_total = (tg >= GUARD_MIN_SITES
                        and tg / len(counted) >= GUARD_FRACTION)
            by_writes = wg / len(writes) >= GUARD_FRACTION
            if by_total or by_writes:
                qualifying.append((tg, lock))
        if not qualifying:
            continue  # no discernible discipline to enforce
        guarded, guard = max(qualifying)
        guards[fkey] = guard
        report = FieldReport(
            module=fkey[0], cls=fkey[1], attr=fkey[2],
            guard=guard, guard_display=guard.split("::", 1)[-1],
            counted=len(counted), guarded=guarded,
        )
        for a in counted:
            if guard in a.guaranteed:
                continue
            (report.unguarded_writes if a.write
             else report.unguarded_reads).append(a)
        if report.unguarded_writes or report.unguarded_reads:
            analysis.reports.append(report)

    # check-then-act: guarded field read in a branch test without the
    # guard, written under it inside the branch body.
    for key, scan in scans.items():
        base = entry_locks.get(key, frozenset())
        for if_node, held in scan.ifs:
            test_held = held | base
            test_attrs = {
                a for n in ast.walk(if_node.test)
                if (a := _direct_self_attr(n)) is not None
            }
            if not test_attrs:
                continue
            info = graph.funcs[key]
            if info.cls is None:
                continue
            body_start = if_node.body[0].lineno
            body_end = max(
                getattr(s, "end_lineno", s.lineno) or s.lineno
                for s in if_node.body
            )
            for a in scan.accesses:
                if not a.write or a.attr not in test_attrs:
                    continue
                if not (body_start <= a.line <= body_end):
                    continue
                fkey = (a.module, a.cls, a.attr)
                guard = guards.get(fkey)
                if guard is None:
                    continue
                if guard in test_held or guard not in a.guaranteed:
                    continue
                analysis.check_act.append(CheckActPair(
                    module=a.module, cls=a.cls, attr=a.attr,
                    test_line=if_node.test.lineno, act_line=a.line,
                    func=key, test_held=test_held,
                    act_held=a.guaranteed,
                ))
    analysis.reports.sort(key=lambda r: (r.module, r.cls, r.attr))
    analysis.check_act.sort(key=lambda p: (p.module, p.test_line))
    return analysis
