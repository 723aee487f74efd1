"""Lock-graph builder: syntactic lock acquisition + blocking-call facts.

RacerD-style compositional summaries: for every function we record
(1) which locks its body may acquire and (2) which blocking calls it may
make, then propagate both over the call graph to a fixpoint.  Lock
identity is textual-but-qualified: ``module.py::_registry_lock`` for
module globals, ``module.py::Class.self._lock`` for instance locks —
precise enough for ordering checks without points-to analysis.

"Looks like a lock" = the with-item's expression ends in a name
containing ``lock`` (``self._lock``, ``_registry_lock``,
``self.server.kv_lock``) or is a name we saw assigned from
``threading.Lock()`` / ``RLock()``.  Kind (reentrant or not) is
resolved from those assignments when available.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from . import astutil
from .core import ModuleModel

# Call spellings that can block the calling thread for unbounded (or
# operator-scale) time.  attr-qualified entries match "recv.attr";
# bare entries match a call's trailing name.
BLOCKING_MODULE_CALLS = {
    ("time", "sleep"),
    ("subprocess", "run"), ("subprocess", "call"),
    ("subprocess", "check_call"), ("subprocess", "check_output"),
    ("subprocess", "Popen"),
    ("socket", "create_connection"),
}
BLOCKING_ATTR_NAMES = {
    "wait", "wait_until_finished", "acquire_timeout",
    "recv", "recvfrom", "accept", "connect", "communicate",
    "urlopen", "readline",
}
BLOCKING_BARE_NAMES = {"sleep", "urlopen", "open"}
# `.join()` blocks when it's a thread join; `"".join(parts)` is not.
_THREADISH = ("thread", "proc", "worker", "pump")


@dataclass
class LockSite:
    lock_id: str         # qualified identity
    display: str         # as written ("self._lock")
    line: int
    kind: Optional[str]  # "Lock" | "RLock" | None (unknown)
    with_node: ast.With


@dataclass
class BlockingSite:
    what: str
    line: int


@dataclass
class FuncSummary:
    qualname: str
    module: str
    # Directly (lexically) acquired locks and blocking calls.
    locks: List[LockSite] = field(default_factory=list)
    blocking: List[BlockingSite] = field(default_factory=list)
    # Closed over the call graph (lock_id set / witness map).
    all_locks: Set[str] = field(default_factory=set)
    may_block: Dict[str, str] = field(default_factory=dict)  # what -> via


def lock_kinds(model: ModuleModel) -> Dict[str, str]:
    """Map lock display text -> 'Lock'/'RLock' from assignments like
    ``X = threading.Lock()`` / ``self._x = threading.RLock()``
    (annotated assignments included)."""
    kinds: Dict[str, str] = {}
    for node in ast.walk(model.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            target, value = node.target, node.value
        else:
            continue
        if not isinstance(value, ast.Call):
            continue
        name = astutil.call_name(value)
        if name not in ("Lock", "RLock"):
            continue
        if isinstance(target, (ast.Name, ast.Attribute)):
            kinds[astutil.expr_text(target)] = name
    return kinds


def _lock_expr(item: ast.withitem,
               kinds: Optional[Dict[str, str]] = None) -> Optional[str]:
    """The with-item's expression text when it looks like a lock: a
    lockish name, or — regardless of name — an expression we saw
    assigned from ``threading.Lock()`` / ``RLock()`` (``self._meta =
    threading.Lock()`` guards just as hard as ``self._lock``)."""
    expr = item.context_expr
    text = astutil.expr_text(expr)
    if kinds and text in kinds:
        return text
    tail = text.rsplit(".", 1)[-1]
    if "lock" in tail.lower() or "mutex" in tail.lower():
        return text
    return None


def _qualify(model: ModuleModel, cls: Optional[str], display: str) -> str:
    if display.startswith("self."):
        return f"{model.relpath}::{cls or '?'}.{display}"
    return f"{model.relpath}::{display}"


def _is_blocking_call(node: ast.Call) -> Optional[str]:
    name = astutil.call_name(node)
    recv = astutil.receiver_name(node)
    if recv is not None and (recv, name) in BLOCKING_MODULE_CALLS:
        return f"{recv}.{name}()"
    if name in BLOCKING_ATTR_NAMES and isinstance(node.func, ast.Attribute):
        return f"{astutil.expr_text(node.func)}()"
    if name in BLOCKING_BARE_NAMES and isinstance(node.func, ast.Name):
        return f"{name}()"
    if name == "join" and isinstance(node.func, ast.Attribute):
        recv_text = astutil.expr_text(node.func.value).lower()
        has_timeout = any(kw.arg == "timeout" for kw in node.keywords)
        if has_timeout or any(t in recv_text for t in _THREADISH):
            return f"{astutil.expr_text(node.func)}()"
    return None


def summarize_module(
    model: ModuleModel,
    funcs: Dict[str, astutil.FunctionInfo],
) -> Dict[str, FuncSummary]:
    kinds = lock_kinds(model)
    out: Dict[str, FuncSummary] = {}
    for qn, info in funcs.items():
        s = FuncSummary(qualname=qn, module=model.relpath)
        own_body = _own_statements(info.node)
        for node in own_body:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    display = _lock_expr(item, kinds)
                    if display is None:
                        continue
                    s.locks.append(LockSite(
                        lock_id=_qualify(model, info.cls, display),
                        display=display,
                        line=node.lineno,
                        kind=kinds.get(display),
                        with_node=node,
                    ))
            if isinstance(node, ast.Call):
                what = _is_blocking_call(node)
                if what is not None:
                    s.blocking.append(BlockingSite(what, node.lineno))
        out[qn] = s
    return out


def _own_statements(func: ast.AST) -> List[ast.AST]:
    """Every node in the function body EXCLUDING nested function/class
    bodies (their effects belong to their own summaries)."""
    out: List[ast.AST] = []
    stack: List[ast.AST] = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def nodes_under_with(with_node: ast.With) -> List[ast.AST]:
    """Every node lexically inside the with body (nested defs excluded
    — they don't run while the lock is held)."""
    out: List[ast.AST] = []
    stack: List[ast.AST] = list(with_node.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


# ---------------------------------------------------------------------------
# project-wide call-graph closure
# ---------------------------------------------------------------------------

# Method names too generic to resolve project-wide by name alone
# (collection/file/str methods): resolving `.get()` to KVStoreClient.get
# would make every dict read a blocking socket call.
GENERIC_ATTRS = {
    "get", "pop", "items", "keys", "values", "update", "clear", "copy",
    "append", "extend", "add", "remove", "discard", "setdefault",
    "count", "index", "sort", "reverse", "split", "strip", "encode",
    "decode", "format", "startswith", "endswith", "lower", "upper",
    "read", "write", "close", "flush", "done", "result", "set",
    "insert", "exists", "touch", "match", "group", "search", "sub",
    "cancel", "total_seconds", "is_alive", "getpid", "name",
    # join/wait: ''.join / os.path.join / Event.wait are everywhere —
    # resolving them to Thread-owning methods by name poisons every
    # chain.  The *direct* blocking-call detector still sees them.
    "join", "wait",
}


class CallGraph:
    """Name-based call resolution across the analyzed module set."""

    def __init__(self, models: List[ModuleModel]):
        self.models = models
        self.funcs: Dict[Tuple[str, str], astutil.FunctionInfo] = {}
        self.summaries: Dict[Tuple[str, str], FuncSummary] = {}
        self.by_module: Dict[str, Dict[str, astutil.FunctionInfo]] = {}
        # bare/method name -> [(module, qualname)]
        self._by_name: Dict[str, List[Tuple[str, str]]] = {}
        self._method_by_name: Dict[str, List[Tuple[str, str]]] = {}
        self._module_by_relpath: Dict[str, ModuleModel] = {}
        for model in models:
            funcs = astutil.index_functions(model)
            self.by_module[model.relpath] = funcs
            self._module_by_relpath[model.relpath] = model
            sums = summarize_module(model, funcs)
            for qn, info in funcs.items():
                key = (model.relpath, qn)
                self.funcs[key] = info
                self.summaries[key] = sums[qn]
                short = qn.rsplit(".", 1)[-1]
                self._by_name.setdefault(short, []).append(key)
                if info.cls is not None:
                    self._method_by_name.setdefault(short, []).append(key)

    # -- resolution --------------------------------------------------------

    def resolve(self, caller: Tuple[str, str],
                call: Tuple[str, object]) -> List[Tuple[str, str]]:
        module, qualname = caller
        model = self._module_by_relpath[module]
        kind, data = call
        if kind == "bare":
            name = str(data)
            if (module, name) in self.funcs:  # top-level def
                return [(module, name)]
            # nested defs / same-module fallback by trailing name
            local = [
                k for k in self._by_name.get(name, ()) if k[0] == module
            ]
            if local:
                return local
            origin = self._module_model(module).from_imports.get(name)
            if origin is not None:
                return self._resolve_import(module, origin)
            return []
        if kind == "self":
            name = str(data)
            info = self.funcs[caller]
            if info.cls is not None and \
                    (module, f"{info.cls}.{name}") in self.funcs:
                return [(module, f"{info.cls}.{name}")]
            # fall through to name-based method match
            return self._method_match(name)
        if kind == "typed":
            cls, name = data  # type: ignore[misc]
            qn = f"{cls}.{name}"
            hits = [
                k for k in self._by_name.get(str(name), ())
                if k[1] == qn
            ]
            if hits:
                return hits
            return self._method_match(str(name))
        if kind == "mod":
            alias, name = data  # type: ignore[misc]
            target_mod = self._resolve_module_alias(module, str(alias))
            if target_mod is not None:
                if (target_mod, str(name)) in self.funcs:
                    return [(target_mod, str(name))]
                return []
            # alias is not a module we analyze: treat as generic attr
            return self._method_match(str(name))
        if kind == "attr":
            return self._method_match(str(data))
        return []

    def _method_match(self, name: str) -> List[Tuple[str, str]]:
        if name in GENERIC_ATTRS:
            return []
        cands = self._method_by_name.get(name, [])
        # Over-approximation bound: a name implemented in many places
        # is too ambiguous to assert anything about.
        return cands if len(cands) <= 3 else []

    def _module_model(self, relpath: str) -> ModuleModel:
        return self._module_by_relpath[relpath]

    def _resolve_module_alias(self, module: str,
                              alias: str) -> Optional[str]:
        model = self._module_model(module)
        # `from . import flightrec` / `import horovod_tpu_torch.obs.flightrec
        # as fr` — match the trailing module-name segment against the
        # analyzed relpaths.
        target = None
        if alias in model.from_imports:
            _, orig = model.from_imports[alias]
            target = orig
        elif alias in model.module_aliases:
            target = model.module_aliases[alias].rsplit(".", 1)[-1]
        if target is None:
            return None
        for relpath in self.by_module:
            if relpath.endswith(f"/{target}.py") or relpath == f"{target}.py":
                return relpath
        return None

    def _resolve_import(self, module: str,
                        origin: Tuple[str, str]) -> List[Tuple[str, str]]:
        _, name = origin
        out = []
        for relpath in self.by_module:
            if (relpath, name) in self.funcs:
                out.append((relpath, name))
        return out

    # -- fixpoint closure --------------------------------------------------

    def close_summaries(self) -> None:
        """Propagate all_locks / may_block over calls to a fixpoint."""
        for key, s in self.summaries.items():
            s.all_locks = {ls.lock_id for ls in s.locks}
            s.may_block = {b.what: "directly" for b in s.blocking}
        changed = True
        rounds = 0
        while changed and rounds < 50:
            changed = False
            rounds += 1
            for key, info in self.funcs.items():
                s = self.summaries[key]
                for call in info.calls:
                    for callee_key in self.resolve(key, call):
                        if callee_key == key:
                            continue
                        cs = self.summaries[callee_key]
                        if not cs.all_locks <= s.all_locks:
                            s.all_locks |= cs.all_locks
                            changed = True
                        for what, _via in cs.may_block.items():
                            if what not in s.may_block:
                                s.may_block[what] = (
                                    f"via {cs.qualname}() "
                                    f"[{cs.module}]"
                                )
                                changed = True

    def callees_in_region(
        self, caller: Tuple[str, str], region: List[ast.AST]
    ) -> List[Tuple[str, str]]:
        """Resolved callees for the calls lexically inside a region."""
        env = self.funcs[caller].type_env
        out: List[Tuple[str, str]] = []
        for node in region:
            if not isinstance(node, ast.Call):
                continue
            out.extend(
                self.resolve(caller, astutil.call_descriptor(node, env))
            )
        return out


# One closed CallGraph per analyzed model set, shared by every project
# rule family (concurrency, mesh-taint, determinism): building it means
# re-indexing every function in every file, so paying that once per run
# instead of once per family halves the full-surface wall clock.
# Keyed by content, not object identity: id() can be recycled across
# analyze_paths() calls and would hand a stale graph to fresh models.
_GRAPH_CACHE: Dict[tuple, CallGraph] = {}


def shared_callgraph(models: List[ModuleModel]) -> CallGraph:
    key = tuple((m.relpath, hash(m.source)) for m in models)
    g = _GRAPH_CACHE.get(key)
    if g is None:
        _GRAPH_CACHE.clear()
        g = CallGraph(models)
        g.close_summaries()
        _GRAPH_CACHE[key] = g
    return g
