"""Interprocedural rank-taint engine (the HVD010/HVD013 substrate).

The module-local SPMD rules judge one function at a time: ``if rank() == 0:
allreduce(x)`` fires, but the same bug split across a call boundary —

    r = hvd.rank()
    helper(r)                       # caller taints the argument

    def helper(flag):
        if flag == 0:               # helper can't see where flag came from
            dist.all_reduce(x, group=group_of_axis(LOCAL_AXIS))

— is invisible, and the codebase is now full of helpers like that
(bucket reducers, parallel schedules, serve schedulers).  Following
RacerD (Blackshear et al., 2018) this module stays compositional: ONE
pass per function produces a small, serializable summary — which
values are tainted, what the function returns, which collectives sit
under tainted guards, every outgoing call with per-argument taint —
and a closure over the existing lockgraph call graph stitches the
summaries without whole-program dataflow.  Per-axis-scope taint (the
mesh-aware part, :mod:`meshmodel`) is what keeps subgroup reasoning
sound: ``cross_rank()`` taint is harmless around a LOCAL_AXIS
collective and fatal around a CROSS_AXIS one.

Summaries are plain dicts end to end so the per-file analysis cache
(:mod:`cache`) can persist them keyed by content hash.

Stdlib-only, like the rest of the package.
"""

from __future__ import annotations

import ast
import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import astutil, meshmodel
from .core import ModuleModel
from .lockgraph import CallGraph

# Bounds (RacerD lesson: predictable cost beats completeness).
_MAX_CALL_DEPTH = 4      # nested-call taint recording inside one expr
_MAX_RESOLVE_DEPTH = 5   # cross-function closure recursion
_MAX_HAZARD_HOPS = 4     # param-hazard propagation up the call graph


# ---------------------------------------------------------------------------
# value taint
# ---------------------------------------------------------------------------


@dataclass
class ValueTaint:
    """Taint of one value, before closure.

    ``scopes`` are facts (a rank source reached this value), ``params``
    and ``calls`` are promises resolved against the call graph later:
    the value inherits whatever taint the named caller-parameter or the
    named callee's return value turns out to carry.  ``sanitized``
    records axes a collective laundered downstream of the promises —
    when a promise later binds to concrete taint, matching scopes are
    filtered out (``psum(flag, A)`` makes a rank-tainted ``flag``
    uniform along A even though the taint arrived via a parameter).
    """

    scopes: Dict[str, str] = field(default_factory=dict)   # scope -> witness
    params: Dict[int, str] = field(default_factory=dict)   # index -> name
    calls: List["CallSite"] = field(default_factory=list)
    sanitized: Set[str] = field(default_factory=set)

    def merge(self, other: "ValueTaint") -> None:
        # Merging two values (e.g. `a + b`): an axis is only laundered
        # for the merged value if BOTH sides laundered it — but a side
        # with no promises at all imposes no constraint.  Judged on the
        # PRE-merge state: once other's promises land in self, "did
        # self bring promises of its own" is no longer answerable.
        had_promises = bool(self.params or self.calls or self.sanitized)
        for s, w in other.scopes.items():
            self.scopes.setdefault(s, w)
        for i, n in other.params.items():
            self.params.setdefault(i, n)
        self.calls.extend(other.calls)
        if other.params or other.calls or other.sanitized:
            if had_promises:
                self.sanitized &= other.sanitized
            else:
                self.sanitized = set(other.sanitized)

    def is_empty(self) -> bool:
        return not (self.scopes or self.params or self.calls)

    def drop_scopes(self, axes: Sequence[str]) -> "ValueTaint":
        """Sanitizer application: a collective result is uniform along
        its reduced axes — matching scoped taint is laundered.  A WORLD
        sanitizer (allreduce/broadcast result) clears everything,
        promises included: whatever flowed in, the result is identical
        on every rank."""
        if meshmodel.WORLD in axes:
            return ValueTaint()
        return ValueTaint(
            scopes={s: w for s, w in self.scopes.items() if s not in axes},
            params=dict(self.params),
            calls=list(self.calls),
            sanitized=self.sanitized | set(axes),
        )

    def as_dict(self) -> dict:
        return {
            "scopes": dict(self.scopes),
            "params": {str(i): n for i, n in self.params.items()},
            "calls": [c.as_dict() for c in self.calls],
            "sanitized": sorted(self.sanitized),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ValueTaint":
        return cls(
            scopes=dict(d.get("scopes", {})),
            params={int(i): n for i, n in d.get("params", {}).items()},
            calls=[CallSite.from_dict(c) for c in d.get("calls", [])],
            sanitized=set(d.get("sanitized", [])),
        )


@dataclass
class CallSite:
    """One outgoing call with the taint of every argument — enough to
    bind the callee's parameters at closure time without re-reading the
    caller's AST."""

    kind: str                 # astutil.call_descriptor kind
    target: object            # its data (str or [cls, name] pair)
    line: int
    args: List[ValueTaint] = field(default_factory=list)
    kwargs: Dict[str, ValueTaint] = field(default_factory=dict)

    @property
    def desc(self) -> Tuple[str, object]:
        t = self.target
        return (self.kind, tuple(t) if isinstance(t, list) else t)

    def display(self) -> str:
        t = self.target
        if isinstance(t, (list, tuple)):
            return ".".join(str(p) for p in t)
        return str(t)

    def as_dict(self) -> dict:
        return {
            "kind": self.kind,
            "target": list(self.target)
            if isinstance(self.target, (list, tuple)) else self.target,
            "line": self.line,
            "args": [a.as_dict() for a in self.args],
            "kwargs": {k: v.as_dict() for k, v in self.kwargs.items()},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CallSite":
        return cls(
            kind=d["kind"], target=d["target"], line=d["line"],
            args=[ValueTaint.from_dict(a) for a in d.get("args", [])],
            kwargs={k: ValueTaint.from_dict(v)
                    for k, v in d.get("kwargs", {}).items()},
        )


@dataclass
class GuardedCollective:
    """A collective lexically reachable only under tainted control flow."""

    name: str
    axes: List[str]
    line: int
    col: int
    guard_line: int
    taint: ValueTaint
    eager_world: bool   # hvd.* world surface (HVD001's beat for direct hits)

    def as_dict(self) -> dict:
        return {
            "name": self.name, "axes": list(self.axes), "line": self.line,
            "col": self.col, "guard_line": self.guard_line,
            "taint": self.taint.as_dict(), "eager_world": self.eager_world,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "GuardedCollective":
        return cls(
            name=d["name"], axes=list(d["axes"]), line=d["line"],
            col=d["col"], guard_line=d["guard_line"],
            taint=ValueTaint.from_dict(d["taint"]),
            eager_world=bool(d.get("eager_world")),
        )


@dataclass
class GuardedTraceEmit:
    """A trace-span emission under tainted control flow (HVD013)."""

    name: str
    line: int
    col: int
    guard_line: int
    taint: ValueTaint

    def as_dict(self) -> dict:
        return {"name": self.name, "line": self.line, "col": self.col,
                "guard_line": self.guard_line,
                "taint": self.taint.as_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "GuardedTraceEmit":
        return cls(name=d["name"], line=d["line"], col=d["col"],
                   guard_line=d["guard_line"],
                   taint=ValueTaint.from_dict(d["taint"]))


@dataclass
class FuncTaint:
    """One function's compositional taint summary."""

    qualname: str
    module: str
    line: int
    param_names: List[str]
    ret: ValueTaint
    guards: List[GuardedCollective]
    trace_emits: List[GuardedTraceEmit]
    calls: List[CallSite]      # EVERY outgoing call (hazard propagation)
    sampled_args: List[Tuple[int, ValueTaint]]  # line, arg taint to sampled()

    def as_dict(self) -> dict:
        return {
            "qualname": self.qualname, "module": self.module,
            "line": self.line, "param_names": list(self.param_names),
            "ret": self.ret.as_dict(),
            "guards": [g.as_dict() for g in self.guards],
            "trace_emits": [t.as_dict() for t in self.trace_emits],
            "calls": [c.as_dict() for c in self.calls],
            "sampled_args": [[ln, vt.as_dict()]
                             for ln, vt in self.sampled_args],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FuncTaint":
        return cls(
            qualname=d["qualname"], module=d["module"], line=d["line"],
            param_names=list(d["param_names"]),
            ret=ValueTaint.from_dict(d["ret"]),
            guards=[GuardedCollective.from_dict(g) for g in d["guards"]],
            trace_emits=[GuardedTraceEmit.from_dict(t)
                         for t in d.get("trace_emits", [])],
            calls=[CallSite.from_dict(c) for c in d["calls"]],
            sampled_args=[(ln, ValueTaint.from_dict(vt))
                          for ln, vt in d.get("sampled_args", [])],
        )


# ---------------------------------------------------------------------------
# per-function local analysis
# ---------------------------------------------------------------------------

# Span-emission surface whose reachability must be rank-uniform per
# trace id (the tracing contract: a sampled request's spans exist on ALL
# ranks or NONE).
TRACE_EMIT_NAMES: Set[str] = {"add_span", "span"}


class _FunctionTainter:
    """Single forward pass over one function body (nested defs
    excluded — they get their own summaries)."""

    def __init__(self, model: ModuleModel, func: ast.AST, qualname: str):
        self.model = model
        self.func = func
        self.qualname = qualname
        args = getattr(func, "args", None)
        names: List[str] = []
        if args is not None:
            names = [a.arg for a in
                     args.posonlyargs + args.args + args.kwonlyargs]
        self.param_names = names
        self.env: Dict[str, ValueTaint] = {
            n: ValueTaint(params={i: n})
            for i, n in enumerate(names) if n not in ("self", "cls")
        }
        self.ret = ValueTaint()
        self.guards: List[GuardedCollective] = []
        self.trace_emits: List[GuardedTraceEmit] = []
        self.calls: List[CallSite] = []
        self.sampled_args: List[Tuple[int, ValueTaint]] = []
        self._guard_stack: List[Tuple[int, ValueTaint]] = []
        self._seen_calls: Set[int] = set()

    # -- expression taint --------------------------------------------------

    def expr_taint(self, node: Optional[ast.expr],
                   depth: int = 0) -> ValueTaint:
        out = ValueTaint()
        if node is None:
            return out
        src = meshmodel.source_scope(node)
        if src is not None:
            scope, witness = src
            out.scopes[scope] = f"{witness} (line {node.lineno})"
            return out
        if isinstance(node, ast.Name):
            hit = self.env.get(node.id)
            if hit is not None:
                out.merge(hit)
            return out
        if isinstance(node, ast.Call):
            sanitized = meshmodel.sanitizer_axes(node, self.model)
            inner = ValueTaint()
            for a in node.args:
                inner.merge(self.expr_taint(a, depth + 1))
            for kw in node.keywords:
                inner.merge(self.expr_taint(kw.value, depth + 1))
            if sanitized is not None:
                return inner.drop_scopes(sanitized)
            # Unresolved call: its result may carry the callee's taint.
            if depth < _MAX_CALL_DEPTH:
                site = self._record_call(node, register=False)
                if site is not None:
                    out.calls.append(site)
            out.merge(ValueTaint(scopes=inner.scopes,
                                 params=inner.params))
            # Args' own call-promises matter for the RESULT only via the
            # callee's param binding (already inside `site`); keeping
            # them here too would double-resolve, so they are dropped.
            return out
        # Anything composite: union of children.
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                out.merge(self.expr_taint(child, depth + 1))
        return out

    def _record_call(self, node: ast.Call,
                     register: bool = True) -> Optional[CallSite]:
        kind, data = astutil.call_descriptor(node, {})
        if kind == "attr" and not data:
            return None
        site = CallSite(
            kind=kind,
            target=list(data) if isinstance(data, tuple) else data,
            line=node.lineno,
            args=[self.expr_taint(a, 1) for a in node.args],
            kwargs={kw.arg: self.expr_taint(kw.value, 1)
                    for kw in node.keywords if kw.arg is not None},
        )
        if register:
            self.calls.append(site)
        return site

    def _current_guard(self) -> Optional[Tuple[int, ValueTaint]]:
        if not self._guard_stack:
            return None
        line = self._guard_stack[-1][0]
        merged = ValueTaint()
        for _, t in self._guard_stack:
            merged.merge(t)
        return line, merged

    # -- statement walk ----------------------------------------------------

    def run(self) -> FuncTaint:
        self._walk_body(list(getattr(self.func, "body", [])))
        return FuncTaint(
            qualname=self.qualname, module=self.model.relpath,
            line=getattr(self.func, "lineno", 1),
            param_names=self.param_names, ret=self.ret,
            guards=self.guards, trace_emits=self.trace_emits,
            calls=self.calls, sampled_args=self.sampled_args,
        )

    def _walk_body(self, stmts: List[ast.stmt]) -> None:
        pushed = 0
        for stmt in stmts:
            if (
                isinstance(stmt, ast.If)
                and not stmt.orelse
                and _ends_in_exit(stmt.body)
            ):
                taint = self._test_taint(stmt.test)
                if not taint.is_empty():
                    # `if tainted: return` — the rest of this block runs
                    # on a taint-chosen subset.
                    self._guard_stack.append((stmt.lineno, taint))
                    pushed += 1
                    self._walk_body(stmt.body)
                    continue
            self._walk_stmt(stmt)
        for _ in range(pushed):
            self._guard_stack.pop()

    def _test_taint(self, test: ast.expr) -> ValueTaint:
        if astutil.is_rank_uniform_test(test):
            return ValueTaint()
        return self.expr_taint(test)

    def _walk_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # own summary
        if isinstance(stmt, ast.Assign):
            taint = self.expr_taint(stmt.value)
            self._scan_exprs(stmt.value)
            for target in stmt.targets:
                self._bind(target, taint)
            return
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            taint = self.expr_taint(stmt.value)
            self._scan_exprs(stmt.value)
            self._bind(stmt.target, taint)
            return
        if isinstance(stmt, ast.AugAssign):
            taint = self.expr_taint(stmt.value)
            self._scan_exprs(stmt.value)
            if isinstance(stmt.target, ast.Name):
                prev = self.env.setdefault(stmt.target.id, ValueTaint())
                prev.merge(taint)
            return
        if isinstance(stmt, ast.Return):
            self.ret.merge(self.expr_taint(stmt.value))
            self._scan_exprs(stmt.value)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            taint = self._test_taint(stmt.test)
            self._scan_exprs(stmt.test)
            if not taint.is_empty():
                self._guard_stack.append((stmt.lineno, taint))
                self._walk_body(stmt.body)
                self._walk_body(stmt.orelse)
                self._guard_stack.pop()
            else:
                self._walk_body(stmt.body)
                self._walk_body(stmt.orelse)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            taint = self.expr_taint(stmt.iter)
            self._scan_exprs(stmt.iter)
            self._bind(stmt.target, taint)
            self._walk_body(stmt.body)
            self._walk_body(stmt.orelse)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._scan_exprs(item.context_expr)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars,
                               self.expr_taint(item.context_expr))
            self._walk_body(stmt.body)
            return
        if isinstance(stmt, ast.Try):
            self._walk_body(stmt.body)
            for handler in stmt.handlers:
                self._walk_body(handler.body)
            self._walk_body(stmt.orelse)
            self._walk_body(stmt.finalbody)
            return
        # Expression statements and everything else: scan for calls.
        self._scan_exprs(stmt)
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            # dist.all_reduce(flag): flag is uniform from here on
            hit = meshmodel.inplace_sanitized(stmt.value, self.model)
            if hit is not None and hit[0] in self.env:
                self.env[hit[0]] = self.env[hit[0]].drop_scopes(hit[1])

    def _bind(self, target: ast.expr, taint: ValueTaint) -> None:
        """Assignment targets inherit the value's taint.  Tuple targets
        each get the WHOLE taint — a rank carried inside a returned
        tuple must not launder through unpacking."""
        if isinstance(target, ast.Name):
            self.env[target.id] = taint
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, taint)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, taint)
        # Attribute/Subscript targets: no env entry (conservatively
        # quiet — tracking self.* would need aliasing).

    def _scan_exprs(self, node: Optional[ast.AST]) -> None:
        """Record call sites + guarded collectives/trace-emits inside a
        statement or expression subtree (deduped: a call reached via
        two statement paths is recorded once)."""
        if node is None:
            return
        for call in astutil.iter_calls(node):
            if id(call) in self._seen_calls:
                continue
            self._seen_calls.add(id(call))
            self._record_call(call)
            self._observe_call(call)

    def _observe_call(self, call: ast.Call) -> None:
        guard = self._current_guard()
        name = astutil.call_name(call)
        axes = meshmodel.collective_axes(call, self.model)
        if axes is not None and guard is not None:
            self.guards.append(GuardedCollective(
                name=name or "<collective>", axes=axes,
                line=call.lineno, col=call.col_offset,
                guard_line=guard[0], taint=guard[1],
                eager_world=astutil.is_collective_call(call, self.model),
            ))
        if name in TRACE_EMIT_NAMES and guard is not None:
            self.trace_emits.append(GuardedTraceEmit(
                name=name, line=call.lineno, col=call.col_offset,
                guard_line=guard[0], taint=guard[1],
            ))
        if name == "sampled" and (call.args or call.keywords):
            merged = ValueTaint()
            for a in call.args:
                merged.merge(self.expr_taint(a, 1))
            for kw in call.keywords:
                merged.merge(self.expr_taint(kw.value, 1))
            # Drop call-promises: a helper() feeding sampled() is judged
            # by HVD013 only on facts, not maybes.
            merged.calls = []
            if not merged.is_empty():
                self.sampled_args.append((call.lineno, merged))


def _ends_in_exit(body: List[ast.stmt]) -> bool:
    if not body:
        return False
    last = body[-1]
    if isinstance(last, (ast.Return, ast.Continue, ast.Break, ast.Raise)):
        return True
    if isinstance(last, ast.Expr) and isinstance(last.value, ast.Call):
        return astutil.call_name(last.value) in ("exit", "_exit", "abort")
    return False


def summarize_module_taint(model: ModuleModel) -> Dict[str, FuncTaint]:
    """qualname -> FuncTaint for every def in the file (qualnames via
    :func:`astutil.iter_defs`, the same convention the call graph keys
    on — summaries stitch by these names)."""
    return {
        qn: _FunctionTainter(model, node, qn).run()
        for qn, node in astutil.iter_defs(model.tree)
    }


# In-memory content-hash memo for the local phase.  The on-disk cache
# (:mod:`cache`) pre-seeds and drains this dict, so a warm run skips
# the per-function walk entirely for unchanged files.
_SUMMARY_MEMO: Dict[str, Dict[str, FuncTaint]] = {}
_SUMMARY_MEMO_MAX = 4096


def content_key(source: str) -> str:
    return hashlib.sha256(source.encode("utf-8", "replace")).hexdigest()


def module_taint_cached(model: ModuleModel) -> Dict[str, FuncTaint]:
    key = content_key(model.source)
    hit = _SUMMARY_MEMO.get(key)
    if hit is not None:
        return hit
    sums = summarize_module_taint(model)
    if len(_SUMMARY_MEMO) >= _SUMMARY_MEMO_MAX:
        _SUMMARY_MEMO.clear()
    _SUMMARY_MEMO[key] = sums
    return sums


def seed_summary_memo(key: str, raw: Dict[str, dict]) -> None:
    """Install deserialized summaries (cache load path)."""
    try:
        _SUMMARY_MEMO[key] = {
            qn: FuncTaint.from_dict(d) for qn, d in raw.items()
        }
    except (KeyError, TypeError, ValueError):
        pass  # stale/foreign cache entry: recompute instead


def dump_summary_memo(key: str) -> Optional[Dict[str, dict]]:
    hit = _SUMMARY_MEMO.get(key)
    if hit is None:
        return None
    return {qn: ft.as_dict() for qn, ft in hit.items()}


# ---------------------------------------------------------------------------
# project closure
# ---------------------------------------------------------------------------


@dataclass
class ResolvedScope:
    """One closed taint fact: scope + where it came from."""

    scope: str
    witness: str
    chain: Tuple[str, ...]   # call-chain attribution, caller-first


class ProjectTaint:
    """Summaries for the whole analyzed set, closed over the call graph."""

    def __init__(self, models: List[ModuleModel],
                 graph: Optional[CallGraph] = None,
                 precomputed: Optional[
                     Dict[str, Dict[str, FuncTaint]]] = None):
        self.models = models
        self.graph = graph or CallGraph(models)
        self.funcs: Dict[Tuple[str, str], FuncTaint] = {}
        for model in models:
            ready = (precomputed or {}).get(model.relpath)
            sums = ready if ready is not None \
                else module_taint_cached(model)
            for qn, ft in sums.items():
                self.funcs[(model.relpath, qn)] = ft
        self._ret_cache: Dict[Tuple[str, str], List[ResolvedScope]] = {}

    # -- return-taint closure ---------------------------------------------

    def return_scopes(self, key: Tuple[str, str],
                      depth: int = 0,
                      _active: Optional[Set[Tuple[str, str]]] = None
                      ) -> List[ResolvedScope]:
        """Closed rank-taint scopes of ``key``'s return value, with the
        producing chain.  Parameter promises stay open here (they bind
        at a concrete call site via :meth:`resolve_value`)."""
        if key in self._ret_cache:
            return self._ret_cache[key]
        ft = self.funcs.get(key)
        if ft is None or depth > _MAX_RESOLVE_DEPTH:
            return []
        active = _active or set()
        if key in active:
            return []  # recursion: stop, facts already counted once
        out = self.resolve_value(
            ft.ret, key, depth=depth, _active=active | {key},
        )
        if depth == 0:
            self._ret_cache[key] = out
        return out

    def resolve_value(self, vt: ValueTaint, caller: Tuple[str, str],
                      binding: Optional[Dict[int, List[ResolvedScope]]]
                      = None,
                      depth: int = 0,
                      _active: Optional[Set[Tuple[str, str]]] = None,
                      ) -> List[ResolvedScope]:
        """Close one ValueTaint: direct scopes, bound parameters, and
        callee returns (transitively)."""
        out: List[ResolvedScope] = []
        seen: Set[Tuple[str, str]] = set()

        def emit(scope: str, witness: str,
                 chain: Tuple[str, ...]) -> None:
            if (scope, witness) in seen:
                return
            seen.add((scope, witness))
            out.append(ResolvedScope(scope, witness, chain))

        for scope, witness in vt.scopes.items():
            emit(scope, witness, ())
        if binding:
            for idx in vt.params:
                for rs in binding.get(idx, []):
                    if rs.scope in vt.sanitized:
                        continue  # laundered by a collective downstream
                    emit(rs.scope, rs.witness, rs.chain)
        if depth >= _MAX_RESOLVE_DEPTH:
            return out
        for site in vt.calls:
            for callee in self.graph.resolve(caller, site.desc):
                callee_ft = self.funcs.get(callee)
                if callee_ft is None:
                    continue
                sub_binding = self._bind_args(site, callee_ft, caller,
                                              depth, _active)
                for rs in self.return_scopes(
                    callee, depth=depth + 1, _active=_active,
                ):
                    if rs.scope in vt.sanitized:
                        continue
                    emit(rs.scope, rs.witness,
                         (_disp(callee),) + rs.chain)
                # Param-flows-to-return: callee returns its own param.
                ret_params = callee_ft.ret.params
                if ret_params and sub_binding:
                    for idx in ret_params:
                        for rs in sub_binding.get(idx, []):
                            if rs.scope in vt.sanitized or \
                                    rs.scope in callee_ft.ret.sanitized:
                                continue
                            emit(rs.scope, rs.witness,
                                 (_disp(callee),) + rs.chain)
        return out

    def _bind_args(self, site: CallSite, callee: FuncTaint,
                   caller: Tuple[str, str], depth: int,
                   _active: Optional[Set[Tuple[str, str]]],
                   ) -> Dict[int, List[ResolvedScope]]:
        """Map callee parameter index -> resolved taint of the argument
        the caller passes there (positional and keyword)."""
        params = callee.param_names
        offset = 1 if params and params[0] in ("self", "cls") else 0
        binding: Dict[int, List[ResolvedScope]] = {}
        for i, arg in enumerate(site.args):
            if arg.is_empty():
                continue
            binding[i + offset] = self.resolve_value(
                arg, caller, depth=depth + 1, _active=_active,
            )
        for kw_name, arg in site.kwargs.items():
            if arg.is_empty() or kw_name not in params:
                continue
            binding[params.index(kw_name)] = self.resolve_value(
                arg, caller, depth=depth + 1, _active=_active,
            )
        return {i: v for i, v in binding.items() if v}


def _disp(key: Tuple[str, str]) -> str:
    return f"{key[1]} [{key[0]}]"


# ---------------------------------------------------------------------------
# findings substrate: guarded collectives, closed
# ---------------------------------------------------------------------------


@dataclass
class DivergentCollective:
    """One closed HVD010 hit, ready for the rule to format."""

    module: str
    function: str       # where the collective lives
    name: str
    axes: List[str]
    line: int
    col: int
    guard_line: int
    scope: str
    witness: str
    chain: Tuple[str, ...]   # producing call chain (empty = same function)
    via_param: Optional[str]  # parameter name the taint entered through
    eager_world: bool
    direct: bool             # taint fully visible inside the function


@dataclass
class _Hazard:
    """A guarded collective whose guard depends on a parameter: the
    finding fires at whatever call site binds that parameter to a
    divergent value.  ``owner`` is the function holding the collective
    (the finding anchors there); ``hops`` is the forwarding chain built
    as the hazard climbs through callers that pass their own params;
    ``sanitized`` carries axes a collective laundered between the
    parameter and the guard — taint scoped to those axes is uniform by
    the time it reaches the branch and must not convict the caller."""

    guard: GuardedCollective
    owner: Tuple[str, str]
    hops: Tuple[str, ...]
    param_name: str
    sanitized: frozenset = frozenset()


def divergent_collectives(pt: ProjectTaint) -> List[DivergentCollective]:
    """Every guarded collective whose guard taint can differ within the
    collective's group — intraprocedural facts first, then parameter
    hazards propagated up the call graph to the sites that actually
    pass tainted values in."""
    out: List[DivergentCollective] = []
    hazards: Dict[Tuple[Tuple[str, str], int], List[_Hazard]] = {}

    for key, ft in pt.funcs.items():
        for g in ft.guards:
            for rs in pt.resolve_value(g.taint, key):
                if not meshmodel.diverges(rs.scope, g.axes):
                    continue
                out.append(DivergentCollective(
                    module=key[0], function=ft.qualname, name=g.name,
                    axes=g.axes, line=g.line, col=g.col,
                    guard_line=g.guard_line, scope=rs.scope,
                    witness=rs.witness, chain=rs.chain, via_param=None,
                    eager_world=g.eager_world, direct=not rs.chain,
                ))
            for idx, pname in g.taint.params.items():
                hazards.setdefault((key, idx), []).append(
                    _Hazard(g, key, (_disp(key),), pname,
                            frozenset(g.taint.sanitized))
                )

    # Propagate parameter hazards to call sites (bounded hops: a caller
    # passing its OWN param forwards the hazard up one more level).
    for _hop in range(_MAX_HAZARD_HOPS):
        if not hazards:
            break  # clean tree: skip the full call-resolution sweep
        new_hazards: Dict[Tuple[Tuple[str, str], int],
                          List[_Hazard]] = {}
        for caller_key, ft in pt.funcs.items():
            for site in ft.calls:
                for callee in pt.graph.resolve(caller_key, site.desc):
                    if callee == caller_key:
                        continue
                    callee_ft = pt.funcs.get(callee)
                    if callee_ft is None:
                        continue
                    params = callee_ft.param_names
                    offset = 1 if params and params[0] in ("self", "cls") \
                        else 0
                    bound: List[Tuple[int, ValueTaint]] = [
                        (i + offset, a) for i, a in enumerate(site.args)
                    ] + [
                        (params.index(k), a)
                        for k, a in site.kwargs.items() if k in params
                    ]
                    for idx, arg in bound:
                        for hz in hazards.get((callee, idx), ()):
                            g = hz.guard
                            for rs in pt.resolve_value(arg, caller_key):
                                if rs.scope in hz.sanitized:
                                    continue  # laundered en route
                                if not meshmodel.diverges(rs.scope,
                                                          g.axes):
                                    continue
                                out.append(DivergentCollective(
                                    module=hz.owner[0],
                                    function=hz.owner[1],
                                    name=g.name, axes=g.axes,
                                    line=g.line, col=g.col,
                                    guard_line=g.guard_line,
                                    scope=rs.scope, witness=rs.witness,
                                    chain=(_disp(caller_key),)
                                    + rs.chain + hz.hops,
                                    via_param=hz.param_name,
                                    eager_world=g.eager_world,
                                    direct=False,
                                ))
                            # Caller forwards its own parameter: the
                            # hazard climbs one level.
                            for pidx, ppname in arg.params.items():
                                new_hazards.setdefault(
                                    (caller_key, pidx), []
                                ).append(_Hazard(
                                    g, hz.owner,
                                    (_disp(caller_key),) + hz.hops,
                                    ppname,
                                    hz.sanitized
                                    | frozenset(arg.sanitized),
                                ))
        if not new_hazards:
            break
        hazards = new_hazards
    # De-dup: the same collective+scope can surface through both a
    # positional and a keyword binding of the same call site.
    seen: Set[Tuple] = set()
    uniq: List[DivergentCollective] = []
    for d in out:
        k = (d.module, d.line, d.col, d.scope, d.chain, d.via_param)
        if k in seen:
            continue
        seen.add(k)
        uniq.append(d)
    return uniq
