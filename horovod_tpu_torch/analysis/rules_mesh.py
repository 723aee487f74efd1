"""Mesh-aware SPMD rules (HVD010–HVD013).

The two-level reductions, the bucket collectives, the parallel
schedules and the serving plane all run collectives over *named axis
subgroups* (``group=group_of_axis(A)`` in the port).  Rank
divergence **within** one of those groups is the same deadlock class
HVD001 rejects for the world — but judging it takes the mesh model
(which axis does this taint vary along? which group does this
collective synchronize?) and the interprocedural taint engine (the
rank read and the collective are rarely in the same function anymore).

Rules here:

* **HVD010** — collective over axis A reachable only under control
  flow tainted with scope S where S diverges within an A-group.
  Interprocedural: the taint may arrive through arguments or returned
  values across several call frames; findings carry the call chain.
* **HVD011** — one collective call site whose axis-name argument can
  evaluate to different axis sets (ternary / boolean selection /
  conflicting assignments): ranks disagreeing about the selector
  submit collectives over *different groups* and both sides hang.
* **HVD012** — impure inputs (clock, random, unordered set iteration,
  rank reads) inside or flowing into a function bound by a determinism
  contract (the serve scheduler's purity invariant, the trace sampler,
  or any ``# hvdtpu: deterministic`` annotation).
* **HVD013** — rank taint reaching a trace/sampling decision: span
  emission guarded by rank-divergent state, or a rank-derived value in
  ``sampled(...)`` arguments (the tracing contract: a sampled request's
  spans exist on ALL ranks or NONE).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from . import astutil, lockgraph, meshmodel, taint
from .core import ModuleModel, SEV_ERROR, SEV_WARNING, Finding
from .registry import make_finding, rule

# ---------------------------------------------------------------------------
# shared project analysis (HVD010 + HVD012 both need the closed graph;
# build it once per analyze_paths() model set)
# ---------------------------------------------------------------------------

# Keyed by the model-list object itself (the stored reference keeps the
# list alive, so an id() collision with a dead list is impossible).
_PROJECT_MEMO: List[Tuple[List[ModuleModel], taint.ProjectTaint]] = []
_PROJECT_MEMO_MAX = 2


def _project(models: List[ModuleModel]) -> taint.ProjectTaint:
    for held, pt in _PROJECT_MEMO:
        if held is models:
            return pt
    # Reuse the concurrency family's closed call graph — building one
    # re-indexes every function in every file, the priciest pass.
    pt = taint.ProjectTaint(models, graph=lockgraph.shared_callgraph(models))
    _PROJECT_MEMO.append((models, pt))
    del _PROJECT_MEMO[:-_PROJECT_MEMO_MAX]
    return pt


def _model_by_relpath(models: List[ModuleModel]
                      ) -> Dict[str, ModuleModel]:
    return {m.relpath: m for m in models}


# ---------------------------------------------------------------------------
# HVD010 — axis-scoped taint guards a collective over that axis
# ---------------------------------------------------------------------------


def _fmt_axes(axes: List[str]) -> str:
    return "/".join(sorted(set(axes)))


@rule("HVD010", "subgroup-divergent-collective", SEV_ERROR,
      "collective over axis A guarded by rank taint scoped to A "
      "(interprocedural)", scope="project")
def hvd010(models: List[ModuleModel]) -> List[Finding]:
    """A collective whose submission is conditional on a value that
    differs *within the collective's own group* deadlocks that group:
    some members submit, the rest never arrive.  The mesh-aware part is
    the scope judgement — ``cross_rank()`` taint is uniform inside a
    LOCAL_AXIS group (safe) and divergent inside a CROSS_AXIS one
    (fatal) — and the taint engine part is that the rank read, the
    branch, and the collective may live in three different functions.

    Minimal failing example::

        def reduce_part(flag, x):
            if flag == 0:                    # caller passed rank taint
                return lax.psum(x, "hvd_local")
            return x

        def step(x):
            return reduce_part(hvd.local_rank(), x)   # taints `flag`

    Fix: hoist the collective out of the tainted branch (every group
    member submits; branch on the rank around *uses* of the result), or
    derive the condition from group-uniform state (a broadcast/allreduce
    result, ``size()`` probes).  A world allreduce/broadcast of the
    value launders the taint — its result is identical everywhere."""
    pt = _project(models)
    by_rel = _model_by_relpath(models)
    out: List[Finding] = []
    seen: Set[Tuple] = set()
    for d in taint.divergent_collectives(pt):
        model = by_rel.get(d.module)
        if model is None:
            continue
        if d.direct and d.eager_world \
                and d.axes == [meshmodel.WORLD]:
            # A same-function rank guard around an eager world
            # collective is HVD001's exact territory — one finding per
            # defect.
            continue
        key = (d.module, d.line, d.scope, d.chain, d.via_param)
        if key in seen:
            continue
        seen.add(key)
        axes = _fmt_axes(d.axes)
        if d.via_param is not None:
            chain = " -> ".join(d.chain)
            msg = (
                f"collective '{d.name}' over axis {axes!r} (line "
                f"{d.line}) is guarded (line {d.guard_line}) by "
                f"parameter {d.via_param!r}, which receives "
                f"{d.scope!r}-scoped rank taint ({d.witness}) via "
                f"{chain}: members of the same {axes} group disagree "
                f"about submitting and the group deadlocks"
            )
        elif d.chain:
            chain = " -> ".join(d.chain)
            msg = (
                f"collective '{d.name}' over axis {axes!r} is guarded "
                f"(line {d.guard_line}) by a value carrying "
                f"{d.scope!r}-scoped rank taint from {d.witness} "
                f"(through {chain}): the guard differs within the "
                f"{axes} group and the group deadlocks"
            )
        else:
            msg = (
                f"collective '{d.name}' over axis {axes!r} is guarded "
                f"(line {d.guard_line}) by {d.witness}, whose "
                f"{d.scope!r}-scoped value differs within the {axes} "
                f"group: members disagree about submitting and the "
                f"group deadlocks"
            )
        out.append(make_finding(
            "HVD010", model, d.line, d.col, msg, d.function,
        ))
    return out


# ---------------------------------------------------------------------------
# HVD011 — one call site, several possible axis sets
# ---------------------------------------------------------------------------


def _axis_expr_of(node: ast.Call,
                  model: ModuleModel) -> Optional[ast.expr]:
    """The axis-name argument expression of a recognized collective."""
    if meshmodel.collective_axes(node, model) is None:
        return None
    for kw in node.keywords:
        if kw.arg == "axis_name":
            return kw.value
        # dist.all_reduce(t, group=group_of_axis(axis)): the axis
        if kw.arg == "group" and isinstance(kw.value, ast.Call) and \
                astutil.call_name(kw.value) == "group_of_axis" and \
                kw.value.args and astutil.is_torch_dist_call(node, model):
            return kw.value.args[0]
    name = astutil.call_name(node)
    if name in meshmodel._LAX_COLLECTIVES and len(node.args) >= 2:
        return node.args[1]
    return None


def _selector_variants(expr: ast.expr) -> List[List[str]]:
    """Axis-token alternatives an axis expression can evaluate to.
    Returns >1 entries only for genuine runtime selection (ternary,
    ``or``-chains) — a tuple of axes is ONE hierarchical group spec,
    not a choice."""
    if isinstance(expr, ast.IfExp):
        return (_selector_variants(expr.body)
                + _selector_variants(expr.orelse))
    if isinstance(expr, ast.BoolOp):
        out: List[List[str]] = []
        for v in expr.values:
            out.extend(_selector_variants(v))
        return out
    return [meshmodel.axis_tokens(expr)]


@rule("HVD011", "mismatched-collective-axes", SEV_ERROR,
      "collective whose axis-name argument can denote different axis "
      "sets on the same dataflow path")
def hvd011(model: ModuleModel) -> List[Finding]:
    """A collective whose axis-name argument is *selected* at runtime
    (ternary, ``or`` fallback, or a variable assigned different axis
    constants on different paths) submits over different groups
    depending on the selector.  If ranks can disagree about the
    selector, one subset synchronizes the LOCAL group while another
    synchronizes CROSS — neither completes.  Even rank-uniform
    selection deserves a look: the two configurations issue different
    collective sequences, which the schedule gate
    (``analysis.schedule``) flags per config anyway.

    Minimal failing example::

        axis = "hvd_local" if fast_path else "hvd_cross"
        lax.psum(x, axis)        # two possible groups, one call site

    Fix: make the axis set a static property of the call site — two
    explicit branches each calling with a literal axis (HVD003/HVD010
    then judge the branch condition), or one hierarchical spec
    (``("hvd_local", "hvd_cross")`` is a single group, not a choice)."""
    out: List[Finding] = []
    fmap = astutil.enclosing_function_map(model)
    # (enclosing function, name) -> distinct axis-token sets assigned
    # there.  Scoped per function: two unrelated helpers each binding a
    # constant `axis = ...` of their own are two single-axis call
    # sites, not one divergent selector.
    assigned: Dict[Tuple[str, str],
                   List[Tuple[int, Tuple[str, ...]]]] = {}
    for node in ast.walk(model.tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            # A ternary/or-chain on the right-hand side contributes one
            # token set PER alternative — `axis = A if fast else B` is
            # already two groups at the assignment.
            scope_key = (fmap.get(node.lineno, ""),
                         node.targets[0].id)
            for variant in _selector_variants(node.value):
                toks = _variant_tokens(variant)
                if toks is not None:
                    assigned.setdefault(scope_key, []).append(
                        (node.lineno, toks)
                    )
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.Call):
            continue
        expr = _axis_expr_of(node, model)
        if expr is None:
            continue
        variants = _selector_variants(expr)
        token_sets = {tuple(sorted(set(v))) for v in variants}
        token_sets.discard((meshmodel.UNKNOWN_AXIS,))
        where = "selected inline"
        if len(token_sets) <= 1 and isinstance(expr, ast.Name):
            sites = assigned.get(
                (fmap.get(node.lineno, ""), expr.id), [])
            distinct = {t for _, t in sites}
            if len(distinct) > 1:
                token_sets = distinct
                lines = ", ".join(str(ln) for ln, _ in sites)
                where = f"assigned at lines {lines}"
        if len(token_sets) <= 1:
            continue
        name = astutil.call_name(node)
        pretty = " vs ".join(
            "/".join(t) or "?" for t in sorted(token_sets)
        )
        out.append(make_finding(
            "HVD011", model, node.lineno, node.col_offset,
            f"collective '{name}' has axis-name alternatives "
            f"({pretty}, {where}): ranks disagreeing about the "
            f"selector synchronize different groups and neither "
            f"completes — make the axis set static at this call site",
            astutil.context_for_line(model, node.lineno, fmap),
        ))
    return out


def _variant_tokens(toks: List[str]) -> Optional[Tuple[str, ...]]:
    if all(t == meshmodel.UNKNOWN_AXIS for t in toks):
        return None
    return tuple(sorted(set(toks)))


# ---------------------------------------------------------------------------
# HVD012 — impurity inside/into a deterministic contract
# ---------------------------------------------------------------------------


def _unordered_iter_reason(it: ast.expr) -> Optional[str]:
    """Iteration orders that differ across *processes* (PYTHONHASHSEED
    hash order, environment): poison for a deterministic scheduler.
    Dict views are exempt — insertion order is deterministic given the
    same input sequence, which is exactly what the contract demands."""
    if isinstance(it, ast.Set):
        return "a set literal"
    if isinstance(it, ast.Call):
        name = astutil.call_name(it)
        if name in ("set", "frozenset"):
            return f"a {name}() value"
        if name in ("vars", "globals", "locals"):
            return f"{name}()"
    if isinstance(it, ast.Attribute) and it.attr == "environ":
        return "os.environ"
    return None


def _direct_impurities(info: astutil.FunctionInfo,
                       model: ModuleModel) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    for call in astutil.own_calls(info.node):
        why = meshmodel.impurity_of_call(call, model)
        if why is not None:
            out.append((why, call.lineno))
    for node in _own_stmts(info.node):
        if isinstance(node, (ast.For, ast.AsyncFor)):
            reason = _unordered_iter_reason(node.iter)
            if reason is not None:
                out.append((f"iteration over {reason} "
                            f"(hash-order differs per process)",
                            node.lineno))
    return out


def _own_stmts(func: ast.AST) -> List[ast.AST]:
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


@rule("HVD012", "impure-deterministic-contract", SEV_ERROR,
      "clock/random/hash-order/rank input reaches a function bound by "
      "a determinism contract", scope="project")
def hvd012(models: List[ModuleModel]) -> List[Finding]:
    """Functions under a determinism contract — the serve scheduler
    (every rank must derive the identical admit/evict schedule from the
    same inputs), the trace sampler, anything marked ``# hvdtpu:
    deterministic`` — may compute only from their inputs.  A clock
    read, ``random``, set iteration (hash order differs per process),
    or a rank read anywhere in their call tree makes two ranks derive
    different schedules from identical inputs: the serving HVD001
    deadlock, entering through the side door.

    Minimal failing example::

        # hvdtpu: deterministic
        def pick_slot(queue, slots):
            return random.choice(slots)      # per-process RNG: diverges

    Fix: move the impurity to the caller and pass its result in as data
    (one rank decides, the broadcast schedule carries the decision), or
    derive it deterministically from the inputs (hash of the request
    id).  Iteration: sort before iterating."""
    pt = _project(models)
    graph = pt.graph
    out: List[Finding] = []
    by_rel = _model_by_relpath(models)

    # Contract surface first: impurity only matters where a contract
    # can reach it, so the closure explores forward from the contract
    # functions instead of fixpointing the whole graph (a whole-repo
    # fixpoint was ~half the project-rule wall clock for a handful of
    # contract functions).
    contract_keys: Set[Tuple[str, str]] = set()
    contract_lines: Dict[Tuple[str, str], int] = {}
    for model in models:
        for qn, def_line in meshmodel.contract_functions(model).items():
            contract_keys.add((model.relpath, qn))
            contract_lines[(model.relpath, qn)] = def_line

    impurity_memo: Dict[Tuple[str, str], List[Tuple[str, int]]] = {}

    def impurities_of(key: Tuple[str, str]) -> List[Tuple[str, int]]:
        hit = impurity_memo.get(key)
        if hit is None:
            info = graph.funcs.get(key)
            model = by_rel.get(key[0])
            hit = _direct_impurities(info, model) \
                if info is not None and model is not None else []
            impurity_memo[key] = hit
        return hit

    _MAX_CONTRACT_DEPTH = 6
    for ckey in sorted(contract_keys):
        model = by_rel.get(ckey[0])
        if model is None or ckey not in graph.funcs:
            continue
        qn = ckey[1]
        for what, line in impurities_of(ckey):
            out.append(make_finding(
                "HVD012", model, line, 0,
                f"{what} inside {qn}(), which is bound by a "
                f"determinism contract: its output must be a pure "
                f"function of its inputs on every rank — hoist the "
                f"impurity to the caller and pass the result in",
                qn,
            ))
        # BFS over callees: an impure helper anywhere in the contract
        # function's call tree is the same defect one hop removed.
        seen: Set[Tuple[str, str]] = {ckey}
        frontier: List[Tuple[str, str]] = [ckey]
        depth = 0
        while frontier and depth < _MAX_CONTRACT_DEPTH:
            depth += 1
            nxt: List[Tuple[str, str]] = []
            for key in frontier:
                info = graph.funcs.get(key)
                if info is None:
                    continue
                for call in info.calls:
                    for callee in graph.resolve(key, call):
                        if callee in seen:
                            continue
                        seen.add(callee)
                        nxt.append(callee)
                        for what, _ln in impurities_of(callee):
                            out.append(make_finding(
                                "HVD012", model,
                                contract_lines.get(ckey, 1), 0,
                                f"{qn}() is bound by a determinism "
                                f"contract but reaches {what} via "
                                f"{callee[1]}() [{callee[0]}]: two "
                                f"ranks can derive different schedules "
                                f"from identical inputs",
                                qn,
                            ))
            frontier = nxt

    # Call-site injection: an impure expression passed INTO a contract
    # function is the same defect seen from the caller.
    if contract_keys:
        for key, info in graph.funcs.items():
            model = by_rel.get(key[0])
            if model is None:
                continue
            fmap = None
            for call in astutil.own_calls(info.node):
                desc = astutil.call_descriptor(call, info.type_env)
                targets = graph.resolve(key, desc)
                if not any(t in contract_keys for t in targets):
                    continue
                for arg in list(call.args) + [
                    kw.value for kw in call.keywords
                ]:
                    for sub in astutil.iter_calls(arg):
                        why = meshmodel.impurity_of_call(sub, model)
                        if why is None:
                            continue
                        target = next(t for t in targets
                                      if t in contract_keys)
                        if fmap is None:
                            fmap = astutil.enclosing_function_map(model)
                        out.append(make_finding(
                            "HVD012", model, call.lineno,
                            call.col_offset,
                            f"{why} flows into {target[1]}() "
                            f"[{target[0]}], which is bound by a "
                            f"determinism contract: pass data every "
                            f"rank derives identically instead",
                            astutil.context_for_line(
                                model, call.lineno, fmap),
                        ))
    # One finding per (path, context, message-ish) — the closure can
    # reach the same impurity through several chains.
    seen: Set[Tuple[str, str, int, str]] = set()
    uniq: List[Finding] = []
    for f in out:
        # Full message, not a prefix: BFS findings share a long common
        # prefix ("{qn}() is bound by ... reaches"), and a truncated
        # key would collapse DISTINCT impurities reached from the same
        # contract function into one finding.
        k = (f.path, f.context, f.line, f.message)
        if k in seen:
            continue
        seen.add(k)
        uniq.append(f)
    return uniq


# ---------------------------------------------------------------------------
# HVD013 — taint in the tracing/sampling plane
# ---------------------------------------------------------------------------


@rule("HVD013", "rank-tainted-trace-decision", SEV_WARNING,
      "rank-derived value reaches a trace sampling/emission decision")
def hvd013(model: ModuleModel) -> List[Finding]:
    """The tracing contract: the sampling verdict is a pure
    function of (trace_id, rate), so a request's spans exist on ALL
    ranks or NONE and trace-merge's per-rank lanes line up.  Rank taint
    in a ``sampled(...)`` argument, or span emission guarded by a
    rank-divergent condition, produces traces where a request's story
    exists only on some ranks — the merged waterfall silently loses
    exactly the lanes a divergence investigation needs.

    Minimal failing example::

        if hvd.rank() == 0:            # only rank 0's lane exists
            trace.add_span(tid, "decode", t0, t1)

    Fix: emit unconditionally (every rank's lane matters — that is the
    point of the merge) and let the *deterministic* sampling verdict do
    the filtering; derive sampling inputs from the trace id, never the
    rank.  Per-rank file naming in the DUMP path is fine — it names
    the lane, it doesn't choose whether the lane exists."""
    out: List[Finding] = []
    fmap = astutil.enclosing_function_map(model)
    for qn, ft in taint.module_taint_cached(model).items():
        for te in ft.trace_emits:
            scopes = te.taint.scopes
            if not scopes:
                continue
            scope, witness = next(iter(scopes.items()))
            out.append(make_finding(
                "HVD013", model, te.line, te.col,
                f"span emission '{te.name}' is guarded (line "
                f"{te.guard_line}) by {witness} ({scope!r}-scoped): "
                f"the span exists on a rank-chosen subset and "
                f"trace-merge loses those lanes — emit on every rank "
                f"and let the deterministic sampler filter",
                astutil.context_for_line(model, te.line, fmap),
            ))
        for line, vt in ft.sampled_args:
            if not vt.scopes:
                continue
            scope, witness = next(iter(vt.scopes.items()))
            out.append(make_finding(
                "HVD013", model, line, 0,
                f"rank-derived value ({witness}, {scope!r}-scoped) in "
                f"a sampled(...) argument: the sampling verdict must "
                f"be a pure function of the trace id so every rank "
                f"agrees whether this request is traced",
                astutil.context_for_line(model, line, fmap),
            ))
    return out
