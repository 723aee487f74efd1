"""SPMD-correctness rules (HVD0xx).

The invariant behind every rule here is Horovod's core contract
(Sergeev & Del Balso, 2018): **every rank must submit the same
collective schedule in the same order.**  A collective some ranks skip,
reorder, or name differently never completes — the job hangs with no
exception anywhere, which is why these are worth rejecting at commit
time rather than diagnosing from a post-mortem.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from . import astutil
from .core import ModuleModel, SEV_ERROR, SEV_WARNING, Finding
from .registry import make_finding, rule

# ---------------------------------------------------------------------------
# HVD001 — collective under rank-dependent control flow
# ---------------------------------------------------------------------------


class _RankGuardVisitor(ast.NodeVisitor):
    """Finds collective calls lexically reachable only when a
    rank-dependent condition holds: inside the body/orelse of a
    rank-dependent ``if``/``while``, inside a rank-dependent ternary,
    or after a rank-dependent early exit (``if rank()!=0: return``)."""

    def __init__(self, model: ModuleModel):
        self.model = model
        self.findings: List[tuple] = []  # (node, guard_line)
        self._guards: List[int] = []  # lines of active rank guards

    # -- region tracking --

    def _walk_body(self, stmts: List[ast.stmt]) -> None:
        """Visit a statement list, activating a guard for statements
        after a rank-dependent early exit."""
        pushed = 0
        for stmt in stmts:
            if (
                isinstance(stmt, ast.If)
                and astutil.is_rank_dependent(stmt.test)
                and _ends_in_exit(stmt.body)
                and not stmt.orelse
            ):
                # `if rank() != 0: return` — everything after this
                # statement runs on a rank-dependent subset.
                self.visit(stmt.test)
                self._guards.append(stmt.lineno)
                pushed += 1
                for s in stmt.body:
                    self.visit(s)
                continue
            self.visit(stmt)
        for _ in range(pushed):
            self._guards.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # A nested def's body executes when *called*, not where it is
        # defined — guards at the definition site don't apply inside.
        saved, self._guards = self._guards, []
        self._walk_body(node.body)
        self._guards = saved

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Module(self, node: ast.Module) -> None:
        self._walk_body(node.body)

    def visit_For(self, node: ast.For) -> None:
        self.visit(node.target)
        self.visit(node.iter)
        self._walk_body(node.body)
        self._walk_body(node.orelse)

    visit_AsyncFor = visit_For

    def visit_With(self, node: ast.With) -> None:
        for item in node.items:
            self.visit(item)
        self._walk_body(node.body)

    visit_AsyncWith = visit_With

    def visit_Try(self, node: ast.Try) -> None:
        self._walk_body(node.body)
        for handler in node.handlers:
            self._walk_body(handler.body)
        self._walk_body(node.orelse)
        self._walk_body(node.finalbody)

    def visit_If(self, node: ast.If) -> None:
        if astutil.is_rank_dependent(node.test):
            self.visit(node.test)
            self._guards.append(node.lineno)
            for s in node.body + node.orelse:
                self.visit(s)
            self._guards.pop()
        else:
            self.visit(node.test)
            self._walk_body(node.body)
            self._walk_body(node.orelse)

    def visit_While(self, node: ast.While) -> None:
        if astutil.is_rank_dependent(node.test):
            self.visit(node.test)
            self._guards.append(node.lineno)
            for s in node.body + node.orelse:
                self.visit(s)
            self._guards.pop()
        else:
            self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        if astutil.is_rank_dependent(node.test):
            self.visit(node.test)
            self._guards.append(node.lineno)
            self.visit(node.body)
            self.visit(node.orelse)
            self._guards.pop()
        else:
            self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if self._guards and astutil.is_collective_call(node, self.model):
            self.findings.append((node, self._guards[-1]))
        self.generic_visit(node)


def _ends_in_exit(body: List[ast.stmt]) -> bool:
    if not body:
        return False
    last = body[-1]
    if isinstance(last, (ast.Return, ast.Continue, ast.Break)):
        return True
    if isinstance(last, ast.Expr) and isinstance(last.value, ast.Call):
        name = astutil.call_name(last.value)
        return name in ("exit", "_exit", "abort")
    return False


@rule("HVD001", "rank-guarded-collective", SEV_ERROR,
      "collective reachable only under rank-dependent control flow")
def hvd001(model: ModuleModel) -> List[Finding]:
    """A collective issued under a condition that reads the rank runs on
    a strict subset of ranks; the others never submit it, and the subset
    blocks forever waiting for them.

    Minimal failing example::

        if hvd.rank() == 0:
            total = hvd.allreduce(x)   # ranks != 0 never arrive: hang

    Fix: issue the collective unconditionally and branch on the rank
    *around* it (e.g. only rank 0 *uses* the result), or use
    ``broadcast`` from the deciding rank."""
    v = _RankGuardVisitor(model)
    v.visit(model.tree)
    fmap = astutil.enclosing_function_map(model)
    out = []
    for node, guard_line in v.findings:
        name = astutil.call_name(node)
        out.append(make_finding(
            "HVD001", model, node.lineno, node.col_offset,
            f"collective '{name}' is only reached under the "
            f"rank-dependent condition at line {guard_line}; ranks "
            f"outside the branch never submit it and the world "
            f"deadlocks",
            astutil.context_for_line(model, node.lineno, fmap),
        ))
    return out


# ---------------------------------------------------------------------------
# HVD002 — collective while iterating an unordered container
# ---------------------------------------------------------------------------


def _unordered_iter_reason(it: ast.expr) -> Optional[str]:
    """Why this for-loop's iteration order may differ across ranks."""
    if isinstance(it, ast.Set):
        return "a set literal"
    if isinstance(it, ast.Call):
        name = astutil.call_name(it)
        if name in ("set", "frozenset"):
            return f"a {name}() value"
        if name in ("keys", "values", "items") and isinstance(
            it.func, ast.Attribute
        ):
            return f"dict .{name}() (insertion order is build-dependent)"
        if name in ("vars", "globals", "locals"):
            return f"{name}()"
    if isinstance(it, ast.Attribute) and it.attr == "environ":
        return "os.environ"
    return None


@rule("HVD002", "collective-in-unordered-iteration", SEV_WARNING,
      "collective issued while iterating a set/dict view")
def hvd002(model: ModuleModel) -> List[Finding]:
    """Collectives inside a loop over a set (or a dict view whose build
    order is data-dependent) are submitted in container order.  If that
    order differs across ranks — sets hash-order differently under
    ``PYTHONHASHSEED``, dicts follow their build history — unnamed
    collectives pair by the auto ``_seq`` counter and ranks reduce
    *different tensors against each other* (or deadlock).

    Minimal failing example::

        for name in {"w", "b"}:               # set order
            grads[name] = hvd.allreduce(grads[name])

    Fix: ``for name in sorted(...)`` — one deterministic order on every
    rank.  ``sorted()`` wrapping the container is recognized."""
    out = []
    fmap = astutil.enclosing_function_map(model)
    for node in ast.walk(model.tree):
        if not isinstance(node, (ast.For, ast.AsyncFor)):
            continue
        reason = _unordered_iter_reason(node.iter)
        if reason is None:
            continue
        for call in astutil.iter_calls(node):
            if astutil.is_collective_call(call, model):
                name = astutil.call_name(call)
                out.append(make_finding(
                    "HVD002", model, call.lineno, call.col_offset,
                    f"collective '{name}' issued while iterating "
                    f"{reason} (loop at line {node.lineno}); iteration "
                    f"order can differ across ranks — wrap the "
                    f"container in sorted()",
                    astutil.context_for_line(model, call.lineno, fmap),
                ))
    return out


# ---------------------------------------------------------------------------
# HVD003 — unnamed collective inside a conditional
# ---------------------------------------------------------------------------


@rule("HVD003", "unnamed-collective-in-conditional", SEV_WARNING,
      "collective without an explicit name inside a conditional branch")
def hvd003(model: ModuleModel) -> List[Finding]:
    """Unnamed collectives are paired across ranks by an automatic
    per-epoch sequence counter.  Inside a data-dependent conditional the
    counter diverges the first time ranks disagree about the branch:
    every later unnamed collective then pairs tensor N on one rank with
    tensor N+1 on another.  (A *rank*-dependent branch is the stronger
    HVD001.)

    Minimal failing example::

        if loss_spiked:                  # can differ per rank
            g = hvd.allreduce(g)         # unnamed: auto _seq diverges

    Fix: pass ``name=`` so pairing is by name, not submission count —
    or hoist the collective out of the branch.  Conditions that are
    provably identical on every rank (``__name__`` guards,
    ``hvd.size()`` probes, constants) are exempt."""
    out: List[Finding] = []
    fmap = astutil.enclosing_function_map(model)
    seen: Set[int] = set()

    def scan_branch(branch: List[ast.stmt], cond_line: int) -> None:
        for stmt in branch:
            for call in astutil.iter_calls(stmt):
                if id(call) in seen:
                    continue
                if not astutil.is_collective_call(call, model):
                    continue
                seen.add(id(call))
                if astutil.has_name_kwarg(call):
                    continue
                name = astutil.call_name(call)
                out.append(make_finding(
                    "HVD003", model, call.lineno, call.col_offset,
                    f"unnamed collective '{name}' inside the "
                    f"conditional at line {cond_line}: if ranks "
                    f"disagree about the branch, auto-sequence names "
                    f"diverge — pass name=",
                    astutil.context_for_line(model, call.lineno, fmap),
                ))

    for node in ast.walk(model.tree):
        if isinstance(node, ast.If):
            if astutil.is_rank_dependent(node.test):
                continue  # HVD001 territory
            if astutil.is_rank_uniform_test(node.test):
                continue
            scan_branch(node.body, node.lineno)
            scan_branch(node.orelse, node.lineno)
    return out


# ---------------------------------------------------------------------------
# HVD004 — training entry point never syncs initial state
# ---------------------------------------------------------------------------

_SYNC_MARKERS = {
    "broadcast_parameters", "broadcast_optimizer_state",
    "broadcast_object", "broadcast_variables", "broadcast",
    "broadcast_", "sync_state", "sync",
    "BroadcastGlobalVariablesCallback", "BroadcastGlobalVariablesHook",
    # torch's DDP broadcasts rank 0's parameters and buffers when it is
    # constructed
    "DistributedDataParallel",
}
_TRAIN_MARKERS = {"DistributedOptimizer", "DistributedGradientTransform"}


@rule("HVD004", "missing-initial-state-sync", SEV_WARNING,
      "init()+DistributedOptimizer without broadcasting initial state")
def hvd004(model: ModuleModel) -> List[Finding]:
    """A training script that calls ``init()`` and wraps its optimizer
    but never broadcasts/syncs initial state starts every rank from its
    own random initialization: gradients get averaged across *different*
    models, which converges worse or diverges silently — the classic
    forgotten step 4 of the Horovod recipe.

    Minimal failing example::

        hvd.init()
        tx = hvd.DistributedOptimizer(optax.adam(1e-3))
        # ... training loop, no broadcast_parameters / state.sync

    Fix: ``hvd.broadcast_parameters(model.state_dict(), root_rank=0)``
    after ``init()`` (or adopt elastic ``state.sync()``, or wrap the
    model in ``DistributedDataParallel``, which broadcasts rank 0's
    parameters at construction)."""
    init_call: Optional[ast.Call] = None
    has_train = False
    has_sync = False
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.Call):
            continue
        name = astutil.call_name(node)
        if name == "init":
            recv = astutil.receiver_name(node)
            if recv is None or recv in model.hvd_aliases:
                if init_call is None:
                    init_call = node
        elif name in _TRAIN_MARKERS:
            has_train = True
        elif name in _SYNC_MARKERS:
            has_sync = True
    # Class references without a call (e.g. callbacks list) count too.
    if not has_sync:
        for node in ast.walk(model.tree):
            if isinstance(node, ast.Attribute) and node.attr in _SYNC_MARKERS:
                has_sync = True
                break
            if isinstance(node, ast.Name) and node.id in _SYNC_MARKERS:
                has_sync = True
                break
    if init_call is None or not has_train or has_sync:
        return []
    fmap = astutil.enclosing_function_map(model)
    return [make_finding(
        "HVD004", model, init_call.lineno, init_call.col_offset,
        "init() + DistributedOptimizer but no initial-state sync: add "
        "broadcast_parameters(..., root_rank=0) (and "
        "broadcast_optimizer_state for stateful optimizers) so every "
        "rank starts from identical weights",
        astutil.context_for_line(model, init_call.lineno, fmap),
    )]


# ---------------------------------------------------------------------------
# HVD005 — rank()/size() at import time
# ---------------------------------------------------------------------------


@rule("HVD005", "topology-read-at-import", SEV_ERROR,
      "rank()/size() called at module import time, before init()")
def hvd005(model: ModuleModel) -> List[Finding]:
    """Module-level ``rank()``/``size()`` runs at import time, before
    any ``init()`` call — it raises ``NotInitializedError`` (or, in
    lazy-init setups, silently captures a stale single-process
    topology that never updates).

    Minimal failing example::

        import horovod_tpu_torch as hvd
        IS_CHIEF = hvd.rank() == 0     # import-time: init() not yet run

    torch's spelling, ``dist.get_rank()`` / ``dist.get_world_size()``
    before ``dist.init_process_group``, raises the same way.

    Fix: read the topology inside a function (or after the module-level
    ``init()`` / ``init_process_group()`` call, which is recognized)."""
    out: List[Finding] = []
    fmap = astutil.enclosing_function_map(model)
    topo_names = astutil.RANK_CALL_NAMES | {
        "size", "local_size", "cross_size", "num_devices", "get_world_size",
    }
    init_seen_line: Optional[int] = None

    def scan_stmts(stmts: List[ast.stmt]) -> None:
        nonlocal init_seen_line
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # deferred execution: fine
            if isinstance(stmt, (ast.If, ast.Try, ast.With, ast.For,
                                 ast.While)):
                scan_stmts(_stmt_children(stmt))  # still import-time
                continue
            for call in astutil.iter_calls(stmt):
                name = astutil.call_name(call)
                recv = astutil.receiver_name(call)
                hvdish = (
                    (recv is not None and recv in model.hvd_aliases)
                    or (recv is None and name in model.from_imports)
                    or astutil.is_torch_dist_call(call, model)
                )
                if name in ("init", "init_process_group") and hvdish:
                    if init_seen_line is None:
                        init_seen_line = stmt.lineno
                    continue
                if name in topo_names and hvdish:
                    if init_seen_line is not None:
                        continue  # init() already ran at import time
                    out.append(make_finding(
                        "HVD005", model, call.lineno, call.col_offset,
                        f"'{name}()' at module import time, before "
                        f"init(): raises NotInitializedError (or "
                        f"captures a stale topology) — move it inside "
                        f"a function or after init()",
                        astutil.context_for_line(model, call.lineno,
                                                 fmap),
                    ))

    scan_stmts(model.tree.body)
    return out


def _stmt_children(stmt: ast.stmt) -> List[ast.stmt]:
    out: List[ast.stmt] = []
    for fld in ("body", "orelse", "finalbody"):
        out.extend(getattr(stmt, fld, []) or [])
    for handler in getattr(stmt, "handlers", []) or []:
        out.extend(handler.body)
    return out


# ---------------------------------------------------------------------------
# HVD006 — collective inside an except handler
# ---------------------------------------------------------------------------


@rule("HVD006", "collective-in-except-handler", SEV_ERROR,
      "collective issued from an exception handler")
def hvd006(model: ModuleModel) -> List[Finding]:
    """An except block runs only on ranks where the try body raised —
    a strict subset, chosen by runtime failure.  A collective there can
    never complete: the healthy ranks are already past it (or parked in
    the *next* collective, which now pairs with the wrong op).

    Minimal failing example::

        try:
            step()
        except Exception:
            hvd.allreduce(loss)      # only failed ranks arrive

    Fix: record the failure locally, exit the collective schedule
    deterministically (e.g. ``hvd.join()`` outside the handler, or an
    agreed sentinel allreduce issued by EVERY rank), then recover.
    (Collectives in ``finally`` run on every path and are fine.)"""
    out: List[Finding] = []
    fmap = astutil.enclosing_function_map(model)
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        for stmt in node.body:
            for call in astutil.iter_calls(stmt):
                if astutil.is_collective_call(call, model):
                    name = astutil.call_name(call)
                    out.append(make_finding(
                        "HVD006", model, call.lineno, call.col_offset,
                        f"collective '{name}' inside an except handler "
                        f"(line {node.lineno}): only ranks that raised "
                        f"run it — the rest of the world never "
                        f"arrives",
                        astutil.context_for_line(model, call.lineno,
                                                 fmap),
                    ))
    return out


# ---------------------------------------------------------------------------
# HVD007 — rank-dependent collective name
# ---------------------------------------------------------------------------


@rule("HVD007", "rank-dependent-collective-name", SEV_ERROR,
      "collective name derived from the rank")
def hvd007(model: ModuleModel) -> List[Finding]:
    """Collectives pair across ranks BY NAME: a name containing the
    rank gives every rank a different key, so nothing ever matches and
    every rank hangs waiting for peers that are waiting right back.

    Minimal failing example::

        hvd.allreduce(g, name=f"grad_{hvd.rank()}")   # no two match

    Fix: name by *tensor*, not by rank — the name must be identical on
    every rank (``name="grad_w0"``)."""
    out: List[Finding] = []
    fmap = astutil.enclosing_function_map(model)
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.Call):
            continue
        if not astutil.is_collective_call(node, model):
            continue
        expr = astutil.name_kwarg_expr(node)
        if expr is None:
            continue
        if _mentions_rank(expr):
            out.append(make_finding(
                "HVD007", model, node.lineno, node.col_offset,
                f"collective name {astutil.expr_text(expr)!r} depends "
                f"on the rank: names must be identical on every rank "
                f"or the collective never matches",
                astutil.context_for_line(model, node.lineno, fmap),
            ))
    return out


# ---------------------------------------------------------------------------
# HVD008 — direct collective bypasses the replay-epoch deviation check
# ---------------------------------------------------------------------------

# Coordination-service collectives that reach the wire without passing
# the eager engine's lookup()/deviation check: the reference's
# multihost_utils spellings, kept so user code written against them is
# still judged.
_DIRECT_COLLECTIVE_NAMES = {
    "process_allgather", "sync_global_devices", "broadcast_one_to_all",
}
_MULTIHOST_MODULE = "jax.experimental.multihost_utils"
# The port's counterpart: a TCPStore key exchange.
_STORE_EXCHANGE_NAMES = {
    "set", "get", "add", "wait", "compare_set", "multi_get", "multi_set",
    "check", "delete_key",
}
# The engine's own negotiation/data transport: these ARE the sanctioned
# submission path (the deviation check, runtime/engine.py
# `_replay_plan_ok`, lives upstream of them).  In the port the data
# planes (runtime/device_plane.py) execute negotiated responses on the
# engine's own groups.
_HVD008_SANCTIONED = {
    ("horovod_tpu_torch/runtime/engine.py", "EagerEngine._exchange"),
    ("horovod_tpu_torch/runtime/engine.py", "EagerEngine._data_allgather"),
    ("horovod_tpu_torch/runtime/engine.py",
     "EagerEngine._execute_reducescatter"),
    ("horovod_tpu_torch/runtime/device_plane.py", "DataPlane.allreduce"),
    ("horovod_tpu_torch/runtime/device_plane.py", "DataPlane.broadcast"),
    ("horovod_tpu_torch/runtime/device_plane.py", "DataPlane.alltoall"),
}


def _tcpstore_names(model: ModuleModel) -> Set[str]:
    """Receiver spellings bound to a ``TCPStore(...)`` in this module:
    ``store`` for ``store = dist.TCPStore(...)``, ``self._store`` for
    ``self._store = TCPStore(...)``."""
    out: Set[str] = set()
    for node in ast.walk(model.tree):
        if isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Call) and \
                astutil.call_name(node.value) == "TCPStore":
            for t in node.targets:
                if isinstance(t, (ast.Name, ast.Attribute)):
                    out.add(astutil.expr_text(t))
    return out


def _is_direct_collective(call: ast.Call, model: ModuleModel,
                          stores: Set[str]) -> bool:
    name = astutil.call_name(call)
    if name in astutil.TORCH_COLLECTIVE_NAMES:
        # torch.distributed straight from library code: user scripts
        # call it as their collective surface, the library should go
        # through the engine
        return model.is_package_module and \
            astutil.is_torch_dist_call(call, model)
    if name in _STORE_EXCHANGE_NAMES and \
            isinstance(call.func, ast.Attribute):
        return astutil.expr_text(call.func.value) in stores
    if name not in _DIRECT_COLLECTIVE_NAMES:
        return False
    recv = astutil.receiver_name(call)
    if recv is not None:
        target = model.module_aliases.get(recv, recv)
        return (
            target == _MULTIHOST_MODULE
            or target.endswith("multihost_utils")
        )
    imported = model.from_imports.get(name)
    return imported is not None and imported[0] == _MULTIHOST_MODULE


@rule("HVD008", "replay-bypassing-collective", SEV_ERROR,
      "direct coordination-service collective bypasses the engine's "
      "replay deviation check")
def hvd008(model: ModuleModel) -> List[Finding]:
    """During a schedule-replay epoch the eager engine exchanges no
    control vectors: correctness rests on every collective submission
    flowing through the engine's ``lookup()``/deviation check, which
    breaks the epoch *before* an unexpected collective reaches the
    wire.  A direct coordination-service collective
    (``multihost_utils.process_allgather`` / ``sync_global_devices`` /
    ``broadcast_one_to_all``) issued from library code while an epoch
    is open interleaves an unscheduled global exchange between the
    memorized replay collectives — if any rank is meanwhile inside a
    replay buffer, submission orders diverge and the job deadlocks
    (HVD001's failure shape, hidden inside the library).

    In the port the same bypass is a ``torch.distributed`` collective
    issued straight from library code (a module of horovod_tpu_torch),
    or a key exchange on a ``TCPStore``, anywhere.  The reference's
    ``multihost_utils`` spellings still count.

    Minimal failing example (in a module of the package)::

        import torch.distributed as dist

        def checkpoint_barrier():
            dist.barrier()               # bypasses lookup()

    Fix: route through the engine (``hvd.barrier()`` / ``hvd.*``
    collectives) so the submission is negotiated — a cache MISS there
    breaks the replay epoch deterministically — or baseline the site
    with a written justification for why it can never overlap an open
    epoch (engine transport itself, init/teardown-time only, or an
    engine-absent fallback path)."""
    out: List[Finding] = []
    fmap = astutil.enclosing_function_map(model)
    stores = _tcpstore_names(model)
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.Call):
            continue
        if not _is_direct_collective(node, model, stores):
            continue
        context = astutil.context_for_line(model, node.lineno, fmap)
        if (model.relpath, context) in _HVD008_SANCTIONED:
            continue
        name = astutil.call_name(node)
        out.append(make_finding(
            "HVD008", model, node.lineno, node.col_offset,
            f"direct coordination-service collective '{name}' is not "
            f"routed through the engine's lookup()/deviation check: "
            f"issued while a replay epoch is open, it interleaves an "
            f"unscheduled exchange with the memorized schedule and can "
            f"deadlock the world",
            context,
        ))
    return out


# ---------------------------------------------------------------------------
# HVD009 — jit of a train step without buffer donation
# ---------------------------------------------------------------------------

# Argument names that mark a jitted function as carrying training state.
_STATE_ARG_NAMES = {
    "params", "param", "opt_state", "optimizer_state", "train_state",
    "state", "weights",
}
# Wrappers whose first positional argument is the actual step function.
_JIT_WRAPPER_NAMES = {"shard_map", "shard_map_compat", "partial", "remat",
                      "checkpoint"}


def _scope_then_module(scope: Optional[ast.AST],
                       model: ModuleModel) -> List[ast.AST]:
    """Search roots for name resolution: the jit call's enclosing
    function first, then the module — a name bound in ANOTHER function
    is a different variable entirely (resolving it would judge the jit
    call against an unrelated same-named callable)."""
    roots: List[ast.AST] = []
    if scope is not None:
        roots.append(scope)
    roots.append(model.tree)
    return roots


def _find_binding(target: str, scope: Optional[ast.AST],
                  model: ModuleModel) -> Optional[ast.AST]:
    """The Assign value / def node `target` resolves to, scope-first."""
    for root in _scope_then_module(scope, model):
        module_level = root is model.tree
        for node in ast.walk(root):
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == target
                for t in node.targets
            ) and isinstance(node.value, (ast.Call, ast.Lambda)):
                # At module level only accept top-level statements: an
                # assignment inside some other function binds a
                # different variable.
                if module_level and node not in model.tree.body:
                    continue
                return node.value
        for node in ast.walk(root):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == target:
                return node
    return None


def _callee_arg_names(expr: ast.expr, model: ModuleModel,
                      scope: Optional[ast.AST] = None
                      ) -> Optional[List[str]]:
    """Positional-argument names of the function a ``jax.jit`` call
    wraps, looking through shard_map/partial wrappers and resolving
    names scope-first (``scope`` = the jit call's enclosing function).
    None = could not resolve (quiet)."""
    for _ in range(4):  # bounded wrapper unwrap
        if isinstance(expr, ast.Lambda):
            return [a.arg for a in expr.args.args]
        if isinstance(expr, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names = [a.arg for a in expr.args.args]
            if names and names[0] in ("self", "cls"):
                return None  # method: not what jit wraps here
            return names
        if isinstance(expr, ast.Call):
            name = astutil.call_name(expr)
            if name in _JIT_WRAPPER_NAMES and expr.args:
                expr = expr.args[0]
                continue
            return None
        if isinstance(expr, ast.Name):
            bound = _find_binding(expr.id, scope, model)
            if bound is None:
                return None
            expr = bound
            continue
        return None
    return None


def _is_jax_jit_call(node: ast.Call, model: ModuleModel) -> bool:
    if astutil.call_name(node) != "jit":
        return False
    recv = astutil.receiver_name(node)
    if recv is not None:
        return model.module_aliases.get(recv, recv) == "jax"
    imported = model.from_imports.get("jit")
    return imported is not None and imported[0] == "jax"


@rule("HVD009", "undonated-train-step", SEV_WARNING,
      "jax.jit of a step function carrying params/opt_state without "
      "donate_argnums")
def hvd009(model: ModuleModel) -> List[Finding]:
    """A jitted train step whose arguments include params/opt_state but
    whose ``jax.jit`` call passes no ``donate_argnums``/``donate_argnames``
    keeps BOTH the input and output copies of the model state live
    across every step: peak HBM grows by a full params+opt_state
    replica, which is the difference between fitting a batch size and
    OOMing — and on the ZeRO-sharded path it silently forfeits the
    memory the sharding just bought.  (XLA only aliases input buffers
    into outputs when the jit call donates them.)

    Minimal failing example::

        step = jax.jit(shard_map(local_step, mesh=mesh, ...))
        # local_step(params, opt_state, batch): state copied every step

    Fix: ``jax.jit(..., donate_argnums=(0, 1))`` for the state
    arguments (then verify the aliasing took with
    ``optim.overlap.audit_donation``), or baseline the site with a
    reason (e.g. an eval-only apply where the state must survive).

    The rule keeps the reference's ``jax.jit`` form only: eager PyTorch
    has no buffer donation (an optimizer steps its parameters in place,
    so no second copy of the state is live), and no torch spelling
    fires it."""
    out: List[Finding] = []
    fmap = astutil.enclosing_function_map(model)
    # Enclosing function per call node, for scope-first name resolution.
    scopes: Dict[int, ast.AST] = {}

    def index_scopes(node: ast.AST, scope: Optional[ast.AST]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scope = node
        elif isinstance(node, ast.Call):
            if scope is not None:
                scopes[id(node)] = scope
        for child in ast.iter_child_nodes(node):
            index_scopes(child, scope)

    index_scopes(model.tree, None)
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.Call):
            continue
        if not _is_jax_jit_call(node, model):
            continue
        kwarg_names = {kw.arg for kw in node.keywords}
        if {"donate_argnums", "donate_argnames"} & kwarg_names:
            continue
        if None in kwarg_names:  # **kwargs splat: unknown, stay quiet
            continue
        if not node.args:
            continue
        arg_names = _callee_arg_names(node.args[0], model,
                                      scope=scopes.get(id(node)))
        if not arg_names:
            continue
        hits = sorted(set(arg_names) & _STATE_ARG_NAMES)
        if not hits:
            continue
        out.append(make_finding(
            "HVD009", model, node.lineno, node.col_offset,
            f"jax.jit of a step taking {', '.join(hits)} without "
            f"donate_argnums: input and output state copies both stay "
            f"live, doubling peak state memory — donate the state "
            f"arguments",
            astutil.context_for_line(model, node.lineno, fmap),
        ))
    return out


def _mentions_rank(expr: ast.expr) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Call) and \
                astutil.call_name(node) in astutil.RANK_CALL_NAMES:
            return True
        if isinstance(node, ast.Attribute) and node.attr == "rank":
            return True
        if isinstance(node, ast.Name) and node.id == "rank":
            return True
    return False
