"""Shared AST helpers: collective-call and rank-dependence detection,
function indexing, and lightweight call extraction.

Name resolution is deliberately syntactic (RacerD-style): a call is "a
collective" because it *looks* like one (``hvd.allreduce``,
``ctx.sync_state``, a bare ``allreduce`` imported from
horovod_tpu_torch, ``dist.all_reduce`` on ``torch.distributed``) — no
type inference.  Over-approximation is tolerable because every rule
supports inline suppression and the baseline.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .core import PACKAGE, ModuleModel

# The negotiated/collective surface: every spelling that, when issued by
# a strict subset of ranks (or in a different order), hangs the world.
COLLECTIVE_NAMES: Set[str] = {
    "allreduce",
    "allreduce_",
    "allreduce_async",
    "allreduce_async_",
    "allreduce_sparse",
    "grouped_allreduce",
    "allgather",
    "allgather_async",
    "broadcast",
    "broadcast_",
    "broadcast_async",
    "broadcast_async_",
    "broadcast_parameters",
    "broadcast_optimizer_state",
    "broadcast_object",
    "broadcast_variables",
    "alltoall",
    "reducescatter",
    "barrier",
    "sync_state",
}
# torch.distributed's collectives.  Several spellings are generic
# (``reduce``, ``gather``, ``scatter``), so these count only on a
# receiver that resolves to ``torch.distributed`` (``dist.all_reduce``,
# ``torch.distributed.all_reduce``) or as a bare name imported from it.
TORCH_COLLECTIVE_NAMES: Set[str] = {
    "all_reduce",
    "all_gather",
    "all_gather_into_tensor",
    "all_gather_object",
    "reduce_scatter",
    "reduce_scatter_tensor",
    "broadcast",
    "broadcast_object_list",
    "all_to_all",
    "all_to_all_single",
    "reduce",
    "gather",
    "scatter",
    "barrier",
    "monitored_barrier",
    "batch_isend_irecv",
}
TORCH_DIST = "torch.distributed"
# The conventional alias, recognized even where the module was handed in
# rather than imported (``def helper(dist): dist.all_reduce(t)``).
_TORCH_DIST_ALIAS = "dist"

# Spellings so generic they count only with a horovod-ish receiver
# (``hvd.join()`` is the collective; ``thread.join()`` / ``"".join()``
# are not).
_HVD_RECEIVER_ONLY: Set[str] = {"join"}

# rank-valued calls: their result differs per rank, so control flow on
# them is rank-divergent by construction.
RANK_CALL_NAMES: Set[str] = {
    "rank", "local_rank", "cross_rank", "device_rank",
    "get_rank", "get_global_rank", "get_node_local_rank",
}
# Environment keys whose value is the rank (torchrun's and the
# launcher's): a conditional reading one is rank-dependent.
RANK_ENV_KEYS: Set[str] = {"RANK", "LOCAL_RANK", "HVDTPU_LOCAL_RANK"}
# Rank-uniform probes: same value on every rank — conditionals on these
# are NOT divergence hazards.
UNIFORM_CALL_NAMES: Set[str] = {
    "size", "local_size", "cross_size", "num_devices", "is_initialized",
    "is_homogeneous", "isinstance", "hasattr", "len",
    "get_world_size", "is_available", "is_nccl_available",
    "is_gloo_available",
}


def call_name(node: ast.Call) -> Optional[str]:
    """Trailing name of the called thing: ``hvd.allreduce`` -> 'allreduce',
    ``allreduce`` -> 'allreduce'."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def receiver_name(node: ast.Call) -> Optional[str]:
    """Base name of an attribute call's receiver: ``hvd.elastic.run`` ->
    'hvd'; bare-name calls -> None."""
    f = node.func
    if not isinstance(f, ast.Attribute):
        return None
    v = f.value
    while isinstance(v, ast.Attribute):
        v = v.value
    if isinstance(v, ast.Name):
        return v.id
    return None


def expr_text(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - malformed node
        return "<expr>"


def is_torch_dist_call(node: ast.Call, model: ModuleModel) -> bool:
    """Whether the call's receiver resolves to ``torch.distributed``:
    ``dist.f()`` (``import torch.distributed as dist``, ``from torch
    import distributed as dist``, or the conventional name),
    ``torch.distributed.f()``, or a bare ``f()`` imported from it."""
    f = node.func
    if isinstance(f, ast.Name):
        origin = model.from_imports.get(f.id)
        return origin is not None and origin[0] == TORCH_DIST
    if not isinstance(f, ast.Attribute):
        return False
    v = f.value
    if isinstance(v, ast.Name):
        if v.id == _TORCH_DIST_ALIAS:
            return True
        if model.from_imports.get(v.id) == ("torch", "distributed"):
            return True
        # `import torch.distributed` binds `torch`, not the submodule
        return v.id != "torch" and \
            model.module_aliases.get(v.id) == TORCH_DIST
    if isinstance(v, ast.Attribute) and v.attr == "distributed" and \
            isinstance(v.value, ast.Name):
        return model.module_aliases.get(v.value.id, v.value.id) \
            .split(".")[0] == "torch"
    return False


def is_collective_call(node: ast.Call, model: ModuleModel) -> bool:
    name = call_name(node)
    if name is None:
        return False
    if name in _HVD_RECEIVER_ONLY:
        recv = receiver_name(node)
        return recv is not None and recv in model.hvd_aliases
    if name in TORCH_COLLECTIVE_NAMES and is_torch_dist_call(node, model):
        return True
    if name not in COLLECTIVE_NAMES:
        return False
    if isinstance(node.func, ast.Attribute):
        return True  # hvd.allreduce / ctx.allreduce / self.allreduce
    # Bare name: only when it was imported from horovod_tpu_torch (or
    # this is a package-internal module where the def itself lives) — a
    # user's unrelated local helper named `broadcast` must not fire.
    origin = model.from_imports.get(name)
    if origin is not None:
        mod, _ = origin
        return mod == "" or PACKAGE in mod or mod.startswith(".")
    return model.is_package_module


def has_name_kwarg(node: ast.Call) -> bool:
    """Whether the collective carries an explicit negotiation name."""
    for kw in node.keywords:
        if kw.arg == "name":
            return True
    # Positional name forms: ctx.allreduce(x, "loss"),
    # eager.allreduce_async(t, op, f"delta.{i}"), eager.allgather(t, "g").
    # Only literal strings / f-strings count — an arbitrary variable in
    # that slot is usually a root_rank or an op.
    for arg in node.args[1:3]:
        if isinstance(arg, ast.JoinedStr):
            return True
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return True
    return False


def name_kwarg_expr(node: ast.Call) -> Optional[ast.expr]:
    for kw in node.keywords:
        if kw.arg == "name":
            return kw.value
    return None


def _is_rank_call(node: ast.Call) -> bool:
    return call_name(node) in RANK_CALL_NAMES


def rank_env_key(node: ast.AST) -> Optional[str]:
    """The key of an environment read of a rank (``os.environ["RANK"]``,
    ``os.environ.get("LOCAL_RANK")``, ``os.getenv("HVDTPU_LOCAL_RANK")``),
    or None."""
    key: Optional[ast.AST] = None
    if isinstance(node, ast.Subscript) and \
            "environ" in expr_text(node.value):
        key = node.slice
    elif isinstance(node, ast.Call) and node.args:
        name = call_name(node)
        if name == "getenv" or (
                name == "get" and "environ" in expr_text(node.func)):
            key = node.args[0]
    if isinstance(key, ast.Constant) and key.value in RANK_ENV_KEYS:
        return key.value
    return None


def is_rank_dependent(test: ast.expr) -> bool:
    """True when a conditional's value can differ across ranks because
    it reads the rank: ``hvd.rank() == 0``, ``rank != 0``,
    ``self.rank in world``, ``local_rank() > 0`` ...

    A bare ``rank`` Name / ``.rank`` attribute counts only inside a
    comparison (so ``if self.rank_table:`` and similar don't)."""
    for node in ast.walk(test):
        if isinstance(node, ast.Call) and _is_rank_call(node):
            return True
        if rank_env_key(node) is not None:
            return True
        if isinstance(node, ast.Compare):
            operands = [node.left, *node.comparators]
            for op in operands:
                if isinstance(op, ast.Name) and op.id == "rank":
                    return True
                if isinstance(op, ast.Attribute) and op.attr == "rank":
                    return True
    return False


def is_rank_uniform_test(test: ast.expr) -> bool:
    """Conditions that provably evaluate identically on every rank:
    ``__name__ == "__main__"``, world-size probes, constants."""
    if isinstance(test, ast.Constant):
        return True
    if isinstance(test, ast.Compare):
        names = [
            n.id for n in ast.walk(test) if isinstance(n, ast.Name)
        ]
        if "__name__" in names:
            return True
    for node in ast.walk(test):
        if rank_env_key(node) is not None:
            return False
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name in RANK_CALL_NAMES:
                return False
            if name in UNIFORM_CALL_NAMES:
                return True
    return False


# ---------------------------------------------------------------------------
# function indexing + call extraction (shared by the lock-graph and
# signal-reachability passes)
# ---------------------------------------------------------------------------


@dataclass
class FunctionInfo:
    """Per-function facts, collected once per file."""

    qualname: str          # "Class.method" or "func" (nested: "f.<locals>.g")
    module: str            # relpath of the defining module
    node: ast.AST
    cls: Optional[str]     # enclosing class name, if a method
    line: int
    # (kind, data) call sites:
    #   ("bare", name)            f()
    #   ("self", name)            self.f()
    #   ("typed", (cls, name))    x.f() where x's class is known
    #   ("mod", (alias, name))    mod.f() where `mod` is an import alias
    #   ("attr", name)            anything_else.f()
    calls: List[Tuple[str, object]] = field(default_factory=list)
    # receiver name -> inferred class (annotations + constructor calls)
    type_env: Dict[str, str] = field(default_factory=dict)

    @property
    def display(self) -> str:
        return self.qualname


_TYPING_WRAPPERS = {
    "Optional", "List", "Dict", "Tuple", "Union", "Sequence", "Set",
    "FrozenSet", "Iterable", "Iterator", "Callable", "Type", "Any",
    "None", "str", "int", "float", "bool", "bytes", "object",
}


def _annotation_class(ann: ast.expr) -> Optional[str]:
    """Best-effort class name out of an annotation: ``Cls``,
    ``Optional[Cls]``, ``"Cls"`` (string annotation)."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return None
    for node in ast.walk(ann):
        if isinstance(node, ast.Name) and node.id not in _TYPING_WRAPPERS:
            return node.id
        if isinstance(node, ast.Attribute) and \
                node.attr not in _TYPING_WRAPPERS:
            return node.attr
    return None


def _env_from_statements(stmts: List[ast.stmt]) -> Dict[str, str]:
    """name -> class from ``x: Cls = ...`` / ``x = Cls(...)``."""
    env: Dict[str, str] = {}
    for stmt in stmts:
        if isinstance(stmt, ast.AnnAssign) and \
                isinstance(stmt.target, ast.Name):
            cls = _annotation_class(stmt.annotation)
            if cls:
                env[stmt.target.id] = cls
        elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and isinstance(stmt.value, ast.Call):
            name = call_name(stmt.value)
            # Constructor heuristic: CapWord call = instance of it.
            if name and name[:1].isupper() and "_" not in name and \
                    name not in _TYPING_WRAPPERS:
                env[stmt.targets[0].id] = name
    return env


def _param_env(func: ast.AST) -> Dict[str, str]:
    env: Dict[str, str] = {}
    args = getattr(func, "args", None)
    if args is None:
        return env
    for a in (args.posonlyargs + args.args + args.kwonlyargs):
        if a.annotation is not None:
            cls = _annotation_class(a.annotation)
            if cls:
                env[a.arg] = cls
    return env


def index_functions(model: ModuleModel) -> Dict[str, FunctionInfo]:
    """qualname -> FunctionInfo for every def in the file (methods and
    nested defs included — signal handlers are often closures)."""
    out: Dict[str, FunctionInfo] = {}
    module_env = _env_from_statements(model.tree.body)

    def visit(node: ast.AST, prefix: str, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{child.name}"
                env = dict(module_env)
                env.update(_param_env(child))
                env.update(_env_from_statements(
                    [s for s in ast.walk(child)
                     if isinstance(s, ast.stmt)]
                ))
                info = FunctionInfo(
                    qualname=qn, module=model.relpath, node=child,
                    cls=cls, line=child.lineno, type_env=env,
                )
                info.calls = [
                    call_descriptor(c, env) for c in own_calls(child)
                ]
                out[qn] = info
                visit(child, f"{qn}.<locals>.", cls)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{child.name}.", child.name)
            else:
                visit(child, prefix, cls)

    visit(model.tree, "", None)
    return out


def iter_defs(tree: ast.AST) -> Iterator[Tuple[str, ast.AST]]:
    """Yield ``(qualname, def-node)`` for every function in a module,
    in source order, using THE qualname convention every pass keys on
    (``Class.method``, nested ``f.<locals>.g``).  One implementation on
    purpose: taint summaries, contract registration and the call graph
    must agree on these names exactly, or cross-references silently
    resolve to nothing."""
    stack: List[Tuple[ast.AST, str]] = [(tree, "")]
    while stack:
        node, prefix = stack.pop(0)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{child.name}"
                yield qn, child
                stack.append((child, f"{qn}.<locals>."))
            elif isinstance(child, ast.ClassDef):
                stack.append((child, f"{child.name}."))
            else:
                stack.append((child, prefix))


def own_calls(func: ast.AST) -> List[ast.Call]:
    """Call nodes in a function body EXCLUDING nested def/class/lambda
    bodies: a closure handed to a Thread(target=...) runs on another
    thread (or not at all) — its effects belong to its own summary."""
    out: List[ast.Call] = []
    stack: List[ast.AST] = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Call):
            out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


def call_descriptor(node: ast.Call,
                    env: Dict[str, str]) -> Tuple[str, object]:
    """Classify one call site for name-based resolution."""
    f = node.func
    if isinstance(f, ast.Name):
        return ("bare", f.id)
    if isinstance(f, ast.Attribute):
        v = f.value
        if isinstance(v, ast.Name):
            if v.id == "self":
                return ("self", f.attr)
            cls = env.get(v.id)
            if cls is not None:
                return ("typed", (cls, f.attr))
            return ("mod", (v.id, f.attr))
        return ("attr", f.attr)
    return ("attr", "")


def iter_calls(node: ast.AST) -> Iterator[ast.Call]:
    for child in ast.walk(node):
        if isinstance(child, ast.Call):
            yield child


def enclosing_function_map(
    model: ModuleModel,
) -> Dict[int, str]:
    """line -> qualname of the innermost enclosing function, for
    stable finding contexts.  Memoized on the model: every rule family
    asks for this map and the walk is the priciest per-file pass."""
    if model.fmap_cache is not None:
        return model.fmap_cache
    spans: List[Tuple[int, int, str]] = []

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{child.name}"
                end = getattr(child, "end_lineno", child.lineno)
                spans.append((child.lineno, end or child.lineno, qn))
                visit(child, f"{qn}.<locals>.")
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{child.name}.")
            else:
                visit(child, prefix)

    visit(model.tree, "")
    out: Dict[int, str] = {}
    # Innermost wins: sort wider spans first so narrower overwrite.
    for start, end, qn in sorted(spans, key=lambda s: -(s[1] - s[0])):
        for line in range(start, end + 1):
            out[line] = qn
    model.fmap_cache = out
    return out


def context_for_line(model: ModuleModel, line: int,
                     fmap: Optional[Dict[int, str]] = None) -> str:
    fmap = fmap if fmap is not None else enclosing_function_map(model)
    return fmap.get(line, "<module>")
