"""Mesh model: what the analyzer knows about named axis subgroups.

The runtime runs collectives over *named axis subgroups*: in the port,
a ``torch.distributed`` collective whose ``group=`` is
``basics.group_of_axis(LOCAL_AXIS)`` (the counterpart of the
reference's ``psum(..., LOCAL_AXIS)`` inside ``shard_map`` bodies), and
the hierarchical plane's ``hierarchical_axes=(local, cross)``.
Rank divergence **within** one of those groups is exactly the HVD001
deadlock class, but the world-collective rules cannot see it: a branch
on ``cross_rank()`` is perfectly safe around a LOCAL_AXIS collective
(every member of a local group shares the cross index) and fatal around
a CROSS_AXIS one.  This module centralizes that judgement:

* canonical **axis scopes** ("world"/"slice"/"cross"/"local"/literal
  axis names) and the mapping from the repo's axis constants to them;
* **rank-source classification** — which calls/env reads produce a
  value that differs across ranks, and along which axis;
* **subgroup-collective recognition** (``torch.distributed``
  collectives with ``group=group_of_axis(A)``, the reference's
  ``lax.psum``/``psum_scatter``/``all_gather``/... plus the
  hierarchical plane's wrappers) and axis extraction from their call
  sites;
* the **divergence judgement** ``diverges(scope, axes)``;
* **sanitizers** — collectives whose *result* is rank-uniform along the
  reduced axis (an allreduce/broadcast result is the same everywhere:
  branching on it is safe);
* the **deterministic-contract registry** (HVD012): functions whose
  outputs must be a pure function of their inputs on every rank — the
  serve scheduler's documented purity contract and the trace sampler —
  plus the ``# hvdtpu: deterministic`` source annotation, and the
  impure-input classifier used against them (torch's global RNG is
  impure; a draw from an explicit ``generator=`` is not).

Stdlib-only, like the rest of the package.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from . import astutil
from .core import ModuleModel

# ---------------------------------------------------------------------------
# axis scopes
# ---------------------------------------------------------------------------

WORLD = "world"

# Literal axis-name values used across the repo (basics.py,
# runtime/device_plane.py) -> canonical scope.  Kept as literals on
# purpose: the analyzer must not import the runtime.
_AXIS_LITERALS: Dict[str, str] = {
    "hvd": WORLD,            # DP_AXIS — the flat data-parallel world
    "hvdtpu_proc": WORLD,    # PROC_AXIS — device-plane process axis
    "hvd_local": "local",    # LOCAL_AXIS
    "hvdtpu_ici": "local",   # ICI_AXIS
    "hvd_cross": "cross",    # CROSS_AXIS
    "hvdtpu_dcn": "cross",   # DCN_AXIS
    "hvd_slice": "slice",    # SLICE_AXIS
}

# Symbolic spellings (Name/attribute references to the axis constants,
# and the conventional parameter names of the hierarchical plane).
_AXIS_SYMBOLS: Dict[str, str] = {
    "DP_AXIS": WORLD, "PROC_AXIS": WORLD,
    "LOCAL_AXIS": "local", "ICI_AXIS": "local", "local_axis": "local",
    "CROSS_AXIS": "cross", "DCN_AXIS": "cross", "cross_axis": "cross",
    "SLICE_AXIS": "slice", "slice_axis": "slice",
}

UNKNOWN_AXIS = "?"


def canon_axis(token: str) -> str:
    """Literal axis string -> canonical scope (unknown literals map to
    themselves: ``psum(x, "model")`` guarded by ``axis_index("model")``
    must still match)."""
    return _AXIS_LITERALS.get(token, token)


def axis_tokens(expr: Optional[ast.expr]) -> List[str]:
    """Canonical axis tokens an axis-name argument can denote."""
    if expr is None:
        return [UNKNOWN_AXIS]
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return [canon_axis(expr.value)]
    if isinstance(expr, (ast.Tuple, ast.List)):
        out: List[str] = []
        for e in expr.elts:
            out.extend(axis_tokens(e))
        return out
    if isinstance(expr, ast.Name):
        return [_AXIS_SYMBOLS.get(expr.id, UNKNOWN_AXIS)]
    if isinstance(expr, ast.Attribute):
        return [_AXIS_SYMBOLS.get(expr.attr, UNKNOWN_AXIS)]
    return [UNKNOWN_AXIS]


def diverges(scope: str, axes: List[str]) -> bool:
    """May a value tainted with ``scope`` differ between members of a
    collective group over ``axes``?

    The mesh-aware part: taint scoped to axis B is *uniform* within a
    group over axis A != B (the group fixes every other coordinate), so
    only a matching axis — or world-scoped taint, which differs along
    every axis — diverges.  Unknown axes stay quiet for scoped taint
    (over-firing on unresolvable axis names would drown the signal) but
    world taint always fires: the world rank differs inside every
    conceivable subgroup."""
    if scope in (WORLD, UNKNOWN_AXIS):
        return True
    if WORLD in axes:
        # A world collective's group is everyone: any per-rank scope
        # varies inside it (local_rank differs across hosts too).
        return True
    return scope in axes


# ---------------------------------------------------------------------------
# rank sources
# ---------------------------------------------------------------------------

# call name -> fixed scope (None: scope comes from the axis argument)
_SOURCE_CALLS: Dict[str, Optional[str]] = {
    "rank": WORLD,
    "device_rank": WORLD,
    "process_index": WORLD,   # jax.process_index()
    "get_rank": WORLD,        # dist.get_rank(); group= narrows it
    "get_global_rank": WORLD,
    "get_node_local_rank": "local",
    "local_rank": "local",
    "cross_rank": "cross",
    "slice_id": "slice",
    "axis_rank": None,
    "axis_index": None,
}

_ENV_SCOPE_RE: List[Tuple[re.Pattern, str]] = [
    (re.compile(r"SLICE", re.I), "slice"),
    # torchrun's LOCAL_RANK, the launcher's HVDTPU_LOCAL_RANK
    (re.compile(r"(^|_)LOCAL_RANK$", re.I), "local"),
    (re.compile(r"RANK|PROCESS_INDEX|PMI|PROC_ID", re.I), WORLD),
]


def _env_key_scope(key: str) -> Optional[str]:
    for pat, scope in _ENV_SCOPE_RE:
        if pat.search(key):
            return scope
    return None


def source_scope(node: ast.expr) -> Optional[Tuple[str, str]]:
    """``(scope, witness)`` when ``node`` is a rank source expression:
    a topology call, ``lax.axis_index(axis)``, or an env lookup of a
    rank-shaped key.  ``None`` otherwise."""
    if isinstance(node, ast.Call):
        name = astutil.call_name(node)
        if name in _SOURCE_CALLS:
            fixed = _SOURCE_CALLS[name]
            if name == "get_rank":
                # dist.get_rank(group) / dist.get_rank(group=group)
                group = _group_kwarg(node) or (
                    node.args[0] if node.args else None)
                if group is not None:
                    # the rank inside that group: scoped to its axis
                    toks = _inline_group_axes(group)
                    scope = toks[0] if len(toks) == 1 else UNKNOWN_AXIS
                    return scope, f"{name}(group=" \
                        f"{astutil.expr_text(group)})"
            if fixed is not None:
                return fixed, f"{name}()"
            axis_expr = node.args[0] if node.args else None
            for kw in node.keywords:
                if kw.arg == "axis_name":
                    axis_expr = kw.value
            if axis_expr is None:  # axis_rank() defaults to DP_AXIS
                return WORLD, f"{name}()"
            toks = axis_tokens(axis_expr)
            scope = toks[0] if len(toks) == 1 else UNKNOWN_AXIS
            return scope, f"{name}({astutil.expr_text(axis_expr)})"
        # os.environ.get("HOROVOD_RANK") / os.getenv("...")
        if name in ("get", "getenv") and node.args:
            recv = astutil.expr_text(node.func)
            if "environ" in recv or name == "getenv":
                key = node.args[0]
                if isinstance(key, ast.Constant) and \
                        isinstance(key.value, str):
                    scope = _env_key_scope(key.value)
                    if scope is not None:
                        return scope, f"env[{key.value!r}]"
    if isinstance(node, ast.Subscript):
        base = astutil.expr_text(node.value)
        if "environ" in base:
            sl = node.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                scope = _env_key_scope(sl.value)
                if scope is not None:
                    return scope, f"env[{sl.value!r}]"
    return None


# ---------------------------------------------------------------------------
# subgroup collectives + axis extraction
# ---------------------------------------------------------------------------

# jax.lax collectives whose 2nd positional arg (or axis_name=) is the
# axis-name binding.
_LAX_COLLECTIVES: Set[str] = {
    "psum", "pmean", "pmax", "pmin", "psum_scatter",
    "all_gather", "all_to_all", "ppermute", "pshuffle", "pbroadcast",
}
# horovod_tpu wrappers carrying axis names in kwargs.
_HVD_AXIS_COLLECTIVES: Set[str] = {
    "hierarchical_allreduce", "hierarchical_adasum",
    "hierarchical_reduce_scatter", "hierarchical_all_gather",
    "adasum_allreduce",
}
_HIER_DEFAULT_AXES = ["local", "cross"]


# The port's group helpers (basics.py) -> the axis their group spans.
_GROUP_HELPERS: Dict[str, str] = {
    "local_group": "local", "cross_group": "cross",
}


def _group_kwarg(node: ast.Call) -> Optional[ast.expr]:
    for kw in node.keywords:
        if kw.arg == "group":
            return kw.value
    return None


def _inline_group_axes(expr: ast.expr) -> List[str]:
    """Axis tokens of a group expression that names its axis in place:
    ``group_of_axis(A)``, ``basics.local_group()``; else unknown."""
    if isinstance(expr, ast.Call):
        name = astutil.call_name(expr)
        if name == "group_of_axis" and expr.args:
            return axis_tokens(expr.args[0])
        if name in _GROUP_HELPERS:
            return [_GROUP_HELPERS[name]]
    return [UNKNOWN_AXIS]


def _bound_groups(model: ModuleModel) -> Dict[str, List[str]]:
    """Names this module binds to an axis group (``g =
    group_of_axis(A)``, ``self.g = basics.local_group()``) -> axis
    tokens.  A name bound to two different axes is unknown."""
    if model.group_axes_cache is not None:
        return model.group_axes_cache
    out: Dict[str, List[str]] = {}
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.Assign) or \
                not isinstance(node.value, ast.Call):
            continue
        toks = _inline_group_axes(node.value)
        if toks == [UNKNOWN_AXIS]:
            continue
        for t in node.targets:
            if isinstance(t, (ast.Name, ast.Attribute)):
                key = astutil.expr_text(t)
                out[key] = toks if out.get(key, toks) == toks \
                    else [UNKNOWN_AXIS]
    model.group_axes_cache = out
    return out


def torch_group_axes(node: ast.Call, model: ModuleModel) -> List[str]:
    """Axis tokens of a ``torch.distributed`` collective's group: the
    world without ``group=``, the axis of ``group_of_axis(A)`` (inline
    or through a name bound to it), else unknown."""
    group = _group_kwarg(node)
    if group is None or (isinstance(group, ast.Constant)
                         and group.value is None):
        return [WORLD]
    toks = _inline_group_axes(group)
    if toks == [UNKNOWN_AXIS] and isinstance(group,
                                             (ast.Name, ast.Attribute)):
        toks = _bound_groups(model).get(astutil.expr_text(group), toks)
    return toks


def _laxish(node: ast.Call, model: ModuleModel) -> bool:
    recv = astutil.receiver_name(node)
    if recv is not None:
        target = model.module_aliases.get(recv, recv)
        return target == "lax" or target.endswith(".lax") or recv == "lax"
    name = astutil.call_name(node)
    origin = model.from_imports.get(name or "")
    if origin is not None:
        mod = origin[0]
        return mod == "jax.lax" or mod.endswith(".lax") or mod == "jax"
    return False


def _hvdish(node: ast.Call, model: ModuleModel) -> bool:
    name = astutil.call_name(node)
    if isinstance(node.func, ast.Attribute):
        return True
    origin = model.from_imports.get(name or "")
    if origin is not None:
        mod = origin[0]
        return mod == "" or "horovod_tpu" in mod or mod.startswith(".")
    return model.is_package_module


def collective_axes(node: ast.Call,
                    model: ModuleModel) -> Optional[List[str]]:
    """Canonical axis tokens of a collective call, or ``None`` when the
    call is not a recognized collective.

    ``["world"]`` marks world-group collectives (the eager ``hvd.*``
    surface and lax collectives over the data-parallel axis); anything
    else is a *subgroup* collective."""
    name = astutil.call_name(node)
    if name is None:
        return None
    if name in astutil.TORCH_COLLECTIVE_NAMES and \
            astutil.is_torch_dist_call(node, model):
        return torch_group_axes(node, model)
    if name in _LAX_COLLECTIVES and _laxish(node, model):
        axis_expr: Optional[ast.expr] = (
            node.args[1] if len(node.args) >= 2 else None
        )
        for kw in node.keywords:
            if kw.arg == "axis_name":
                axis_expr = kw.value
        return axis_tokens(axis_expr)
    if name in _HVD_AXIS_COLLECTIVES and _hvdish(node, model):
        axes: List[str] = []
        for kw in node.keywords:
            if kw.arg in ("local_axis", "cross_axis", "axis_name"):
                axes.extend(axis_tokens(kw.value))
            elif kw.arg == "hierarchical_axes":
                axes.extend(axis_tokens(kw.value))
        if not axes:
            axes = (list(_HIER_DEFAULT_AXES)
                    if name.startswith("hierarchical_")
                    else [WORLD])
        return axes
    if astutil.is_collective_call(node, model):
        # The eager world surface — unless an explicit axis_name kwarg
        # narrows it to a subgroup (ops.collectives under tracing).
        for kw in node.keywords:
            if kw.arg == "axis_name":
                return axis_tokens(kw.value)
        return [WORLD]
    return None


def is_subgroup(axes: List[str]) -> bool:
    return axes != [WORLD]


# ---------------------------------------------------------------------------
# sanitizers: rank-uniform results
# ---------------------------------------------------------------------------

# World collectives whose RESULT is identical on every rank: assigning
# through one launders any rank taint (the satellite "sanitized by a
# uniform broadcast" case).  allgather/barrier included: the gathered
# tuple is the same everywhere.
_WORLD_SANITIZERS: Set[str] = {
    "allreduce", "allreduce_", "grouped_allreduce", "allgather",
    "broadcast", "broadcast_", "broadcast_object", "broadcast_parameters",
    "broadcast_variables", "broadcast_optimizer_state", "sync_state",
}
# torch.distributed collectives that leave their FIRST positional
# argument identical on every member of the group: the reduced or
# broadcast tensor, the gathered list or tensor, the object list.
_TORCH_SANITIZERS: Set[str] = {
    "all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "broadcast_object_list",
}


def sanitizer_axes(node: ast.Call,
                   model: ModuleModel) -> Optional[List[str]]:
    """Axes along which this call's result is uniform, or None.

    A ``psum(x, A)`` result is uniform along A but still differs across
    the other axes; a world allreduce/broadcast result is uniform
    everywhere (returns ``["world"]``, treated as clearing all taint)."""
    name = astutil.call_name(node)
    if name in _TORCH_SANITIZERS and \
            astutil.is_torch_dist_call(node, model):
        return torch_group_axes(node, model)
    if name in _LAX_COLLECTIVES and name not in (
        "psum_scatter", "all_to_all", "ppermute", "pshuffle",
    ) and _laxish(node, model):
        axes = collective_axes(node, model)
        return axes
    if name in _WORLD_SANITIZERS and astutil.is_collective_call(
            node, model):
        for kw in node.keywords:
            if kw.arg == "axis_name":
                return axis_tokens(kw.value)
        return [WORLD]
    if name in ("hierarchical_allreduce", "hierarchical_all_gather") \
            and _hvdish(node, model):
        return collective_axes(node, model)
    return None


def inplace_sanitized(node: ast.Call, model: ModuleModel
                      ) -> Optional[Tuple[str, List[str]]]:
    """``(name, axes)`` when a ``torch.distributed`` sanitizer writes
    its result into a plain name in place (``dist.all_reduce(flag)``):
    from then on ``flag`` is uniform along ``axes``."""
    name = astutil.call_name(node)
    if name not in _TORCH_SANITIZERS or not node.args or \
            not isinstance(node.args[0], ast.Name) or \
            not astutil.is_torch_dist_call(node, model):
        return None
    return node.args[0].id, torch_group_axes(node, model)


# ---------------------------------------------------------------------------
# deterministic contracts (HVD012)
# ---------------------------------------------------------------------------

# Built-in contract surface: the serve scheduler module is documented as
# a pure state machine ("every rank derives the identical schedule" —
# serve/scheduler.py docstring, the serving HVD001 invariant), the page
# allocator's block tables feed the compiled decode step on every rank
# (serve/paged.py — a divergent table desyncs the decode math itself),
# and the trace sampler's verdict must be a pure function of the trace
# id (obs/trace.py, the tracing determinism contract).  "*" = every
# function in the module.
CONTRACT_REGISTRY: Dict[str, Set[str]] = {
    "horovod_tpu_torch/serve/scheduler.py": {"*"},
    "horovod_tpu_torch/serve/paged.py": {"*"},
    "horovod_tpu_torch/obs/trace.py": {"sampled"},
}

_CONTRACT_COMMENT_RE = re.compile(r"#\s*hvdtpu:\s*deterministic\b")


def contract_functions(model: ModuleModel) -> Dict[str, int]:
    """qualname -> def line of every function in ``model`` bound by a
    determinism contract (registry match or ``# hvdtpu: deterministic``
    on the def line / the line above)."""
    out: Dict[str, int] = {}
    registered = CONTRACT_REGISTRY.get(model.relpath, set())
    annotated: Set[int] = set()
    for i, line in enumerate(model.source.splitlines(), start=1):
        if _CONTRACT_COMMENT_RE.search(line):
            annotated.add(i)

    for qn, node in astutil.iter_defs(model.tree):
        lines = {node.lineno, node.lineno - 1}
        for deco in node.decorator_list:
            lines.add(deco.lineno - 1)
        if "*" in registered or qn in registered \
                or node.name in registered \
                or lines & annotated:
            out[qn] = node.lineno
    return out


# impure-input classifier: calls whose value differs per rank, per run,
# or per PYTHONHASHSEED — poison for a deterministic scheduler.
_IMPURE_MODULE_CALLS: Set[Tuple[str, str]] = {
    ("time", "time"), ("time", "monotonic"), ("time", "perf_counter"),
    ("time", "time_ns"), ("time", "monotonic_ns"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
    ("os", "urandom"), ("uuid", "uuid1"), ("uuid", "uuid4"),
    ("secrets", "token_hex"), ("secrets", "token_bytes"),
    ("random", "random"), ("random", "randint"), ("random", "choice"),
    ("random", "shuffle"), ("random", "sample"), ("random", "uniform"),
    ("random", "randrange"), ("random", "getrandbits"),
}
_IMPURE_BARE_CALLS: Set[str] = {"hash", "id"}
# torch draws from its process-global generator unless handed an
# explicit ``generator=``; seeding that global is impure too.
_TORCH_RNG_CALLS: Set[str] = {
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "bernoulli", "multinomial", "normal", "poisson",
    "manual_seed", "seed", "initial_seed",
}


def impurity_of_call(node: ast.Call,
                     model: ModuleModel) -> Optional[str]:
    """Why this call's result is not a deterministic function of its
    inputs, or None.  jax.random is exempt (explicit-key, deterministic
    by construction), and so is a torch draw from an explicit
    ``generator=`` (a ``torch.Generator`` seeded by the caller)."""
    name = astutil.call_name(node)
    recv = astutil.receiver_name(node)
    if recv is not None:
        target = model.module_aliases.get(recv, recv)
        if "jax" in target:
            return None
        if target.split(".")[0] == "torch" and name in _TORCH_RNG_CALLS:
            if any(kw.arg == "generator" for kw in node.keywords):
                return None
            return f"{target}.{name}() (torch's global generator)"
        base = target.rsplit(".", 1)[-1]
        if (base, name) in _IMPURE_MODULE_CALLS:
            return f"{base}.{name}()"
        # np.random.randint / random.choice / rng-module methods: any
        # call whose dotted receiver PATH contains a `random` segment
        # (the base-name check alone let `np.random.*` through).
        if recv != "self" and isinstance(node.func, ast.Attribute):
            segments = astutil.expr_text(node.func.value).split(".")
            segments[0] = target
            if any(seg == "random" for seg in segments):
                return f"{'.'.join(segments)}.{name}()"
    else:
        if name in _IMPURE_BARE_CALLS and isinstance(node.func, ast.Name):
            return f"{name}() (PYTHONHASHSEED/per-process value)"
        origin = model.from_imports.get(name or "")
        if origin is not None and (origin[0], origin[1]) in (
            ("time", "time"), ("time", "monotonic"),
            ("time", "perf_counter"),
        ):
            return f"{name}() [from {origin[0]}]"
    src = source_scope(node)
    if src is not None:
        return f"rank source {src[1]}"
    return None
