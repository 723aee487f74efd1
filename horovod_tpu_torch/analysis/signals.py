"""Signal-handler reachability: which functions can run in async-signal
context, and what they are allowed to do there.

Roots:

* handlers registered with ``signal.signal(sig, fn)``;
* callbacks registered with ``on_death(fn)`` / ``flightrec.on_death(fn)``
  — the shared death-path ``flush()`` runs them *from inside the fatal-
  signal handlers* (obs/flightrec.py), so they inherit the handler's
  constraints.

The flight recorder's post-mortem found this class of bug by dying
from it: a
SIGTERM landing inside a SIGUSR1 flush re-entered the flush path on the
same thread, and every non-reentrant lock on that path self-deadlocked
the dying rank.  The reachability pass makes that shape un-commitable:
a signal handler can interrupt the owning thread *between any two
bytecodes*, so anything it calls must only take reentrant locks
(HVDC103), must not log through non-reentrant logging handlers
(HVDC104), and must not grow memory without bound (HVDC107).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from . import astutil
from .core import ModuleModel
from .lockgraph import CallGraph

FuncKey = Tuple[str, str]

_DEATH_REGISTRARS = {"on_death"}


def find_roots(graph: CallGraph) -> Dict[FuncKey, str]:
    """root function -> how it becomes signal-reachable."""
    roots: Dict[FuncKey, str] = {}
    for key, info in graph.funcs.items():
        module, qualname = key
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            name = astutil.call_name(node)
            recv = astutil.receiver_name(node)
            handler_args: List[ast.expr] = []
            why = ""
            if name == "signal" and recv == "signal" and \
                    len(node.args) >= 2:
                handler_args = [node.args[1]]
                why = f"registered as a signal handler in {qualname}()"
            elif name in _DEATH_REGISTRARS and node.args:
                handler_args = [node.args[0]]
                why = (
                    f"registered via {name}() in {qualname}() — death "
                    f"callbacks run inside the fatal-signal flush"
                )
            for arg in handler_args:
                for target in _resolve_handler(graph, key, arg):
                    roots.setdefault(target, why)
    return roots


def _resolve_handler(graph: CallGraph, caller: FuncKey,
                     arg: ast.expr) -> List[FuncKey]:
    if isinstance(arg, ast.Name):
        return graph.resolve(caller, ("bare", arg.id))
    if isinstance(arg, ast.Attribute):
        v = arg.value
        if isinstance(v, ast.Name):
            if v.id == "self":
                return graph.resolve(caller, ("self", arg.attr))
            return graph.resolve(caller, ("mod", (v.id, arg.attr)))
        return graph.resolve(caller, ("attr", arg.attr))
    return []


def reachable_from(
    graph: CallGraph, roots: Dict[FuncKey, str]
) -> Dict[FuncKey, List[str]]:
    """BFS closure; value = call chain (qualnames) from a root."""
    out: Dict[FuncKey, List[str]] = {}
    queue: List[Tuple[FuncKey, List[str]]] = []
    for root, why in roots.items():
        chain = [f"{root[1]} ({why})"]
        out[root] = chain
        queue.append((root, chain))
    while queue:
        key, chain = queue.pop(0)
        info = graph.funcs.get(key)
        if info is None:
            continue
        for call in info.calls:
            for callee in graph.resolve(key, call):
                if callee in out:
                    continue
                nchain = chain + [callee[1]]
                out[callee] = nchain
                queue.append((callee, nchain))
    return out


def format_chain(chain: List[str]) -> str:
    return " -> ".join(chain)
