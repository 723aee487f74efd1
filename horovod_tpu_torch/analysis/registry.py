"""Rule registry: every check self-registers with its catalog entry.

Two families:

* ``HVD0xx`` — SPMD-correctness rules, run on user scripts, examples/
  and the library alike (module-local AST passes).
* ``HVDC1xx`` — concurrency rules, aimed at the library's own
  engine/obs/elastic threads (lock graph + signal-reachability passes;
  some need the whole project, see ``project_rules``).
"""

from __future__ import annotations

from typing import Callable, Dict, List

from .core import ModuleModel, Rule, Finding

# module-local rules: fn(model) -> [Finding]
_MODULE_RULES: List[tuple] = []
# project-wide rules: fn(models: list[ModuleModel]) -> [Finding]
_PROJECT_RULES: List[tuple] = []
_RULES: Dict[str, Rule] = {}


def rule(id: str, name: str, severity: str, summary: str, *,
         scope: str = "module") -> Callable:
    """Register a check.  The decorated function's docstring is the
    rule-catalog entry (it must contain a minimal failing example)."""

    def deco(fn: Callable) -> Callable:
        doc = (fn.__doc__ or "").strip()
        assert doc, f"rule {id} needs a catalog docstring"
        r = Rule(id=id, name=name, severity=severity, summary=summary,
                 doc=doc)
        assert id not in _RULES, f"duplicate rule id {id}"
        _RULES[id] = r
        entry = (r, fn)
        if scope == "module":
            _MODULE_RULES.append(entry)
        elif scope == "project":
            _PROJECT_RULES.append(entry)
        else:  # pragma: no cover - registration bug
            raise ValueError(f"unknown scope {scope!r}")
        return fn

    return deco


def _load() -> None:
    # Import for side effect: the @rule decorators populate the tables.
    from . import rules_spmd  # noqa: F401, PLC0415
    from . import rules_concurrency  # noqa: F401, PLC0415
    from . import rules_mesh  # noqa: F401, PLC0415
    from . import rules_races  # noqa: F401, PLC0415


def all_rules() -> Dict[str, Rule]:
    _load()
    return dict(_RULES)


def run_module_rules(model: ModuleModel) -> List[Finding]:
    _load()
    findings: List[Finding] = []
    for r, fn in _MODULE_RULES:
        findings.extend(fn(model))
    return findings


def run_project_rules(models: List[ModuleModel]) -> List[Finding]:
    _load()
    findings: List[Finding] = []
    for r, fn in _PROJECT_RULES:
        findings.extend(fn(models))
    return findings


def make_finding(rule_id: str, model: ModuleModel, line: int, col: int,
                 message: str, context: str) -> Finding:
    r = _RULES[rule_id]
    return Finding(
        rule=rule_id, severity=r.severity, path=model.relpath,
        line=line, col=col, message=message, context=context,
    )
