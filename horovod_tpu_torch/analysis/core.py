"""Core data model for hvdtpu-lint: findings, rules, suppressions.

Design constraints (why this is its own subsystem and not a flake8
plugin): the invariants worth checking here are *distributed-systems*
invariants — every rank must submit the same collective schedule, and
the engine/obs/elastic threads plus the signal-based death hooks must
respect lock discipline — which need project-level passes (a lock
graph, a signal-handler reachability walk) no line-oriented linter
offers.  Following RacerD's lesson (Blackshear et al., 2018), the
analyses are deliberately *syntactic and compositional*: no whole-
program points-to, no inter-procedural dataflow — per-function
summaries stitched by name, which keeps the full-repo run under a
second and the false-positive rate low enough to gate CI on.

Everything in this package is stdlib-only on purpose: the linter must
run in CI images and pre-commit hooks without torch resolving.
"""

from __future__ import annotations

import ast
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

SCHEMA = "hvdtpu-lint-v1"

# The package this analyzer lints: its modules are library code, and
# names imported from it are the Horovod surface.
PACKAGE = "horovod_tpu_torch"

SEV_ERROR = "error"
SEV_WARNING = "warning"

# `# hvdtpu: disable=HVD001,HVDC102` on the offending line or the line
# directly above it.  `disable=all` silences every rule for that line.
_SUPPRESS_RE = re.compile(
    r"#\s*hvdtpu:\s*disable=([A-Za-z0-9_,\s]+)"
)


@dataclass(frozen=True)
class Rule:
    """One check.  ``doc`` carries the rule catalog entry, including a
    minimal failing example (docs/analysis.md is generated from these,
    so the catalog can never drift from the implementation)."""

    id: str
    name: str
    severity: str
    summary: str
    doc: str


@dataclass
class Finding:
    rule: str
    severity: str
    path: str        # repo-relative, '/'-separated
    line: int
    col: int
    message: str
    # Stable anchor for baseline matching: line numbers shift on every
    # edit, so the baseline keys on (rule, path, context) instead —
    # usually the enclosing function's qualname.
    context: str
    status: str = "new"  # new | baselined | suppressed

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.context)

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "context": self.context,
            "status": self.status,
        }


def parse_suppressions(source: str) -> Dict[int, Set[str]]:
    """Map line number -> set of rule IDs disabled there.

    Comments are found with the tokenizer, not a regex over raw lines,
    so a ``# hvdtpu:`` inside a string literal never suppresses
    anything."""
    out: Dict[int, Set[str]] = {}
    try:
        tokens = tokenize.generate_tokens(
            iter(source.splitlines(keepends=True)).__next__
        )
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            ids = {p.strip() for p in m.group(1).split(",") if p.strip()}
            out.setdefault(tok.start[0], set()).update(ids)
    except (tokenize.TokenError, SyntaxError, IndentationError):
        pass  # unparseable file: reported as a parse error elsewhere
    return out


def is_suppressed(
    finding: Finding, suppressions: Dict[int, Set[str]]
) -> bool:
    for line in (finding.line, finding.line - 1):
        ids = suppressions.get(line)
        if ids and (finding.rule in ids or "all" in ids):
            return True
    return False


@dataclass
class ModuleModel:
    """One parsed file plus the name-resolution facts every rule needs."""

    path: str          # absolute
    relpath: str       # repo-relative, '/'-separated (finding paths)
    source: str
    tree: ast.Module
    # Names bound to the horovod_tpu_torch package or a submodule of it
    # ("hvd", "horovod_tpu_torch", "collectives", ...).
    hvd_aliases: Set[str] = field(default_factory=set)
    # from-import local name -> (module, original name); module ""
    # for relative imports inside the package itself.
    from_imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    # import alias -> full module path ("np" -> "numpy").
    module_aliases: Dict[str, str] = field(default_factory=dict)
    suppressions: Dict[int, Set[str]] = field(default_factory=dict)
    # Memo slot for astutil.enclosing_function_map: every rule family
    # asks for the line->qualname map, and rebuilding it per rule was
    # the single largest cost in a full-surface run.
    fmap_cache: Optional[Dict[int, str]] = field(
        default=None, repr=False, compare=False,
    )
    # Memo slot for meshmodel's names bound to axis groups.
    group_axes_cache: Optional[Dict[str, List[str]]] = field(
        default=None, repr=False, compare=False,
    )

    @property
    def is_package_module(self) -> bool:
        return f"{PACKAGE}/" in self.relpath or self.relpath.startswith(
            PACKAGE
        )


def load_module(path: str, relpath: str) -> Optional[ModuleModel]:
    """Parse one file; returns None (caller reports) on syntax errors."""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return None
    model = ModuleModel(
        path=path, relpath=relpath, source=source, tree=tree,
        suppressions=parse_suppressions(source),
    )
    _collect_imports(model)
    return model


_HVD_PREFIXES = (PACKAGE,)


def _is_hvd_module(modname: str) -> bool:
    return any(
        modname == p or modname.startswith(p + ".") for p in _HVD_PREFIXES
    )


def _collect_imports(model: ModuleModel) -> None:
    for node in ast.walk(model.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".")[0]
                model.module_aliases[local] = alias.name
                if _is_hvd_module(alias.name):
                    model.hvd_aliases.add(local)
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            relative = node.level and node.level > 0
            in_pkg = PACKAGE in model.relpath
            hvdish = _is_hvd_module(mod) or (relative and in_pkg)
            for alias in node.names:
                local = alias.asname or alias.name
                model.from_imports[local] = (mod, alias.name)
                # `from horovod_tpu_torch import elastic` / `from . import obs`
                # bind a *module* name.
                if hvdish:
                    model.hvd_aliases.add(local)
