"""Per-file analysis cache: content-hash keyed findings + taint summaries.

O'Hearn's continuous-reasoning bar is "runs on every diff": the lint
only stays in the commit loop if the commit loop stays fast.  A full
cold run re-parses and re-walks every file for every rule family; on a
typical diff almost none of that changed.  This cache persists, per
file and keyed by the sha256 of its content,

* the **module-scope findings** (sound to reuse: module rules see only
  that one file), and
* the **taint summaries** (:mod:`taint`'s compositional per-function
  facts — the local phase of the interprocedural closure, also purely
  content-derived).

Project-scope rules (lock graph, HVD010/HVD012 closures) still run
every time — their verdicts depend on *other* files — but they start
from the cached summaries, so the warm path skips every per-function
AST walk for unchanged files.

The cache is advisory everywhere: any corruption, schema drift, or
rule-set change (new rule IDs would make cached finding lists stale)
invalidates it wholesale and the run silently recomputes.  It never
affects findings, only wall clock.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional

from .core import Finding

CACHE_SCHEMA = "hvdtpu-lint-cache-v1"
DEFAULT_CACHE_PATH = ".hvdtpu-torch-lint-cache.json"


_SALT_MEMO: Optional[str] = None


def _rules_salt() -> str:
    """Rule IDs + a digest of the analyzer's own sources: editing a
    rule's logic (same IDs) must invalidate cached findings too, or the
    new logic would never run on unchanged files."""
    global _SALT_MEMO
    if _SALT_MEMO is not None:
        return _SALT_MEMO
    import hashlib  # noqa: PLC0415

    # Late import: registry imports the rule modules, which import this
    # package's siblings — keep cache importable standalone.
    from . import registry  # noqa: PLC0415

    h = hashlib.sha256()
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    for fn in sorted(os.listdir(pkg_dir)):
        if not fn.endswith(".py"):
            continue
        try:
            with open(os.path.join(pkg_dir, fn), "rb") as f:
                h.update(fn.encode())
                h.update(f.read())
        except OSError:
            pass
    _SALT_MEMO = ",".join(sorted(registry.all_rules())) \
        + ":" + h.hexdigest()[:16]
    return _SALT_MEMO


def load_cache(path: str) -> Dict[str, dict]:
    """relpath -> {"key": sha, "module_findings": [...], "taint": {...}}.
    Empty on any mismatch or damage — the cache is advisory."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return {}
    if not isinstance(doc, dict) or doc.get("schema") != CACHE_SCHEMA:
        return {}
    if doc.get("rules") != _rules_salt():
        return {}  # rule set changed: every cached finding list is stale
    files = doc.get("files")
    return files if isinstance(files, dict) else {}


def save_cache(path: str, files: Dict[str, dict]) -> None:
    """Atomic best-effort write (a torn cache must never be loadable).

    ``json.dumps`` (one string), not ``json.dump``: the stream form
    encodes with the pure-Python iterator and was 7 s of a warm run;
    the one-shot form takes the C encoder."""
    doc = {"schema": CACHE_SCHEMA, "rules": _rules_salt(), "files": files}
    try:
        blob = json.dumps(doc, separators=(",", ":"))
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".hvdtpu-torch-lint-cache.")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write(blob)
            os.replace(tmp, path)
        except BaseException:
            os.unlink(tmp)
            raise
    except OSError:
        pass  # read-only checkout / full disk: run stays correct, just cold


def findings_from_entry(entry: dict, relpath: str) -> Optional[List[Finding]]:
    """Deserialize one file's cached module findings; None = unusable."""
    raw = entry.get("module_findings")
    if not isinstance(raw, list):
        return None
    out: List[Finding] = []
    for d in raw:
        try:
            f = Finding(
                rule=str(d["rule"]), severity=str(d["severity"]),
                path=relpath, line=int(d["line"]), col=int(d["col"]),
                message=str(d["message"]), context=str(d["context"]),
            )
        except (KeyError, TypeError, ValueError):
            return None
        out.append(f)
    return out


def entry_for(key: str, module_findings: List[Finding],
              taint_summaries: Optional[Dict[str, dict]]) -> dict:
    return {
        "key": key,
        "module_findings": [
            {"rule": f.rule, "severity": f.severity, "line": f.line,
             "col": f.col, "message": f.message, "context": f.context}
            for f in module_findings
        ],
        "taint": taint_summaries or {},
    }
