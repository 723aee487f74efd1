"""Baseline handling: the incremental gate.

A baseline entry acknowledges ONE known finding so the CI gate can be
strict about everything else.  Policy (enforced here, documented in
docs/analysis.md): the baseline is for *documented false-positive-prone
cases only* — every entry MUST carry a non-empty ``reason`` explaining
why the finding is not a defect.  True positives get fixed, not
baselined; an entry without a reason is rejected so "baseline it to
shut it up" cannot pass review silently.

Matching is by (rule, path, context) — context is a stable anchor
(enclosing function qualname / lock pair), so line-number drift from
unrelated edits never invalidates the baseline.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from .core import Finding

BASELINE_SCHEMA = "hvdtpu-lint-baseline-v1"


class BaselineError(ValueError):
    pass


def load_baseline(path: str) -> Dict[Tuple[str, str, str], dict]:
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("schema") != BASELINE_SCHEMA:
        raise BaselineError(
            f"{path}: expected schema {BASELINE_SCHEMA!r}, got "
            f"{doc.get('schema')!r}"
        )
    out: Dict[Tuple[str, str, str], dict] = {}
    for i, entry in enumerate(doc.get("entries", [])):
        for field in ("rule", "path", "context", "reason"):
            if not str(entry.get(field, "")).strip():
                raise BaselineError(
                    f"{path}: entry {i} is missing {field!r} — baseline "
                    f"entries must name the finding AND justify why it "
                    f"is a false positive (fix true positives instead)"
                )
        key = (entry["rule"], entry["path"], entry["context"])
        if key in out:
            raise BaselineError(f"{path}: duplicate entry for {key}")
        out[key] = entry
    return out


def apply_baseline(
    findings: List[Finding],
    baseline: Dict[Tuple[str, str, str], dict],
) -> Tuple[List[Finding], List[dict]]:
    """Mark matched findings; returns (findings, unused_entries)."""
    used: set = set()
    for f in findings:
        if f.status != "new":
            continue
        if f.key() in baseline:
            f.status = "baselined"
            used.add(f.key())
    unused = [e for k, e in baseline.items() if k not in used]
    return findings, unused


def prune_baseline(path: str, stale: List[dict]) -> int:
    """Remove ``stale`` entries (as returned by :func:`apply_baseline`)
    from the baseline file in place, preserving every surviving entry
    byte-for-byte (reasons are curated text).  Returns the number
    removed.  Stale suppressions are drift: an entry whose finding no
    longer fires either acknowledges a fixed defect (remove it) or —
    worse — will silently swallow a *future* finding at the same
    (rule, path, context) that has nothing to do with the original
    justification."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("schema") != BASELINE_SCHEMA:
        raise BaselineError(
            f"{path}: expected schema {BASELINE_SCHEMA!r}, got "
            f"{doc.get('schema')!r}"
        )
    stale_keys = {
        (e["rule"], e["path"], e["context"]) for e in stale
    }
    entries = doc.get("entries", [])
    kept = [
        e for e in entries
        if (e.get("rule"), e.get("path"), e.get("context"))
        not in stale_keys
    ]
    removed = len(entries) - len(kept)
    if removed:
        doc["entries"] = kept
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2, sort_keys=False)
            f.write("\n")
    return removed


def write_baseline(
    path: str,
    findings: List[Finding],
    reason: str,
    existing: Optional[Dict[Tuple[str, str, str], dict]] = None,
) -> int:
    """Emit entries for every non-suppressed finding (dev convenience;
    the loader still rejects empty reasons, so new entries need a real
    justification before the file loads).  Entries already present in
    ``existing`` keep their curated reasons — regenerating over the
    committed baseline must never clobber the human justifications."""
    entries = []
    seen = set()
    existing = existing or {}
    for f in findings:
        if f.status == "suppressed":
            continue
        if f.key() in seen:
            continue
        seen.add(f.key())
        prior = existing.get(f.key())
        entries.append({
            "rule": f.rule,
            "path": f.path,
            "context": f.context,
            "reason": prior["reason"] if prior else reason,
            "message": f.message,
        })
    doc = {"schema": BASELINE_SCHEMA, "entries": entries}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, sort_keys=False)
        fh.write("\n")
    return len(entries)
