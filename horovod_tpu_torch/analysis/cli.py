"""hvdtpu-lint CLI: ``python -m horovod_tpu_torch.analysis [paths] ...``.

Exit codes: 0 = clean (every finding suppressed or baselined),
1 = new findings, 2 = usage/configuration error.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import baseline as baseline_mod
from . import cache as cache_mod
from . import registry
from . import taint
from .config import LintConfig, load_config
from .core import SCHEMA, Finding, ModuleModel, is_suppressed, load_module


def _iter_py_files(paths: Sequence[str], exclude: Sequence[str],
                   root: str) -> List[str]:
    out: List[str] = []
    seen: Set[str] = set()
    excl = [os.path.normpath(os.path.join(root, e)) for e in exclude]

    def excluded(p: str) -> bool:
        np_ = os.path.normpath(p)
        return any(np_ == e or np_.startswith(e + os.sep) for e in excl)

    for p in paths:
        ap = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(ap) and ap.endswith(".py"):
            if not excluded(ap) and ap not in seen:
                seen.add(ap)
                out.append(ap)
        elif os.path.isdir(ap):
            for dirpath, dirnames, filenames in os.walk(ap):
                dirnames[:] = [
                    d for d in sorted(dirnames)
                    if d != "__pycache__"
                    and not excluded(os.path.join(dirpath, d))
                ]
                for fn in sorted(filenames):
                    fp = os.path.join(dirpath, fn)
                    if fn.endswith(".py") and not excluded(fp) \
                            and fp not in seen:
                        seen.add(fp)
                        out.append(fp)
    return out


def _changed_files(root: str) -> List[str]:
    """Working-tree changes vs HEAD plus untracked files — the local
    pre-commit loop's file set.

    ``--name-status`` (not ``--name-only``) so deletions are dropped
    and renames contribute their NEW path: a plain name listing hands
    back paths that no longer exist (the D side of a delete, the old
    side of a rename), which then crash the per-file loop.

    ``-z`` so records are NUL-separated: the text form C-quotes paths
    containing tabs/newlines/non-ASCII, which a tab-split mangles into
    a path that isn't on disk.  A ``-z`` record is ``status NUL path``
    (two paths for R/C, old then new)."""
    files: Set[str] = set()
    try:
        res = subprocess.run(
            ["git", "diff", "--name-status", "-z", "-M", "HEAD"],
            cwd=root, capture_output=True, text=True,
            timeout=30, check=True,
        )
        toks = res.stdout.split("\0")
        i = 0
        while i < len(toks):
            status = toks[i]
            i += 1
            if not status:
                continue  # trailing NUL
            npaths = 2 if status[:1] in ("R", "C") else 1
            rec = toks[i:i + npaths]
            i += npaths
            if len(rec) < npaths:
                break  # torn record: trust only complete ones
            if status.startswith("D"):
                continue  # deleted: nothing on disk to lint
            # R100 old new / C90 src dst: the last path is the one that
            # exists in the working tree now.
            files.add(rec[-1])
        res = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard", "-z"],
            cwd=root, capture_output=True, text=True,
            timeout=30, check=True,
        )
        files.update(t for t in res.stdout.split("\0") if t)
    except (OSError, subprocess.SubprocessError) as e:
        # exit 2: environment/usage error — never 1, which the
        # documented contract reserves for "new findings".
        print(f"hvdtpu-lint: --changed needs git: {e}",
              file=sys.stderr)
        raise SystemExit(2)
    # Belt and braces: a checkout can still race the diff (a file
    # deleted between the two git calls, an unmerged path) — only paths
    # that exist right now are lintable.
    return sorted(
        f for f in files
        if f.endswith(".py") and os.path.isfile(os.path.join(root, f))
    )


def _lint_one(job: Tuple[str, str]) -> Tuple[str, Optional[dict]]:
    """``--jobs`` worker: one file's module findings plus its taint
    local phase, returned in **cache-entry shape** (plain JSON types).

    That shape is the whole trick: the result pickles cheaply across
    the process boundary, the parent validates it with the exact same
    ``findings_from_entry``/``seed_summary_memo`` path a warm on-disk
    cache hit takes, and it slots verbatim into the merged cache — so
    parallelism cannot make the cache incoherent without also breaking
    the (well-tested) cache read path."""
    path, rel = job
    model = load_module(path, rel)
    if model is None:
        return rel, None  # parse error: the parent re-reports it
    key = taint.content_key(model.source)
    module_findings = registry.run_module_rules(model)
    taint.module_taint_cached(model)  # force the local phase for dump
    return rel, cache_mod.entry_for(
        key, module_findings, taint.dump_summary_memo(key))


def analyze_paths(
    paths: Sequence[str],
    *,
    root: Optional[str] = None,
    exclude: Sequence[str] = (),
    rules: Optional[Set[str]] = None,
    cache_path: Optional[str] = None,
    jobs: int = 1,
) -> List[Finding]:
    """Library entry point: lint ``paths`` (files or directories),
    returning findings with suppression status applied (baseline is the
    CLI's job).

    ``cache_path`` (optional) points at the per-file analysis cache:
    unchanged files reuse their module-scope findings and taint
    summaries by content hash; project-scope rules always re-run (their
    verdicts span files) but start from the cached summaries.

    ``jobs`` > 1 fans the per-file work (module rules + taint local
    phase) for cache MISSES out over worker processes; cache hits and
    project-scope rules stay in-process, so the on-disk cache and the
    interprocedural closures behave identically to a serial run.
    """
    root = os.path.abspath(root or os.getcwd())
    files = _iter_py_files(paths, exclude, root)
    cached = cache_mod.load_cache(cache_path) if cache_path else {}
    new_cache: Dict[str, dict] = {}
    models: List[ModuleModel] = []
    findings: List[Finding] = []
    for path in files:
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        model = load_module(path, rel)
        if model is None:
            findings.append(Finding(
                rule="PARSE", severity="error", path=rel, line=1, col=0,
                message="file does not parse; fix the syntax error "
                        "first", context="<module>",
            ))
            continue
        models.append(model)
    dirty = False
    misses: List[ModuleModel] = []
    for model in models:
        key = taint.content_key(model.source)
        entry = cached.get(model.relpath)
        module_findings: Optional[List[Finding]] = None
        if entry is not None and entry.get("key") == key:
            module_findings = cache_mod.findings_from_entry(
                entry, model.relpath)
            raw_taint = entry.get("taint")
            if isinstance(raw_taint, dict) and raw_taint:
                taint.seed_summary_memo(key, raw_taint)
        else:
            entry = None
        if module_findings is None:
            misses.append(model)
            continue
        findings.extend(module_findings)
        if cache_path:
            new_cache[model.relpath] = (key, module_findings, entry)
    worker_entries: Dict[str, dict] = {}
    if jobs > 1 and len(misses) > 1:
        try:
            # fork where available (Linux): the workers inherit the
            # imported rule modules instead of re-importing them.
            try:
                ctx = multiprocessing.get_context("fork")
            except ValueError:
                ctx = multiprocessing.get_context()
            nproc = min(jobs, len(misses))
            with ctx.Pool(nproc) as pool:
                results = pool.map(
                    _lint_one,
                    [(m.path, m.relpath) for m in misses],
                    chunksize=max(1, len(misses) // (nproc * 4)),
                )
            worker_entries = {
                rel: entry for rel, entry in results
                if entry is not None
            }
        except OSError:
            worker_entries = {}  # no fds / sandboxed: serial fallback
    for model in misses:
        key = taint.content_key(model.source)
        entry: Optional[dict] = worker_entries.get(model.relpath)
        module_findings = None
        if entry is not None and entry.get("key") == key:
            # Same validation path as an on-disk cache hit; anything
            # malformed falls through to in-process recompute.
            module_findings = cache_mod.findings_from_entry(
                entry, model.relpath)
            raw_taint = entry.get("taint")
            if isinstance(raw_taint, dict) and raw_taint:
                taint.seed_summary_memo(key, raw_taint)
        else:
            entry = None
        if module_findings is None:
            module_findings = registry.run_module_rules(model)
            entry = None
        dirty = True
        findings.extend(module_findings)
        if cache_path:
            new_cache[model.relpath] = (key, module_findings, entry)
    findings.extend(registry.run_project_rules(models))
    if cache_path and dirty:
        # Dump AFTER the project rules: their closures force the taint
        # local phase for every model, so the summaries exist now.
        # All-hit runs skip the write entirely, and hit entries are
        # carried over verbatim — re-serializing identical summaries
        # was most of the warm-path cost.  MERGE with the prior cache:
        # a --changed run analyzes a file subset and must not clobber
        # the other files' entries; entries whose file left the disk
        # are dropped.
        merged = {
            rel: entry for rel, entry in cached.items()
            if os.path.isfile(os.path.join(root, rel))
        }
        for rel, (key, module_findings, prior) in new_cache.items():
            merged[rel] = prior if prior is not None else \
                cache_mod.entry_for(
                    key, module_findings,
                    taint.dump_summary_memo(key),
                )
        cache_mod.save_cache(cache_path, merged)
    if rules:
        findings = [f for f in findings if f.rule in rules or
                    f.rule == "PARSE"]
    by_rel: Dict[str, ModuleModel] = {m.relpath: m for m in models}
    for f in findings:
        model = by_rel.get(f.path)
        if model is not None and is_suppressed(f, model.suppressions):
            f.status = "suppressed"
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def _format_text(findings: List[Finding]) -> str:
    lines = []
    for f in findings:
        if f.status != "new":
            continue
        lines.append(
            f"{f.path}:{f.line}:{f.col}: {f.rule} [{f.severity}] "
            f"{f.message}"
        )
    counts = _counts(findings)
    lines.append(
        f"hvdtpu-lint: {counts['new']} new finding(s), "
        f"{counts['baselined']} baselined, "
        f"{counts['suppressed']} suppressed"
    )
    return "\n".join(lines)


def _counts(findings: List[Finding]) -> Dict[str, int]:
    return {
        "total": len(findings),
        "new": sum(1 for f in findings if f.status == "new"),
        "baselined": sum(1 for f in findings if f.status == "baselined"),
        "suppressed": sum(
            1 for f in findings if f.status == "suppressed"
        ),
    }


def _format_json(findings: List[Finding]) -> str:
    rules = registry.all_rules()
    doc = {
        "schema": SCHEMA,
        "rules": {
            rid: {
                "name": r.name,
                "severity": r.severity,
                "summary": r.summary,
            }
            for rid, r in sorted(rules.items())
        },
        "findings": [f.as_dict() for f in findings],
        "summary": _counts(findings),
    }
    return json.dumps(doc, indent=2)


def _list_rules() -> str:
    lines = []
    for rid, r in sorted(registry.all_rules().items()):
        lines.append(f"{rid}  {r.severity:<7}  {r.name}: {r.summary}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.analysis",
        description="hvdtpu-lint: SPMD-correctness and concurrency "
                    "static analyzer for horovod_tpu_torch code",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to lint (default: [tool.hvdtpu-torch-lint] "
             "paths from pyproject.toml)",
    )
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument(
        "--baseline", metavar="FILE", default=None,
        help="baseline JSON; known findings listed there (with a "
             "reason) don't fail the run (default: from pyproject)",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="ignore any configured baseline (report everything)",
    )
    parser.add_argument(
        "--prune-baseline", action="store_true",
        help="remove baseline entries whose finding no longer fires "
             "(full-surface runs only: a partial view cannot judge "
             "staleness)",
    )
    parser.add_argument(
        "--strict-baseline", action="store_true",
        help="exit 1 when the baseline carries stale entries (CI drift "
             "gate; full-surface runs only)",
    )
    parser.add_argument(
        "--jobs", "-j", type=int, default=1, metavar="N",
        help="analyze files with N worker processes (per-file rules + "
             "taint local phase; project-scope rules stay in-process); "
             "0 = one per CPU",
    )
    parser.add_argument(
        "--no-cache", action="store_true",
        help="skip the per-file analysis cache (content-hash keyed "
             "module findings + taint summaries)",
    )
    parser.add_argument(
        "--changed", action="store_true",
        help="lint only files changed vs HEAD (plus untracked) — the "
             "fast local pre-commit loop",
    )
    parser.add_argument(
        "--rules", metavar="IDS", default=None,
        help="comma-separated rule IDs to run (default: all)",
    )
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument(
        "--write-baseline", metavar="FILE", default=None,
        help="write current findings as a baseline skeleton (reasons "
             "must be filled in before the file loads)",
    )
    parser.add_argument(
        "--root", default=None,
        help="repo root for relative paths/config (default: cwd)",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        print(_list_rules())
        return 0

    root = os.path.abspath(args.root or os.getcwd())
    # Staleness is only decidable on the full surface with every rule:
    # a --changed/--rules/explicit-path run sees a subset, so "entry
    # didn't match" means "entry wasn't looked at", not "fixed".
    partial_view = bool(args.changed or args.rules or args.paths)
    if (args.prune_baseline or args.strict_baseline) and partial_view:
        which = "--prune-baseline" if args.prune_baseline \
            else "--strict-baseline"
        print(f"hvdtpu-lint: {which} needs a full-surface run — drop "
              f"--changed/--rules/explicit paths", file=sys.stderr)
        return 2
    try:
        cfg: LintConfig = load_config(root)
    except ValueError as e:
        # Config errors are exit-code 2, same as every other usage
        # error — never 1, which scripts read as "findings".
        print(f"hvdtpu-lint: bad [tool.hvdtpu-torch-lint] config: {e}",
              file=sys.stderr)
        return 2
    paths = list(args.paths) or list(cfg.paths)
    if args.changed:
        changed = _changed_files(root)
        # intersect with the configured lint surface
        surface = [
            os.path.normpath(p) for p in paths
        ]

        def in_surface(rel: str) -> bool:
            np_ = os.path.normpath(rel)
            return any(
                np_ == s or np_.startswith(s + os.sep) for s in surface
            ) or np_ in surface
        paths = [f for f in changed if in_surface(f)]
        if not paths:
            print("hvdtpu-lint: no changed python files under the lint "
                  "surface; nothing to do")
            return 0

    rules_filter: Optional[Set[str]] = None
    if args.rules:
        known = set(registry.all_rules())
        rules_filter = {r.strip() for r in args.rules.split(",")
                        if r.strip()}
        unknown = rules_filter - known
        if unknown:
            print(f"hvdtpu-lint: unknown rule id(s): "
                  f"{', '.join(sorted(unknown))}", file=sys.stderr)
            return 2

    cache_path: Optional[str] = None
    if cfg.cache and not args.no_cache:
        cache_path = cfg.cache if os.path.isabs(cfg.cache) else \
            os.path.join(root, cfg.cache)

    jobs = args.jobs
    if jobs < 0:
        print(f"hvdtpu-lint: --jobs must be >= 0, got {jobs}",
              file=sys.stderr)
        return 2
    if jobs == 0:
        jobs = os.cpu_count() or 1

    try:
        findings = analyze_paths(
            paths, root=root, exclude=cfg.exclude, rules=rules_filter,
            cache_path=cache_path, jobs=jobs,
        )
    except ValueError as e:  # config errors
        print(f"hvdtpu-lint: {e}", file=sys.stderr)
        return 2

    loaded_baseline: dict = {}
    stale_rc = 0
    baseline_path = args.baseline or cfg.baseline
    if baseline_path and not args.no_baseline:
        bp = baseline_path if os.path.isabs(baseline_path) else \
            os.path.join(root, baseline_path)
        if os.path.isfile(bp):
            try:
                bl = baseline_mod.load_baseline(bp)
            except (baseline_mod.BaselineError, OSError,
                    json.JSONDecodeError) as e:
                print(f"hvdtpu-lint: bad baseline: {e}", file=sys.stderr)
                return 2
            loaded_baseline = bl
            findings, unused = baseline_mod.apply_baseline(findings, bl)
            # Unused entries are only meaningful on a full-surface,
            # all-rules run; a --changed run sees a file subset and a
            # --rules run a rule subset — both would cry wolf.
            if unused and not partial_view:
                if args.prune_baseline:
                    removed = baseline_mod.prune_baseline(bp, unused)
                    for e in unused:
                        print(
                            f"hvdtpu-lint: pruned stale baseline entry: "
                            f"{e['rule']} {e['path']} {e['context']}",
                            file=sys.stderr,
                        )
                    print(f"hvdtpu-lint: removed {removed} stale "
                          f"baseline entr(y/ies) from {baseline_path}",
                          file=sys.stderr)
                else:
                    for e in unused:
                        print(
                            f"hvdtpu-lint: note: baseline entry no "
                            f"longer matches anything (fixed? remove "
                            f"it): {e['rule']} {e['path']} "
                            f"{e['context']}",
                            file=sys.stderr,
                        )
                    if args.strict_baseline:
                        print(
                            f"hvdtpu-lint: --strict-baseline: "
                            f"{len(unused)} stale baseline entr(y/ies) "
                            f"— run --prune-baseline (or delete them) "
                            f"so dead suppressions cannot swallow "
                            f"future findings", file=sys.stderr,
                        )
                        stale_rc = 1

    if args.write_baseline:
        n = baseline_mod.write_baseline(
            args.write_baseline, findings,
            reason="",  # intentionally invalid: forces a human reason
            existing=loaded_baseline,  # keep curated reasons
        )
        print(f"hvdtpu-lint: wrote {n} baseline entr(y/ies) to "
              f"{args.write_baseline}; fill in every NEW entry's "
              f"'reason' before committing (empty reasons are rejected "
              f"on load; existing entries kept theirs)")

    out = _format_json(findings) if args.format == "json" else \
        _format_text(findings)
    print(out)
    if any(f.status == "new" for f in findings):
        return 1
    return stale_rc
