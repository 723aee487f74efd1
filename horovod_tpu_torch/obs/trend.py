"""Perf-trend observatory over the benchmark records' trajectory.

The repo's ``BENCH_r*.json`` / ``MULTICHIP_r*.json`` records are the
only durable perf evidence this project has, and they span every schema
era since r01 (bare parsed payloads without a ``device`` key, degraded
CPU fallbacks, serve records, failed dark rounds).  This module is the
ONE place that knows how to read them:

* **classification** — ``classify()`` partitions a record into
  ``real`` / ``degraded`` / ``failed``.  ``scripts/perf_gate.py``,
  ``bench.py``'s regression sentinel and ``scripts/perf_report.py``
  all import it from here, so "what counts as a real measurement" can
  never fork between the gate and the sentinel.
* **EWMA baselines** — ``ewma_baseline()`` folds the last K real
  records of a scenario ``(metric, device)`` into an exponentially
  weighted baseline, replacing the single-newest-record bar: one lucky
  (or unlucky) round no longer owns the regression threshold.
* **degraded-streak verdict** — ``degraded_streak()`` names the dark
  trajectory out loud ("N consecutive records without a real
  measurement; last real number is BENCH_r02.json ...") so it
  self-announces in every fresh record, the live digest and the
  ``--stats-summary`` table instead of waiting for someone to notice.
* **rendering** — ``render_markdown()`` emits the trajectory +
  baseline tables ``scripts/perf_report.py`` writes into
  ``docs/performance.md``.

Everything here is stdlib-only and read-only over the record dir; every
public entry is total (returns empty/None on an unreadable dir) because
trend accounting must never sink the measurement or digest it rides in.

A copy of the reference's ``horovod_tpu/obs/trend.py``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

__all__ = [
    "classify", "parsed_payload", "scenario_key",
    "load_bench_records", "load_multichip_records",
    "ewma_baseline", "degraded_streak", "trend_stamp",
    "trajectory", "render_markdown",
    "EWMA_K", "EWMA_ALPHA", "repo_record_dir",
]

# EWMA over the last K real records per scenario.  alpha=0.5 halves a
# record's weight per newer record: the newest real number dominates
# (weight 0.5) but a single outlier round can no longer own the bar.
EWMA_K = 5
EWMA_ALPHA = 0.5

# The records' directory.  The reference defaults to its repo root, where
# its BENCH_r*.json records land; those are the reference's TPU records,
# not the port's, so here the trend plane reads only a directory named by
# HVDTPU_RECORD_DIR, and sees no records otherwise.
RECORD_DIR_ENV = "HVDTPU_RECORD_DIR"


def repo_record_dir() -> Optional[str]:
    return os.environ.get(RECORD_DIR_ENV) or None


# --------------------------------------------------------------- loading

def _load_glob(record_dir: str, pattern: str) -> List[Tuple[int, str, dict]]:
    """[(round n, filename, doc)] sorted by round; unreadable files are
    skipped (one corrupt record must not blind the observatory to the
    rest of the trajectory)."""
    records = []
    if not record_dir:
        return records
    for path in sorted(glob.glob(os.path.join(record_dir, pattern))):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(doc, dict):
            continue
        n = doc.get("n")
        records.append((n if isinstance(n, int) else 0,
                        os.path.basename(path), doc))
    records.sort(key=lambda t: (t[0], t[1]))
    return records


def load_bench_records(record_dir: Optional[str] = None
                       ) -> List[Tuple[int, str, dict]]:
    return _load_glob(record_dir or repo_record_dir(), "BENCH_*.json")


def load_multichip_records(record_dir: Optional[str] = None
                           ) -> List[Tuple[int, str, dict]]:
    return _load_glob(record_dir or repo_record_dir(), "MULTICHIP_*.json")


# -------------------------------------------------------- classification

def parsed_payload(doc: dict) -> Optional[dict]:
    """The measurement payload: bench.py main() embeds it under
    ``parsed`` in the harness records; a bare bench stdout JSON (a fresh
    candidate) IS the payload."""
    parsed = doc.get("parsed")
    if isinstance(parsed, dict):
        return parsed
    if "metric" in doc:
        return doc
    return None


def classify(doc: dict) -> str:
    """'real' | 'degraded' | 'failed' for one record document.

    real = rc 0, a parsed measurement with a numeric value, and no
    ``degraded`` stamp anywhere; degraded = the explicit stamp bench.py
    lands on CPU fallbacks and give-up records; failed = everything
    else (the r03-r05 dark rounds: a nonzero rc and no measurement)."""
    parsed = parsed_payload(doc)
    if doc.get("degraded") or (isinstance(parsed, dict)
                               and parsed.get("degraded")):
        return "degraded"
    if (doc.get("rc", 0) == 0 and isinstance(parsed, dict)
            and parsed.get("metric")
            and isinstance(parsed.get("value"), (int, float))):
        return "real"
    return "failed"


def scenario_key(parsed: dict) -> Tuple[Optional[str], Optional[str]]:
    """(metric, device) — the comparability unit.  r01-era payloads
    carry no ``device`` key and key as (metric, None), deliberately
    distinct from later device-stamped records: a CPU dev number must
    never baseline a TPU one."""
    return (parsed.get("metric"), parsed.get("device"))


# -------------------------------------------------------- EWMA baseline

def ewma_baseline(records: List[Tuple[int, str, dict]],
                  metric: Optional[str], device: Optional[str],
                  k: int = EWMA_K,
                  alpha: float = EWMA_ALPHA) -> Optional[dict]:
    """EWMA over the last ``k`` REAL records matching (metric, device),
    folded oldest-to-newest so the newest real number carries the most
    weight.  Returns None when the scenario has no real record —
    degraded records are trajectory evidence, never a bar."""
    matching = []
    for _, fname, doc in records:
        if classify(doc) != "real":
            continue
        parsed = parsed_payload(doc)
        if scenario_key(parsed) != (metric, device):
            continue
        matching.append((fname, parsed))
    if not matching:
        return None
    window = matching[-k:]
    value = None
    mfu = None
    for _, parsed in window:
        v = parsed.get("value")
        if isinstance(v, (int, float)):
            value = v if value is None else alpha * v + (1 - alpha) * value
        m = parsed.get("mfu")
        if isinstance(m, (int, float)):
            mfu = m if mfu is None else alpha * m + (1 - alpha) * mfu
    if value is None:
        return None
    return {
        "value": round(float(value), 4),
        "mfu": round(float(mfu), 6) if mfu is not None else None,
        "records": [fname for fname, _ in window],
        "count": len(window),
        "k": k,
        "alpha": alpha,
        "newest": window[-1][0],
    }


# ------------------------------------------------------ degraded streak

def degraded_streak(records: List[Tuple[int, str, dict]]) -> dict:
    """How long the trajectory has been dark, and what the last real
    number was.  ``verdict`` is the human sentence every record / live
    digest / summary embeds."""
    last_real = None  # (fname, parsed)
    streak = 0
    since = None
    for _, fname, doc in records:
        if classify(doc) == "real":
            last_real = (fname, parsed_payload(doc))
            streak = 0
            since = None
        else:
            if streak == 0:
                since = fname
            streak += 1
    out = {
        "streak": streak,
        "since": since,
        "last_real_record": last_real[0] if last_real else None,
        "last_real_metric": (last_real[1].get("metric")
                             if last_real else None),
        "last_real_value": (last_real[1].get("value")
                            if last_real else None),
        "last_real_device": (last_real[1].get("device")
                             if last_real else None),
    }
    if not records:
        out["verdict"] = "no benchmark records yet"
    elif streak == 0 and last_real is not None:
        out["verdict"] = (
            f"latest record {last_real[0]} is a real measurement "
            f"({out['last_real_metric']}={out['last_real_value']})"
        )
    elif last_real is None:
        out["verdict"] = (
            f"{streak} consecutive records without a real measurement; "
            f"no real number has ever landed"
        )
    else:
        out["verdict"] = (
            f"{streak} consecutive records without a real measurement "
            f"(since {since}); last real number is {last_real[0]} "
            f"({out['last_real_metric']}={out['last_real_value']}"
            + (f" on {out['last_real_device']}"
               if out["last_real_device"] else "") + ")"
        )
    return out


def trend_stamp(record_dir: Optional[str] = None) -> Optional[dict]:
    """The small trend/provenance block embedded in fresh records and
    digest tokens.  Total: returns None when the record dir is
    unreadable or empty (a missing trajectory must never sink a
    measurement)."""
    try:
        records = load_bench_records(record_dir)
        if not records:
            return None
        counts: Dict[str, int] = {"real": 0, "degraded": 0, "failed": 0}
        for _, _, doc in records:
            counts[classify(doc)] += 1
        streak = degraded_streak(records)
        return {
            "records": len(records),
            "real": counts["real"],
            "degraded": counts["degraded"],
            "failed": counts["failed"],
            "degraded_streak": streak["streak"],
            "last_real_record": streak["last_real_record"],
            "last_real_value": streak["last_real_value"],
            "verdict": streak["verdict"],
        }
    except Exception:
        return None


# ------------------------------------------------------------ rendering

def trajectory(records: List[Tuple[int, str, dict]]) -> List[dict]:
    """One row per record, oldest first, ready for tabulation."""
    rows = []
    for n, fname, doc in records:
        parsed = parsed_payload(doc) or {}
        rows.append({
            "n": n,
            "file": fname,
            "class": classify(doc),
            "metric": parsed.get("metric"),
            "device": parsed.get("device"),
            "value": parsed.get("value"),
            "unit": parsed.get("unit"),
            "mfu": parsed.get("mfu"),
            "rc": doc.get("rc"),
        })
    return rows


def _fmt(v, nd=2) -> str:
    if isinstance(v, bool) or v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def render_markdown(record_dir: Optional[str] = None) -> str:
    """The auto-generated trajectory section for docs/performance.md:
    verdict, per-record table, EWMA baselines, multichip rounds."""
    record_dir = record_dir or repo_record_dir()
    records = load_bench_records(record_dir)
    lines = ["<!-- generated by python -m horovod_tpu_torch.bench.report "
             "--write-docs; do not edit by hand -->", ""]
    if not records:
        lines.append(f"_No BENCH records under {record_dir}._")
        return "\n".join(lines) + "\n"
    streak = degraded_streak(records)
    lines += [f"**Trajectory verdict:** {streak['verdict']}", ""]
    lines += ["| round | record | class | metric | device | value | MFU |",
              "|---|---|---|---|---|---|---|"]
    for row in trajectory(records):
        lines.append(
            f"| {row['n']} | {row['file']} | {row['class']} | "
            f"{_fmt(row['metric'])} | {_fmt(row['device'])} | "
            f"{_fmt(row['value'])} | {_fmt(row['mfu'], 4)} |"
        )
    scenarios = sorted(
        {scenario_key(parsed_payload(doc))
         for _, _, doc in records
         if classify(doc) == "real"},
        key=str,
    )
    if scenarios:
        lines += ["", f"**EWMA baselines** (last {EWMA_K} real records "
                      f"per scenario, alpha={EWMA_ALPHA}):", "",
                  "| metric | device | EWMA value | EWMA MFU | records |",
                  "|---|---|---|---|---|"]
        for metric, device in scenarios:
            base = ewma_baseline(records, metric, device)
            if base is None:
                continue
            lines.append(
                f"| {_fmt(metric)} | {_fmt(device)} | "
                f"{_fmt(base['value'])} | {_fmt(base['mfu'], 4)} | "
                f"{', '.join(base['records'])} |"
            )
    multichip = load_multichip_records(record_dir)
    if multichip:
        lines += ["", "**Multichip rounds:**", "",
                  "| round | record | devices | ok | skipped |",
                  "|---|---|---|---|---|"]
        for n, fname, doc in multichip:
            lines.append(
                f"| {n} | {fname} | {_fmt(doc.get('n_devices'))} | "
                f"{_fmt(doc.get('ok'))} | {_fmt(doc.get('skipped'))} |"
            )
    return "\n".join(lines) + "\n"
