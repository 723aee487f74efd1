"""The trajectory's report: every ``BENCH_r*.json`` / ``MULTICHIP_r*.json``
of a record dir, readable (counterpart of ``scripts/perf_report.py``; the
gate, :mod:`~horovod_tpu_torch.bench.gate`, judges, this module reports).

    python -m horovod_tpu_torch.bench.report --records-dir D
    python -m horovod_tpu_torch.bench.report --records-dir D \\
        --campaign D/campaign.json --write-docs notes.md --json

It loads the records of every schema era through ``obs/trend.py``,
separates the real measurements from the degraded placeholders and the
failed rounds, prints each scenario's EWMA baseline and the
degraded-streak verdict, and renders the verdict table of a campaign
journal (``bench/campaign.py``'s ``campaign.json``): ``--campaign``,
else ``<records-dir>/campaign.json`` when present.

``--write-docs PATH`` re-renders the generated trajectory section of
PATH in place, between the ``perf-report`` markers; a file without them
is refused rather than appended to.  PATH must be named: the port
rewrites no document of its own accord.

The record dir is ``--records-dir``, else ``HVDTPU_BENCH_RECORD_DIR``,
else ``HVDTPU_RECORD_DIR``; with none named the report reads and writes
nothing and exits 2.  Exit codes: 0 the report rendered, 2 bad input.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..obs import trend
from .campaign import summarize_journal
from .supervisor import RECORD_DIR_ENVS, bench_record_dir

__all__ = ["DOCS_BEGIN", "DOCS_END", "campaign_table", "load_campaign",
           "write_docs", "main"]

DOCS_BEGIN = "<!-- perf-report:begin -->"
DOCS_END = "<!-- perf-report:end -->"


def campaign_table(journal: dict) -> list:
    """Text lines of the campaign's per-point verdict table."""
    lines = [f"campaign {journal.get('name')} "
             f"(spec {journal.get('spec_sha')}, "
             f"updated {journal.get('updated')}):"]
    for pid in journal.get("order", []):
        entry = journal.get("points", {}).get(pid, {})
        record = entry.get("record") or {}
        value = record.get("value")
        val_s = f" value={value}" if isinstance(value, (int, float)) else ""
        lines.append(
            f"  {entry.get('status', 'pending'):9s} {pid}: "
            f"attempts={entry.get('attempts', 0)} "
            f"compile={entry.get('compile', '—')}{val_s}"
        )
    return lines


def load_campaign(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "points" not in doc:
        raise ValueError(f"{path} is not a campaign journal")
    return doc


def write_docs(docs_path: str, records_dir: str) -> bool:
    """Replace the section between the markers; True when the file
    changed.  Missing markers are an error: appending would duplicate
    the section on every run."""
    with open(docs_path) as f:
        text = f.read()
    if DOCS_BEGIN not in text or DOCS_END not in text:
        raise ValueError(
            f"{docs_path} has no {DOCS_BEGIN} / {DOCS_END} markers")
    head, rest = text.split(DOCS_BEGIN, 1)
    _, tail = rest.split(DOCS_END, 1)
    body = trend.render_markdown(records_dir)
    new = head + DOCS_BEGIN + "\n" + body + DOCS_END + tail
    if new == text:
        return False
    with open(docs_path, "w") as f:
        f.write(new)
    return True


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.bench.report",
        description="Render the BENCH/MULTICHIP perf trajectory, EWMA "
                    "baselines, degraded-streak verdict and campaign "
                    "table.")
    p.add_argument("--records-dir", default=None,
                   help="directory holding BENCH_*/MULTICHIP_* records "
                        "(default: HVDTPU_BENCH_RECORD_DIR, else "
                        "HVDTPU_RECORD_DIR)")
    p.add_argument("--campaign", default=None,
                   help="campaign.json journal to render (default: "
                        "<records-dir>/campaign.json when present)")
    p.add_argument("--write-docs", default=None, metavar="PATH",
                   help="re-render the generated trajectory section of "
                        "PATH in place, between its perf-report markers")
    p.add_argument("--json", action="store_true",
                   help="emit the machine-readable trend document too")
    args = p.parse_args(argv)

    records_dir = args.records_dir or bench_record_dir()
    if not records_dir:
        print(f"no record dir: pass --records-dir or set "
              f"{' or '.join(RECORD_DIR_ENVS)}", file=sys.stderr)
        return 2
    records = trend.load_bench_records(records_dir)
    multichip = trend.load_multichip_records(records_dir)
    if not records and not multichip:
        print(f"no BENCH_*/MULTICHIP_*.json records under "
              f"{records_dir}", file=sys.stderr)
        return 2

    counts = {"real": 0, "degraded": 0, "failed": 0}
    print(f"# BENCH trajectory: {len(records)} records")
    for row in trend.trajectory(records):
        counts[row["class"]] += 1
        desc = row["metric"] or f"rc={row['rc']}"
        val_s = (f" value={row['value']}"
                 if isinstance(row["value"], (int, float)) else "")
        mfu_s = (f" mfu={row['mfu']}"
                 if isinstance(row["mfu"], (int, float)) else "")
        print(f"  {row['class']:9s} {row['file']}: {desc}{val_s}{mfu_s}"
              f" [{row['device'] or 'unknown device'}]")
    print(f"# partition: {counts['real']} real, {counts['degraded']} "
          f"degraded, {counts['failed']} failed")

    scenarios = sorted(
        {trend.scenario_key(trend.parsed_payload(doc))
         for _, _, doc in records if trend.classify(doc) == "real"},
        key=str)
    for metric, device in scenarios:
        base = trend.ewma_baseline(records, metric, device)
        if base:
            print(f"# EWMA baseline {metric} on "
                  f"{device or 'unknown device'}: {base['value']} "
                  f"over {', '.join(base['records'])}")

    streak = trend.degraded_streak(records)
    print(f"# degraded-streak verdict: {streak['verdict']}")

    if multichip:
        print(f"# MULTICHIP rounds: {len(multichip)}")
        for n, fname, doc in multichip:
            print(f"  {fname}: n_devices={doc.get('n_devices')} "
                  f"ok={doc.get('ok')} skipped={doc.get('skipped')}")

    journal_path = args.campaign or os.path.join(records_dir,
                                                 "campaign.json")
    journal = None
    if os.path.exists(journal_path):
        try:
            journal = load_campaign(journal_path)
        except (OSError, ValueError) as exc:
            print(f"unreadable campaign journal {journal_path}: {exc}",
                  file=sys.stderr)
            return 2
        for line in campaign_table(journal):
            print(line)
    elif args.campaign:
        print(f"campaign journal {args.campaign} not found",
              file=sys.stderr)
        return 2

    if args.write_docs:
        try:
            changed = write_docs(args.write_docs, records_dir)
        except (OSError, ValueError) as exc:
            print(f"--write-docs failed: {exc}", file=sys.stderr)
            return 2
        print(f"# docs: {args.write_docs} "
              f"{'updated' if changed else 'already current'}")

    if args.json:
        doc = {
            "records": len(records),
            "partition": counts,
            "degraded_streak": streak,
            "trend": trend.trend_stamp(records_dir),
        }
        if journal is not None:
            doc["campaign"] = summarize_journal(journal)
        print(json.dumps(doc, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
