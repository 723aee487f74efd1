"""The bench's regression gate over a ``BENCH_r*.json`` trajectory
(counterpart of ``scripts/perf_gate.py``; the names are the reference's,
so a test can hold one beside the other).

    python -m horovod_tpu_torch.bench.gate --records-dir D
    python -m horovod_tpu_torch.bench.gate --records-dir D \\
        --candidate fresh.json --noise-pct 5 --json

1. **Partition** every ``BENCH_*.json`` of the record dir into *real*
   (rc 0, a parsed measurement, not degraded), *degraded* (the explicit
   ``degraded: true`` stamp of the bench's give-up and CPU records) and
   *failed* (a nonzero rc and no measurement), and print it.
2. **Baseline** per scenario ``(metric, device)``: the best value among
   the real records only.  A degraded record is evidence of the
   trajectory, never a bar.  The audit also prints the degraded-streak
   verdict ("N consecutive records without a real measurement; last
   real number is rX").  One scenario holds every point of a campaign
   that shares the metric and the card: the ``off`` and ``bucket``
   points of a gpt-small campaign are one scenario, as in the
   reference.
3. **Judge a candidate** (``--candidate fresh.json``: a bench result
   line, or a harness record ``{"n", "rc", "parsed"}``) against its
   scenario's EWMA over the last K real records with a noise band
   (``--noise-pct``, default 5): a drop past the band exits 1.  The
   EWMA is the one the bench's in-record sentinel
   (:func:`horovod_tpu_torch.bench.attach_regression`) uses, so on one
   record dir and one measured candidate both give the same baseline,
   the same folded records and the same regression flag.  A candidate
   stamped degraded is announced and not judged (the sentinel judges
   whatever the bench printed; the port's bench stamps only its CPU
   runs degraded, whose device ``"cpu"`` never shares a scenario with
   a card's).  The record's provenance (platform, device kind,
   ``CUDA_VISIBLE_DEVICES``, where the reference prints
   ``JAX_PLATFORMS``) is printed beside the verdict.

Without a candidate the gate is an auditor: it prints the partition and
the baselines and exits 0.  Exit codes: 0 clean, 1 a regression past
the noise band, 2 bad input.

Every classification goes through ``obs/trend.py``, which the sentinel
and :mod:`~horovod_tpu_torch.bench.report` read too.  The record dir is
``--records-dir``, else ``HVDTPU_BENCH_RECORD_DIR``, else
``HVDTPU_RECORD_DIR`` (:func:`~horovod_tpu_torch.bench.supervisor.
bench_record_dir`); with none named the gate reads nothing and exits 2.
It never defaults to the repository's root, whose records are the
reference's TPU trajectory.  The gate only reads JSON: it initialises no
device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from ..obs import trend as _trend
from .supervisor import RECORD_DIR_ENVS, bench_record_dir

__all__ = ["load_records", "provenance_of", "partition", "baselines",
           "judge", "main"]

parsed_payload = _trend.parsed_payload
classify = _trend.classify
scenario_key = _trend.scenario_key


def load_records(record_dir):
    """[(round n, filename, doc)] sorted by round; an unreadable file is
    named on stderr and skipped (one corrupt record must not blind the
    gate to the rest of the trajectory)."""
    records = []
    for path in sorted(glob.glob(os.path.join(record_dir, "BENCH_*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as exc:
            print(f"# unreadable record {os.path.basename(path)}: {exc}",
                  file=sys.stderr)
            continue
        if not isinstance(doc, dict):
            continue
        n = doc.get("n")
        records.append((n if isinstance(n, int) else 0,
                        os.path.basename(path), doc))
    records.sort()
    return records


def provenance_of(doc):
    """The backend stamp (platform, device kind, CUDA_VISIBLE_DEVICES),
    wherever the record holds it."""
    for holder in (doc, parsed_payload(doc) or {}):
        prov = holder.get("provenance")
        if isinstance(prov, dict):
            return prov
    parsed = parsed_payload(doc)
    if isinstance(parsed, dict) and parsed.get("device"):
        return {"device_kind": parsed["device"]}
    return {}


def _prov_str(prov):
    if not prov:
        return "provenance unknown"
    bits = []
    if prov.get("platform"):
        bits.append(f"platform={prov['platform']}")
    if prov.get("device_kind"):
        bits.append(f"device={prov['device_kind']}")
    if prov.get("cuda_visible_devices"):
        bits.append(f"CUDA_VISIBLE_DEVICES={prov['cuda_visible_devices']}")
    return " ".join(bits) or "provenance unknown"


def partition(records):
    """{bucket: [(n, fname, doc)]} over the classified trajectory."""
    out = {"real": [], "degraded": [], "failed": []}
    for n, fname, doc in records:
        out[classify(doc)].append((n, fname, doc))
    return out


def baselines(records):
    """{(metric, device): (fname, parsed)}: the best real value of each
    scenario."""
    best = {}
    for _, fname, doc in records:
        if classify(doc) != "real":
            continue
        parsed = parsed_payload(doc)
        key = scenario_key(parsed)
        if key not in best or parsed["value"] > best[key][1]["value"]:
            best[key] = (fname, parsed)
    return best


def judge(candidate, base, noise_pct):
    """(verdict, pct_delta): 'regression' | 'ok' | 'improved'."""
    old, new = base["value"], candidate["value"]
    if not old:
        return "ok", 0.0
    pct = (new - old) / old * 100.0
    if pct < -abs(noise_pct):
        return "regression", pct
    return ("improved" if pct > abs(noise_pct) else "ok"), pct


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.bench.gate",
        description="Partition the BENCH trajectory and gate a fresh "
                    "measurement against the best non-degraded baseline.")
    p.add_argument("--records-dir", default=None,
                   help="directory holding BENCH_r*.json (default: "
                        "HVDTPU_BENCH_RECORD_DIR, else HVDTPU_RECORD_DIR)")
    p.add_argument("--candidate", default=None,
                   help="fresh bench output JSON to judge (the bench's "
                        "result line or a harness record); omitting it "
                        "audits the trajectory only")
    p.add_argument("--noise-pct", type=float, default=5.0,
                   help="regression band in percent (default 5): a "
                        "value drop past this fails the gate")
    p.add_argument("--json", action="store_true",
                   help="emit the machine verdict document on stdout "
                        "too")
    args = p.parse_args(argv)

    records_dir = args.records_dir or bench_record_dir()
    if not records_dir:
        print(f"no record dir: pass --records-dir or set "
              f"{' or '.join(RECORD_DIR_ENVS)}", file=sys.stderr)
        return 2
    records = load_records(records_dir)
    if not records:
        print(f"no BENCH_*.json records under {records_dir}",
              file=sys.stderr)
        return 2
    buckets = partition(records)

    print(f"# BENCH trajectory: {len(records)} records "
          f"({len(buckets['real'])} real, "
          f"{len(buckets['degraded'])} degraded, "
          f"{len(buckets['failed'])} failed)")
    for bucket in ("real", "degraded", "failed"):
        for n, fname, doc in buckets[bucket]:
            parsed = parsed_payload(doc) or {}
            desc = parsed.get("metric") or doc.get(
                "failure_phase") or f"rc={doc.get('rc')}"
            val = parsed.get("value")
            val_s = f" value={val}" if isinstance(val, (int, float)) else ""
            print(f"  {bucket:9s} {fname}: {desc}{val_s} "
                  f"[{_prov_str(provenance_of(doc))}]")

    base = baselines(records)
    print(f"# baselines ({len(base)} scenario"
          f"{'s' if len(base) != 1 else ''}, real records only):")
    for (metric, device), (fname, parsed) in sorted(
            base.items(), key=lambda kv: str(kv[0])):
        print(f"  {metric} on {device or 'unknown device'}: "
              f"{parsed['value']} ({fname})")

    # after the per-record lines, so the partition stays the first
    # mention of every record's name
    streak = _trend.degraded_streak(records)
    print(f"# degraded-streak verdict: {streak['verdict']}")

    verdict = {
        "records": len(records),
        "real": [f for _, f, _ in buckets["real"]],
        "degraded": [f for _, f, _ in buckets["degraded"]],
        "failed": [f for _, f, _ in buckets["failed"]],
        "noise_pct": args.noise_pct,
        "degraded_streak": streak["streak"],
        "last_real_record": streak["last_real_record"],
        "regression": False,
    }

    rc = 0
    if args.candidate:
        try:
            with open(args.candidate) as f:
                cand_doc = json.load(f)
        except (OSError, ValueError) as exc:
            print(f"unreadable candidate {args.candidate}: {exc}",
                  file=sys.stderr)
            return 2
        cand = parsed_payload(cand_doc)
        if not isinstance(cand, dict) or not cand.get("metric") \
                or not isinstance(cand.get("value"), (int, float)):
            print(f"candidate {args.candidate} carries no measurement "
                  f"(metric/value)", file=sys.stderr)
            return 2
        prov = _prov_str(provenance_of(cand_doc))
        key = scenario_key(cand)
        if cand.get("degraded"):
            # a placeholder: never comparable with a real baseline, and
            # said out loud rather than passed as healthy
            print(f"# candidate is DEGRADED ({prov}): recorded for the "
                  f"trajectory, not judged against "
                  f"{key[0]} on {key[1] or 'unknown device'}")
            verdict["candidate"] = {"scenario": list(key),
                                    "degraded": True}
        elif key not in base:
            print(f"# candidate scenario {key[0]} on "
                  f"{key[1] or 'unknown device'} has no real baseline "
                  f"({prov}) — first real measurement, nothing to "
                  f"regress from")
            verdict["candidate"] = {"scenario": list(key),
                                    "baseline": None}
        else:
            # the EWMA over the scenario's last K real records, not its
            # single best one: one lucky round must not own the bar
            ewma = _trend.ewma_baseline(records, *key)
            word, pct = judge(cand, ewma, args.noise_pct)
            print(f"# candidate {cand['value']} vs EWMA baseline "
                  f"{ewma['value']} over {len(ewma['records'])} real "
                  f"record{'s' if len(ewma['records']) != 1 else ''} "
                  f"({', '.join(ewma['records'])}): {pct:+.2f}% "
                  f"[band ±{args.noise_pct}%] -> {word.upper()} ({prov})")
            verdict["candidate"] = {
                "scenario": list(key),
                "value": cand["value"],
                "baseline": ewma["value"],
                "baseline_record": ewma["newest"],
                "baseline_records": ewma["records"],
                "pct": round(pct, 2),
                "verdict": word,
            }
            if word == "regression":
                verdict["regression"] = True
                rc = 1
    if args.json:
        print(json.dumps(verdict, indent=1))
    return rc


if __name__ == "__main__":
    sys.exit(main())
