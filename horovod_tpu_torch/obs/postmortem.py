"""Cross-rank post-mortem: load every rank's flight-recorder dump and
name the root cause.

The flight recorder (obs/flightrec.py) guarantees each rank leaves a
bounded ring of structured events on any catchable death path.  This
module is the launcher-side half: correlate those rings — plus
``live_history.jsonl`` and the merged timeline when present — into one
report that answers the questions a 3 a.m. pager actually asks:

* **Which rank failed first**, and what was its last event / last
  completed collective?
* **What was the last collective every rank agreed on** (rings aligned
  on (cycle, op))?
* **Where was every other rank at the time of death** — running,
  waiting (and on which op), or already exited?
* **Did the collective schedules diverge** — did some rank submit a
  different op sequence than its peers (the classic desync hang)?

Library use::

    report = postmortem.analyze(postmortem.load_dumps(spec))
    print(postmortem.verdict(report))

CLI::

    python -m horovod_tpu_torch.obs.postmortem <dump-dir-or-spec> \
        [--live-history live_history.jsonl] [--timeline merged.json] \
        [--expected-ranks N] [--output postmortem.json]

Both launchers (``launch_job`` / ``launch_elastic_job``) run this
automatically on abnormal job end: the per-rank dumps are collected,
``postmortem.json`` lands next to them, and the verdict paragraph is
printed.  A rank killed with SIGKILL (or a lost host) leaves no dump;
it is reported as ``no black box`` rather than silently skipped.

A copy of the reference's ``horovod_tpu/obs/postmortem.py``.
"""

from __future__ import annotations

import argparse
import glob as _glob
import json
import os
import sys
from typing import Dict, List, Optional

from ..utils.logging import get_logger
from . import flightrec, pathspec

LOG = get_logger("obs.postmortem")

REPORT_SCHEMA = "hvdtpu-postmortem-v1"

# Event kinds that mean "this rank had submitted work and was parked on
# peers (or the engine) when the dump was taken".
_WAIT_KINDS = ("enqueue", "negotiate", "execute", "wait")
# Dump triggers that mean the process was dying (vs. a routine exit or
# an operator-requested dump).  "exception" is the flush the elastic
# worker's error path issues after catching a user exception itself.
_DEATH_TRIGGERS = ("excepthook", "threading.excepthook", "exception")

__all__ = [
    "REPORT_SCHEMA",
    "load_dumps",
    "analyze",
    "verdict",
    "write_report",
    "generate",
    "main",
]


def load_dumps(spec: str) -> List[dict]:
    """Load every flight-recorder dump reachable from ``spec`` — the
    same dir / ``{rank}`` template / plain-path forms the writers used
    (shared rules in obs/pathspec.py), or a direct glob.  Unreadable or
    wrong-schema files are skipped with a warning, not fatal: a half-
    written dump must not cost the analysis of the intact ones."""
    patterns = [pathspec.glob_pattern(spec, "flightrec")]
    if os.path.isdir(spec):
        # Direct dumps (explicit path= calls in tests/tools) may not
        # carry a rank tag; accept any flightrec*.json in the dir too.
        patterns.append(os.path.join(spec, "flightrec*.json"))
    paths = sorted({p for pat in patterns for p in _glob.glob(pat)})
    dumps: List[dict] = []
    for path in paths:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as exc:
            LOG.warning("skipping unreadable flightrec dump %s: %s",
                        path, exc)
            continue
        if doc.get("schema") != flightrec.SCHEMA:
            LOG.warning("skipping %s: schema %r is not %r",
                        path, doc.get("schema"), flightrec.SCHEMA)
            continue
        doc["_path"] = path
        dumps.append(doc)
    return dumps


def _latest_per_rank(dumps: List[dict]) -> Dict[int, dict]:
    """One dump per rank: the latest incarnation's last word (elastic
    respawns leave one epoch-tagged file per incarnation; the newest
    epoch — then the newest wall time — is the story of how the job
    ended)."""
    best: Dict[int, dict] = {}
    for doc in dumps:
        try:
            rank = int(doc.get("rank"))
        except (TypeError, ValueError):
            continue
        key = (doc.get("epoch") or 0, doc.get("wall_time") or 0.0)
        cur = best.get(rank)
        if cur is None or key > ((cur.get("epoch") or 0),
                                 (cur.get("wall_time") or 0.0)):
            best[rank] = doc
    return best


def _rank_summary(doc: dict) -> dict:
    events = doc.get("events") or []
    trigger = doc.get("trigger") or "unknown"
    completes = [e for e in events if e.get("kind") == "complete"]
    last_complete = completes[-1] if completes else None
    # The last OPERATIONAL event: the death-path bookkeeping the flush
    # itself appends ("signal", "exception") restates the trigger — the
    # question a post-mortem answers is what the rank was DOING.
    ops = [e for e in events if e.get("kind") not in ("signal", "exception")]
    last_event = ops[-1] if ops else (events[-1] if events else None)
    died = trigger in _DEATH_TRIGGERS or trigger.startswith("signal:")
    if trigger == f"signal:{flightrec._DUMP_SIGNAL}":
        died = False  # dump-only signal: an operator snapshot, not a death
    if trigger == "atexit" and doc.get("last_exception") is None:
        position = "exited"
        waiting_on = None
    elif last_event is not None and last_event.get("kind") in _WAIT_KINDS:
        position = "waiting"
        waiting_on = last_event.get("name") or None
    else:
        position = "running"
        waiting_on = None
    # Cross-rank stream alignment starts at each rank's LAST rendezvous
    # event: a survivor's ring spans earlier epochs a respawned peer
    # never lived through, and comparing from ring-start would convict
    # every recovered elastic job of "divergence".  Non-elastic rings
    # have no rendezvous events and align whole.
    aligned = events
    for i in range(len(events) - 1, -1, -1):
        if events[i].get("kind") == "rendezvous":
            aligned = events[i + 1:]
            break
    # Restore provenance: the checkpoint tier records every recovery
    # as a ``ckpt.restore`` event with a ``source=peer|disk|none``
    # detail.  The NEWEST one is this incarnation's recovery story —
    # the analyzer's proof of where a respawned rank's state came from.
    restores = [e for e in events if e.get("kind") == "ckpt.restore"]
    last_restore = None
    if restores:
        ev = restores[-1]
        fields = dict(
            kv.split("=", 1) for kv in (ev.get("detail") or "").split()
            if "=" in kv
        )
        last_restore = {
            "source": fields.get("source"),
            "replica_adopted": fields.get("replica") == "True",
            "ms": float(fields["ms"]) if "ms" in fields else None,
            "commits": ev.get("cycle"),
        }
    # OOM black box: the memory plane drops a ``mem.oom`` event (last
    # census + dominant owner) on every RESOURCE_EXHAUSTED death path.
    # The NEWEST one is this incarnation's memory story — the proof of
    # WHAT was resident when the allocator gave up.
    # Training-health black box: the divergence sentinel drops a
    # ``health.divergence`` event the moment a rank's state digest
    # splits from the majority, and the health monitor a
    # ``health.nonfinite`` on the FIRST nonfinite gradient.  The NEWEST
    # of each is this incarnation's numerics story — often the real
    # root cause steps before the crash the other planes see.
    divs = [e for e in events if e.get("kind") == "health.divergence"]
    last_divergence = None
    if divs:
        ev = divs[-1]
        fields = dict(
            kv.split("=", 1) for kv in (ev.get("detail") or "").split()
            if "=" in kv
        )
        last_divergence = {
            "step": ev.get("cycle"),
            "component": fields.get("component") or ev.get("name"),
            "bucket": fields.get("bucket"),
            "leaf": fields.get("leaf"),
            "minority": fields.get("minority"),
        }
    nonfinites = [e for e in events if e.get("kind") == "health.nonfinite"]
    first_nonfinite = None
    if nonfinites:
        ev = nonfinites[0]
        fields = dict(
            kv.split("=", 1) for kv in (ev.get("detail") or "").split()
            if "=" in kv
        )
        first_nonfinite = {
            "step": ev.get("cycle"),
            "bucket": fields.get("bucket"),
            "leaf": fields.get("leaf"),
            "count": fields.get("count"),
        }
    health_alerts = sorted({
        e.get("name") for e in events
        if e.get("kind") == "health.alert" and e.get("name")
    })
    ooms = [e for e in events if e.get("kind") == "mem.oom"]
    last_oom = None
    if ooms:
        ev = ooms[-1]
        fields = dict(
            kv.split("=", 1) for kv in (ev.get("detail") or "").split()
            if "=" in kv
        )

        def _num(key, cast):
            try:
                return cast(fields[key])
            except (KeyError, TypeError, ValueError):
                return None

        last_oom = {
            "where": fields.get("where"),
            "owner": fields.get("owner"),
            "share": _num("share", float),
            "owner_bytes": _num("owner_bytes", int),
            "total_bytes": _num("total_bytes", int),
            "in_use": _num("in_use", int),
            "limit": _num("limit", int),
        }
    return {
        "rank": int(doc.get("rank")),
        "epoch": doc.get("epoch") or 0,
        "trigger": trigger,
        "died": died,
        "wall_time": doc.get("wall_time"),
        "recorded": doc.get("recorded", len(events)),
        "overwritten": doc.get("overwritten", 0),
        "position": position,
        "waiting_on": waiting_on,
        "last_event": last_event,
        "last_collective": (last_complete or {}).get("name") or None,
        "last_exception": doc.get("last_exception"),
        "last_restore": last_restore,
        "last_oom": last_oom,
        "last_divergence": last_divergence,
        "first_nonfinite": first_nonfinite,
        "health_alerts": health_alerts,
        "submitted": [e.get("name") for e in aligned
                      if e.get("kind") == "enqueue"],
        "completed": [e.get("name") for e in aligned
                      if e.get("kind") == "complete"],
        "dump_path": doc.get("_path"),
    }


def _counted(seq: List[str]) -> List[tuple]:
    """Stream of (op, k-th occurrence): real training loops reuse the
    same tensor names every step, so bare names cannot identify WHICH
    instance of a collective two ranks have in common."""
    counts: Dict[str, int] = {}
    out = []
    for op in seq:
        counts[op] = counts.get(op, 0) + 1
        out.append((op, counts[op]))
    return out


def _last_common_collective(ranks: List[dict]) -> Optional[dict]:
    """The last collective instance every rank completed.  Streams are
    already rendezvous-aligned (see :func:`_rank_summary`) and
    negotiation is deterministic, so each rank's completion stream is a
    prefix of the same global sequence; occurrence-counting makes
    repeated names (``grad_w`` completed every step) identify distinct
    instances instead of matching a 100-step-old completion."""
    if any(not r["completed"] for r in ranks) or not ranks:
        return None
    if any(r["overwritten"] for r in ranks):
        # A wrapped ring's surviving window starts at an unknown true
        # instance, so occurrence labels no longer align across ranks
        # — a confidently wrong "all ranks completed X" would mask the
        # very lag the post-mortem exists to expose.  (Elastic rings
        # are re-anchored at each rendezvous, so this bites only
        # long static epochs; raise HVDTPU_FLIGHTREC_CAPACITY to
        # widen the window.)
        LOG.warning(
            "flight-recorder ring(s) overwrote events; skipping "
            "last-common-collective alignment (window starts unknown)"
        )
        return None
    streams = [_counted(r["completed"]) for r in ranks]
    common = set(streams[0])
    for s in streams[1:]:
        common &= set(s)
    if not common:
        return None
    for op, k in reversed(streams[0]):
        if (op, k) in common:
            return {"op": op, "occurrence": k}
    return None


def _schedule_divergence(ranks: List[dict]) -> Optional[dict]:
    """The classic desync: ranks submitted *different* op sequences.
    Compare the per-rank enqueue streams position by position; the
    first index where two ranks disagree (both having submitted that
    many ops — a rank that merely died earlier is not divergent) is the
    divergence point."""
    seqs = {r["rank"]: r["submitted"] for r in ranks if r["submitted"]}
    if len(seqs) < 2:
        return None
    # Suffix-align overwritten rings the cheap, honest way: divergence
    # detection is only exact while no ring overwrote its head.
    if any(r["overwritten"] for r in ranks):
        LOG.warning(
            "flight-recorder ring(s) overwrote events; schedule-"
            "divergence detection covers only the surviving window"
        )
    depth = min(len(s) for s in seqs.values())
    for i in range(depth):
        ops = {rank: s[i] for rank, s in seqs.items()}
        if len(set(ops.values())) > 1:
            return {"index": i, "ops": ops}
    return None


def _read_live_history(path: Optional[str]) -> Optional[dict]:
    if not path or not os.path.exists(path):
        return None
    last = None
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        last = json.loads(line)
                    except ValueError:
                        continue  # crash-torn final row
    except OSError:
        return None
    return last


def analyze(
    dumps: List[dict],
    *,
    expected_ranks: Optional[int] = None,
    live_history: Optional[str] = None,
    timeline_path: Optional[str] = None,
) -> dict:
    """Correlate per-rank flight-recorder dumps into the report dict
    (schema ``hvdtpu-postmortem-v1``)."""
    per_rank = _latest_per_rank(dumps)
    ranks = sorted(
        (_rank_summary(doc) for doc in per_rank.values()),
        key=lambda r: r["rank"],
    )
    present = {r["rank"] for r in ranks}
    missing = (
        sorted(set(range(expected_ranks)) - present)
        if expected_ranks else []
    )

    dead = [r for r in ranks if r["died"]]
    # First-failure ordering: a SELF-inflicted death (SIGABRT, an
    # uncaught exception) outranks a SIGTERM — the launcher's failure
    # propagation SIGTERMs the survivors, so in a cascade the SIGTERM
    # dumps are consequences, not causes.  Wall time is only the
    # tiebreak WITHIN a class: the cascade gap is routinely sub-second,
    # inside ordinary cross-host clock skew, so raw wall-clock
    # comparison across hosts would blame whichever host's clock ran
    # behind (the same reason heartbeat staleness is judged on the
    # launcher's clock only).
    first = min(
        dead,
        key=lambda r: (r["trigger"] == "signal:SIGTERM",
                       r["wall_time"] or 0.0),
    ) if dead else None
    first_failure: Optional[dict] = None
    if first is not None:
        first_failure = {
            "rank": first["rank"],
            "trigger": first["trigger"],
            "wall_time": first["wall_time"],
            "last_event": first["last_event"],
            "last_collective": first["last_collective"],
            "exception": (first["last_exception"] or {}).get("type"),
        }
    elif missing:
        first_failure = {
            "rank": missing[0],
            "trigger": "no_black_box",
            "wall_time": None,
            "last_event": None,
            "last_collective": None,
            "exception": None,
        }

    report = {
        "schema": REPORT_SCHEMA,
        "expected_ranks": expected_ranks,
        "ranks_with_dumps": sorted(present),
        "ranks_missing_dumps": missing,
        "first_failure": first_failure,
        "last_common_collective": _last_common_collective(ranks),
        "schedule_divergence": _schedule_divergence(ranks),
        "restore_provenance": {
            str(r["rank"]): r["last_restore"]
            for r in ranks if r.get("last_restore")
        },
        "memory": {
            str(r["rank"]): r["last_oom"]
            for r in ranks if r.get("last_oom")
        },
        "health": {
            str(r["rank"]): {
                "divergence": r.get("last_divergence"),
                "first_nonfinite": r.get("first_nonfinite"),
                "alerts": r.get("health_alerts") or [],
            }
            for r in ranks
            if r.get("last_divergence") or r.get("first_nonfinite")
            or r.get("health_alerts")
        },
        "ranks": ranks,
        "live_last_round": _read_live_history(live_history),
    }
    if timeline_path and os.path.exists(timeline_path):
        report["timeline"] = {"path": timeline_path}
    return report


def verdict(report: dict) -> str:
    """The human paragraph: who failed first, in what, and who was
    left waiting on whom."""
    parts: List[str] = []
    first = report.get("first_failure")
    if first is None:
        parts.append(
            "No rank left a death-path dump — every black box records a "
            "routine exit.  If the job still failed, the failure was in "
            "the launcher or outside the instrumented ranks."
        )
    elif first.get("trigger") == "no_black_box":
        parts.append(
            f"Rank {first['rank']} left no black box (SIGKILL, OOM "
            f"kill, lost host, or it never started) and is the most "
            f"likely first failure."
        )
    else:
        last_ev = first.get("last_event") or {}
        desc = f"rank {first['rank']} failed first ({first['trigger']}"
        if first.get("exception"):
            desc += f", {first['exception']}"
        desc += ")"
        if last_ev:
            desc += (
                f"; its last recorded event was {last_ev.get('kind')!r}"
            )
            if last_ev.get("name"):
                desc += f" of {last_ev.get('name')!r}"
            cyc = last_ev.get("cycle")
            if cyc is not None and cyc >= 0:
                desc += f" at cycle {cyc}"
        if first.get("last_collective"):
            desc += (
                f"; the last collective it completed was "
                f"{first['last_collective']!r}"
            )
        parts.append(desc[0].upper() + desc[1:] + ".")
    later_dead = [
        r for r in report.get("ranks", [])
        if r["died"] and first is not None and r["rank"] != first.get("rank")
    ]
    if later_dead:
        parts.append(
            "Subsequently "
            + "; ".join(
                f"rank {r['rank']} died ({r['trigger']}"
                + (f", {r['last_exception']['type']}"
                   if r.get("last_exception") else "")
                + ")"
                for r in later_dead
            )
            + "."
        )
    common = report.get("last_common_collective")
    if common:
        inst = (f" (instance #{common['occurrence']})"
                if common.get("occurrence", 1) > 1 else "")
        parts.append(
            f"The last collective all ranks completed was "
            f"{common['op']!r}{inst}."
        )
    waiters = [
        r for r in report.get("ranks", [])
        if r["position"] == "waiting"
        and (first is None or r["rank"] != first.get("rank"))
    ]
    if waiters:
        parts.append(
            "At the time of death "
            + "; ".join(
                f"rank {r['rank']} was waiting on "
                f"{(r['waiting_on'] or 'an unnamed op')!r}"
                for r in waiters
            )
            + "."
        )
    exited = [r["rank"] for r in report.get("ranks", [])
              if r["position"] == "exited"]
    if exited:
        parts.append(
            f"Rank(s) {exited} had already exited cleanly."
        )
    div = report.get("schedule_divergence")
    if div:
        ops = ", ".join(
            f"rank {rank} submitted {op!r}"
            for rank, op in sorted(div["ops"].items())
        )
        parts.append(
            f"COLLECTIVE SCHEDULE DIVERGENCE at submission #"
            f"{div['index'] + 1}: {ops} — ranks disagreeing on the op "
            f"sequence is the classic desync hang."
        )
    health = report.get("health") or {}
    div_bits = []
    nf_bits = []
    alert_bits = []
    for rank, h in sorted(health.items(), key=lambda kv: int(kv[0])):
        h = h or {}
        d = h.get("divergence")
        if d:
            where = d.get("component") or "?"
            if d.get("leaf"):
                where += f" (leaf {d['leaf']})"
            bit = f"rank {rank} diverged from the majority"
            if d.get("minority") not in (None, "", str(rank)):
                bit = (f"rank(s) {d['minority']} diverged from the "
                       f"majority (seen by rank {rank})")
            if d.get("step") is not None:
                bit += f" at step {d['step']}"
            bit += f" in {where}"
            div_bits.append(bit)
        nf = h.get("first_nonfinite")
        if nf:
            bit = f"rank {rank}'s first nonfinite gradient"
            if nf.get("step") is not None:
                bit += f" appeared at step {nf['step']}"
            if nf.get("leaf"):
                bit += f" in leaf {nf['leaf']!r}"
                if nf.get("bucket") is not None:
                    bit += f" (bucket {nf['bucket']})"
            nf_bits.append(bit)
        alerts = h.get("alerts") or []
        if alerts and not d and not nf:
            alert_bits.append(
                f"rank {rank} raised health alert(s) "
                + ", ".join(repr(a) for a in alerts)
            )
    if div_bits:
        # Dedup: every rank records the identical verdict (the sentinel
        # compares the same gathered matrix everywhere).
        parts.append("TRAINING-STATE DIVERGENCE: "
                     + "; ".join(sorted(set(div_bits))) + " — "
                     "the bitwise-replication invariant broke at "
                     "runtime; do not trust checkpoints taken after "
                     "this step.")
    if nf_bits:
        parts.append("NONFINITE GRADIENTS: " + "; ".join(nf_bits) + ".")
    if alert_bits:
        parts.append("Training-health alerts before death: "
                     + "; ".join(alert_bits) + ".")
    mem = report.get("memory") or {}
    if mem:
        def _gb(b):
            return (f"{b / 2 ** 30:.2f}GB" if b and b >= 2 ** 30
                    else f"{(b or 0) / 2 ** 20:.1f}MB")

        bits = []
        for rank, m in sorted(mem.items(), key=lambda kv: int(kv[0])):
            m = m or {}
            bit = f"rank {rank} died allocating in {m.get('where')!r}"
            if m.get("owner"):
                bit += f"; {m['owner']} held"
                if m.get("share") is not None:
                    bit += f" {m['share']:.0%} of"
                bit += " the tagged device memory"
                if m.get("owner_bytes"):
                    bit += f" ({_gb(m['owner_bytes'])}"
                    if m.get("total_bytes"):
                        bit += f" of {_gb(m['total_bytes'])}"
                    bit += ")"
            if m.get("in_use") is not None and m.get("limit"):
                bit += (f"; HBM {_gb(m['in_use'])} in use of "
                        f"{_gb(m['limit'])}")
            bits.append(bit)
        parts.append("OUT OF DEVICE MEMORY: " + "; ".join(bits) + ".")
    prov = report.get("restore_provenance") or {}
    if prov:
        parts.append(
            "Recovery provenance: "
            + "; ".join(
                f"rank {rank} restored from "
                + {"peer": "a live peer", "disk": "the disk manifest",
                   "none": "nothing (fresh start)"}.get(
                       (p or {}).get("source"), "an unknown source")
                + (f" at commit {p['commits']}"
                   if (p or {}).get("commits") is not None else "")
                for rank, p in sorted(prov.items(),
                                      key=lambda kv: int(kv[0]))
            )
            + "."
        )
    missing = report.get("ranks_missing_dumps") or []
    if missing and (first is None
                    or first.get("trigger") != "no_black_box"):
        parts.append(
            f"Rank(s) {missing} left no black box "
            f"(SIGKILL/OOM/lost host cannot be caught)."
        )
    return " ".join(parts)


def write_report(report: dict, path: str) -> str:
    return pathspec.write_json_atomic(path, report)


def generate(
    spec: str,
    *,
    expected_ranks: Optional[int] = None,
    live_history: Optional[str] = None,
    timeline_path: Optional[str] = None,
    output: Optional[str] = None,
) -> Optional[dict]:
    """The launcher's one-call entry: load, analyze, write
    ``postmortem.json`` (default: next to the dumps when ``spec`` is a
    directory), return the report — or None when no dumps exist.  Never
    raises: a post-mortem failure must not mask the job's real error."""
    try:
        dumps = load_dumps(spec)
        if not dumps:
            LOG.warning("no flight-recorder dumps under %r — "
                        "no post-mortem possible", spec)
            return None
        report = analyze(
            dumps, expected_ranks=expected_ranks,
            live_history=live_history, timeline_path=timeline_path,
        )
        report["verdict"] = verdict(report)
        if output is None and os.path.isdir(spec):
            output = os.path.join(spec, "postmortem.json")
        if output:
            report["report_path"] = write_report(report, output)
        return report
    except Exception as exc:  # pragma: no cover - defensive
        LOG.warning("post-mortem generation failed: %s", exc)
        return None


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.obs.postmortem",
        description=(
            "Correlate per-rank flight-recorder dumps into a root-cause "
            "report for a dead job."
        ),
    )
    parser.add_argument(
        "dumps",
        help="The HVDTPU_FLIGHTREC_DUMP value the job used: a "
             "directory, a {rank} template, or a plain path.",
    )
    parser.add_argument("--live-history", default=None,
                        help="live_history.jsonl from the live plane.")
    parser.add_argument("--timeline", default=None,
                        help="Merged all-rank Chrome trace, if present.")
    parser.add_argument("--expected-ranks", type=int, default=None,
                        help="Job world size (flags ranks with no dump).")
    parser.add_argument("--output", default=None,
                        help="Where to write postmortem.json "
                             "(default: next to the dumps).")
    args = parser.parse_args(argv)
    report = generate(
        args.dumps,
        expected_ranks=args.expected_ranks,
        live_history=args.live_history,
        timeline_path=args.timeline,
        output=args.output,
    )
    if report is None:
        print(f"postmortem: no flight-recorder dumps under "
              f"{args.dumps!r}", file=sys.stderr)
        return 2
    print(report["verdict"])
    if report.get("report_path"):
        print(f"postmortem report: {report['report_path']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
