"""Merge per-rank span dumps into a per-request waterfall + latency
decomposition report.

The launcher-side consumer of obs/trace.py.  Two outputs from one set
of ``spans.*rank*.json`` files (all ranks, all epochs, the launcher's
own ``spans.rank.launcher.json`` included):

* **Chrome-trace waterfall** — one ``pid`` lane per trace id (i.e. per
  request, plus the ``serve.steps`` / ``engine`` step lanes), one
  ``tid`` per (rank, epoch) incarnation inside the lane, reusing
  timeline_merge's epoch-lane-stride convention.  A replayed request's
  lane therefore shows its epoch-0 spans and its epoch-1 replay spans
  side by side — the recovery gap is the visible hole between them.
* **Latency-decomposition report** — per request: ttft broken into the
  named components that tile the [arrival, first-token] interval
  (``queue_wait + schedule_broadcast + admit_wait + prefill``; on the
  greedy slot engine the first token IS the prefill's argmax, so
  first-decode is folded into prefill), the recorded ttft they must sum
  to, epochs and ranks seen; plus fleet-level p50/p99 per component and
  the tpot decomposition (decode-compute / scheduler residual /
  stream-publish) from the per-step spans.

Missing ranks are reported, not fatal: a rank that died by SIGKILL (or
had its flush chaos-suppressed via ``trace_flush:action=trace_drop``)
leaves no file, and the merge proceeds on what exists — the absence is
itself named in the report (``missing_ranks``), mirroring the
post-mortem analyzer's "no black box" verdict.

Used by the launcher at job end (run/runner.py, ``--trace``) and
directly::

    python -m horovod_tpu_torch.obs.trace_merge OUT_PREFIX SPAN_FILE [...]

A copy of the reference's ``horovod_tpu/obs/trace_merge.py``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence

from . import pathspec

REPORT_SCHEMA = "hvdtpu-trace-report-v1"

# (rank, epoch) -> tid inside a request's lane; same stride convention
# as timeline_merge's per-incarnation pid lanes.
_EPOCH_LANE_STRIDE = 100000

# ttft components, in waterfall order.  The report sums whatever subset
# a request actually recorded — a replayed request's second incarnation
# has replay_prefill instead of the full chain.
TTFT_COMPONENTS = ("queue_wait", "schedule_broadcast", "admit_wait",
                   "prefill")
TPOT_COMPONENTS = ("decode_compute", "scheduler", "stream_publish")

# Step-lane trace ids: aggregate timing lanes, not requests.
_STEP_TRACES = ("serve.steps", "engine", "overlap")

__all__ = ["load_docs", "merge", "report", "merge_glob", "main",
           "TTFT_COMPONENTS", "TPOT_COMPONENTS", "REPORT_SCHEMA"]


def load_docs(paths: Sequence[str]) -> List[dict]:
    """Load every span dump that parses; a torn file (rank killed
    mid-write never happens — the write is atomic — but a disk-full
    truncation can) costs that rank, never the merge."""
    docs = []
    for path in sorted(paths):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(doc, dict) or "spans" not in doc:
            continue
        doc["_path"] = path
        docs.append(doc)
    return docs


def _rank_key(doc: dict) -> str:
    """A dump's rank tag comes from the document itself (the launcher's
    dump says ``launcher``; filename parsing would read no rank there)."""
    return str(doc.get("rank", "?"))


def _rank_sort_key(r: str) -> tuple:
    """Numeric ranks first in numeric order, then labels
    (``launcher``) lexicographically — the one ordering every
    rank-label sort in this module uses (mirrors obs/summary.py)."""
    return (not r.isdigit(), int(r) if r.isdigit() else 0, r)


def _lane_ids(docs: List[dict]) -> Dict[str, int]:
    """Stable small pid per trace id: step lanes first (they are the
    context every request lane is read against), then requests sorted
    by their earliest span — the waterfall reads top-to-bottom in
    arrival order."""
    first_t: Dict[str, float] = {}
    for doc in docs:
        for s in doc.get("spans", []):
            tr = s.get("trace")
            if not tr:
                continue
            t0 = float(s.get("t0", 0.0))
            if tr not in first_t or t0 < first_t[tr]:
                first_t[tr] = t0
    steps = [t for t in _STEP_TRACES if t in first_t]
    requests = sorted(
        (t for t in first_t if t not in _STEP_TRACES),
        key=lambda t: (first_t[t], t),
    )
    return {t: i + 1 for i, t in enumerate(steps + requests)}


def merge(paths: Sequence[str], out_path: str) -> int:
    """Merge span dumps into one valid Chrome trace at ``out_path``;
    returns the number of events written.  ``ts`` is wall-clock
    microseconds rebased to the job's earliest span so Perfetto opens
    near t=0."""
    docs = load_docs(paths)
    lanes = _lane_ids(docs)
    base = None
    for doc in docs:
        for s in doc.get("spans", []):
            t0 = float(s.get("t0", 0.0))
            if base is None or t0 < base:
                base = t0
    base = base or 0.0

    events: List[dict] = []
    tids = set()
    for doc in docs:
        rank = _rank_key(doc)
        try:
            rank_n = int(rank)
        except ValueError:
            rank_n = -1  # the launcher's lane
        for s in doc.get("spans", []):
            tr = s.get("trace")
            if tr not in lanes:
                continue
            epoch = int(s.get("epoch", 0))
            tid = rank_n + 1 + epoch * _EPOCH_LANE_STRIDE
            ev = {
                "ph": "X",
                "name": s.get("name", "?"),
                "pid": lanes[tr],
                "tid": tid,
                "ts": round((float(s.get("t0", 0.0)) - base) * 1e6, 1),
                "dur": round(float(s.get("dur", 0.0)) * 1e6, 1),
                "args": dict(s.get("args") or {}, epoch=epoch,
                             rank=rank),
            }
            events.append(ev)
            tids.add((lanes[tr], tid, rank, epoch))
    meta = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": trace}}
        for trace, pid in sorted(lanes.items(), key=lambda kv: kv[1])
    ] + [
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
         "args": {"name": f"rank {rank}"
                  + (f" (epoch {epoch})" if epoch else "")}}
        for pid, tid, rank, epoch in sorted(tids)
    ]
    pathspec.write_json_atomic(out_path, meta + events, indent=None)
    return len(events)


def _pcts(values: List[float]) -> Optional[dict]:
    if not values:
        return None
    xs = sorted(values)

    def pick(q: float) -> float:
        return xs[min(int(q * len(xs)), len(xs) - 1)]

    return {"n": len(xs), "p50": round(pick(0.50), 3),
            "p99": round(pick(0.99), 3), "max": round(xs[-1], 3)}


def report(paths: Sequence[str],
           expected_ranks: Optional[int] = None) -> dict:
    """The latency-decomposition report over a set of span dumps.

    Per-request component sums use the LEADER's spans (the lowest
    numeric rank that recorded the request's prefill — the leader's
    clock is also the one the ttft histogram was measured on), so the
    sum-vs-ttft check compares timestamps from a single clock."""
    docs = load_docs(paths)
    ranks_present = sorted({_rank_key(d) for d in docs},
                           key=_rank_sort_key)
    missing = []
    if expected_ranks is not None:
        have = {r for r in ranks_present if r.isdigit()}
        missing = [r for r in range(expected_ranks) if str(r) not in have]

    # trace id -> rank -> name -> [span...]
    per_req: Dict[str, Dict[str, Dict[str, List[dict]]]] = {}
    step_spans: Dict[str, List[dict]] = {}
    for doc in docs:
        rank = _rank_key(doc)
        for s in doc.get("spans", []):
            tr = s.get("trace")
            if not tr:
                continue
            if tr in _STEP_TRACES:
                # Keep the source rank with the span: the scheduler
                # residual must subtract each rank's named phases from
                # ITS OWN whole-step span, not pool all ranks into one
                # (epoch, step) bucket N-fold.
                step_spans.setdefault(s.get("name", "?"), []) \
                    .append({**s, "_rank": rank})
                continue
            per_req.setdefault(tr, {}).setdefault(rank, {}) \
                .setdefault(s.get("name", "?"), []).append(s)

    requests: Dict[str, dict] = {}
    comp_samples: Dict[str, List[float]] = {}
    ttft_samples: List[float] = []
    for rid in sorted(per_req):
        by_rank = per_req[rid]
        # leader = lowest numeric rank that prefix-recorded the request
        leader = None
        for rank in sorted(by_rank, key=_rank_sort_key):
            names = by_rank[rank]
            if "prefill" in names or "replay_prefill" in names:
                leader = rank
                break
        if leader is None:
            leader = min(by_rank, key=_rank_sort_key)
        names = by_rank[leader]
        # The ttft-bearing incarnation: the NEWEST epoch whose prefill
        # recorded a ttft sample.  Under elastic replay one rank's
        # merged doc can hold several admission chains for a rid (a
        # request re-admitted as fresh after a world break records a
        # full second chain); mixing epochs would double-count the
        # earlier incarnation's components against the final ttft.
        ttft = None
        ttft_epoch = None
        for s in names.get("prefill", ()):
            v = (s.get("args") or {}).get("ttft_ms")
            ep = int(s.get("epoch", 0))
            if v is not None and (ttft_epoch is None or ep >= ttft_epoch):
                ttft = float(v)
                ttft_epoch = ep
        components = {}
        for comp in TTFT_COMPONENTS:
            spans = [s for s in names.get(comp, ())
                     if ttft_epoch is None
                     or int(s.get("epoch", 0)) == ttft_epoch]
            if spans:
                ms = sum(s["dur"] for s in spans) * 1e3
                components[comp] = round(ms, 3)
                comp_samples.setdefault(comp, []).append(ms)
        if ttft is not None:
            ttft_samples.append(ttft)
        epochs = sorted({int(s.get("epoch", 0))
                         for spans in by_rank.values()
                         for ss in spans.values() for s in ss})
        entry = {
            "components_ms": components,
            "component_sum_ms": round(sum(components.values()), 3),
            "ttft_ms": ttft,
            "epochs": epochs,
            "replayed": any("replay_prefill" in by_rank[r]
                            for r in by_rank),
            "ranks": sorted(by_rank),
        }
        requests[rid] = entry

    tpot = {}
    # Per-step scheduler residual: whole-iteration "step" spans minus
    # the named phases inside them, keyed by (rank, epoch, step) —
    # rank so each rank's residual is its own (every rank emits step
    # spans; pooling would inflate the residual N-fold), epoch so an
    # elastic replay's repeated step numbers stay distinct.
    named_by_step: Dict[tuple, float] = {}
    step_total: Dict[tuple, float] = {}
    for name, spans in step_spans.items():
        if name in ("decode_compute", "schedule_broadcast",
                    "stream_publish", "prefill"):
            for s in spans:
                key = (s.get("_rank"), s.get("epoch", 0),
                       (s.get("args") or {}).get("step"))
                named_by_step[key] = named_by_step.get(key, 0.0) + s["dur"]
        if name == "step":
            for s in spans:
                key = (s.get("_rank"), s.get("epoch", 0),
                       (s.get("args") or {}).get("step"))
                step_total[key] = step_total.get(key, 0.0) + s["dur"]
    sched_residual = [
        (step_total[k] - named_by_step.get(k, 0.0)) * 1e3
        for k in step_total
    ]
    for comp in TPOT_COMPONENTS:
        if comp == "scheduler":
            stats = _pcts([max(v, 0.0) for v in sched_residual])
        else:
            stats = _pcts([s["dur"] * 1e3 for s in step_spans.get(comp, ())])
        if stats is not None:
            tpot[comp] = stats

    return {
        "schema": REPORT_SCHEMA,
        "ranks_present": ranks_present,
        "missing_ranks": missing,
        "requests": requests,
        "ttft_components": {
            comp: _pcts(vals) for comp, vals in sorted(comp_samples.items())
        },
        "ttft_ms": _pcts(ttft_samples),
        "tpot_components": tpot,
    }


def per_rank_glob(raw: str) -> str:
    return pathspec.glob_pattern(raw, "spans")


def merged_output_paths(raw: str) -> tuple:
    """(waterfall path, report path) for a ``HVDTPU_TRACE`` value —
    named so the per-rank glob can never re-consume them."""
    if "{rank}" in raw:
        base, ext = os.path.splitext(raw.replace("{rank}", "merged"))
        return f"{base}{ext or '.json'}", f"{base}.report{ext or '.json'}"
    if raw.endswith(os.sep) or os.path.isdir(raw):
        return (os.path.join(raw, "trace_waterfall.json"),
                os.path.join(raw, "trace_report.json"))
    base, ext = os.path.splitext(raw)
    return (f"{base}.waterfall{ext or '.json'}",
            f"{base}.report{ext or '.json'}")


def merge_glob(raw: str, expected_ranks: Optional[int] = None
               ) -> Optional[dict]:
    """Merge every per-rank span file derived from the ``HVDTPU_TRACE``
    value ``raw``: writes the waterfall and the report, returns
    ``{"waterfall", "report", "events", "doc"}`` or None when no rank
    dumped spans."""
    wf_path, rep_path = merged_output_paths(raw)
    skip = {os.path.abspath(wf_path), os.path.abspath(rep_path)}
    paths = [p for p in glob.glob(per_rank_glob(raw))
             if os.path.abspath(p) not in skip]
    if not paths:
        return None
    n = merge(paths, wf_path)
    doc = report(paths, expected_ranks=expected_ranks)
    pathspec.write_json_atomic(rep_path, doc)
    return {"waterfall": wf_path, "report": rep_path, "events": n,
            "doc": doc}


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print("usage: python -m horovod_tpu_torch.obs.trace_merge "
              "OUT_PREFIX SPAN_FILE [SPAN_FILE ...]\n"
              "   or: python -m horovod_tpu_torch.obs.trace_merge --glob RAW "
              "(the HVDTPU_TRACE value)", file=sys.stderr)
        return 2
    if argv[0] == "--glob":
        out = merge_glob(argv[1])
        if out is None:
            print("no span files found", file=sys.stderr)
            return 1
        print(f"merged {out['events']} spans -> {out['waterfall']}; "
              f"report -> {out['report']}")
        return 0
    out_prefix, paths = argv[0], argv[1:]
    n = merge(paths, out_prefix + ".waterfall.json")
    doc = report(paths)
    pathspec.write_json_atomic(out_prefix + ".report.json", doc)
    print(f"merged {n} spans from {len(paths)} files into "
          f"{out_prefix}.waterfall.json "
          f"({len(doc['requests'])} requests decomposed)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
