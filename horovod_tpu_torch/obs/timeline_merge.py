"""Merge per-rank Chrome-trace timelines into one all-rank trace.

Every rank now records its own timeline (runtime/timeline.py; the
reference records rank 0 only, timeline.cc).  The per-rank writers use
the streaming-tolerant trace format — ``[`` then one comma-terminated
event per line, no required ``]`` — so a rank killed mid-job (elastic
respawn, OOM) still leaves a loadable trace.  This module repairs and
merges those files into a single *valid-JSON* Chrome trace with one
``pid`` lane per rank, which is where cross-rank negotiation skew first
becomes visible: the same tensor's NEGOTIATE bar on every lane, start
offsets = straggler ranks.

Used by the launcher at job end (run/runner.py) and directly::

    python -m horovod_tpu_torch.obs.timeline_merge out.json rank0.json rank1.json

A copy of the reference's ``horovod_tpu/obs/timeline_merge.py``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Optional, Sequence, Tuple

from . import pathspec
from .pathspec import epoch_of_path, rank_of_path

__all__ = ["load_events", "merge", "merge_glob", "rank_of_path"]

# Lane id for incarnation (rank, epoch): epochs beyond the first get
# their own pid lane — two processes' perf_counter-relative timestamps
# both start near 0, so sharing a lane would garble the bars.
_EPOCH_LANE_STRIDE = 100000


def load_events(path: str) -> List[dict]:
    """Load one timeline file, tolerating truncation.

    Accepts well-formed arrays (the native engine still closes its
    ``]``), the streaming format (trailing comma, no terminator), and a
    file cut mid-event by a kill — the trailing partial line is dropped,
    everything before it survives.  Non-dict and empty entries are
    filtered out.
    """
    with open(path) as f:
        text = f.read().strip()
    if not text:
        return []
    events: Optional[list] = None
    try:
        events = json.loads(text)
    except ValueError:
        body = text.lstrip("[").rstrip().rstrip(",")
        while body:
            try:
                events = json.loads(f"[{body}]")
                break
            except ValueError:
                # drop the last (possibly half-written) event line and
                # retry; bounded by the number of newlines in the file
                cut = body.rfind("\n")
                if cut < 0:
                    events = []
                    break
                body = body[:cut].rstrip().rstrip(",")
    if not isinstance(events, list):
        return []
    return [e for e in events if isinstance(e, dict) and e]


def merge(paths: Sequence[str], out_path: str) -> int:
    """Merge per-rank trace files into one valid Chrome trace at
    ``out_path``; returns the number of events written.

    Each incarnation gets its own ``pid`` lane — ``rank`` for the first
    epoch, a distinct id for later (elastic respawn) incarnations, since
    every process's timestamps restart near zero and sharing a lane
    would overlay the two lifetimes.  ``process_name`` metadata events
    label the lanes.  Ordering is preserved per file; Chrome/Perfetto
    sort by ``ts`` internally.
    """
    merged: List[dict] = []
    lanes: List[Tuple[int, str]] = []
    for path in sorted(paths):
        events = load_events(path)
        if not events:
            continue
        path_rank = rank_of_path(path)
        epoch = epoch_of_path(path) or 0
        lane = (path_rank if path_rank is not None else 0)
        lane += epoch * _EPOCH_LANE_STRIDE
        for ev in events:
            if ev.get("ph") == "M" and ev.get("name") == "trace_complete":
                continue  # writer terminator, not a lane event
            if path_rank is not None:
                ev["pid"] = lane
            merged.append(ev)
        label = f"rank {path_rank if path_rank is not None else 0}"
        if epoch:
            label += f" (epoch {epoch})"
        lanes.append((lane, label))
    meta = [
        {"ph": "M", "name": "process_name", "pid": lane, "tid": 0,
         "args": {"name": label}}
        for lane, label in sorted(set(lanes))
    ]
    pathspec.write_json_atomic(out_path, meta + merged, indent=None)
    return len(merged)


def per_rank_glob(raw: str) -> str:
    """The glob matching every per-rank file the writers derive from a
    ``HVDTPU_TIMELINE`` value (same rules module as resolve_path)."""
    return pathspec.glob_pattern(raw, "trace")


def merged_output_path(raw: str) -> str:
    """Where the launcher writes the merged trace: the raw path itself
    for the plain-file form (so ``--timeline-filename t.json`` still
    ends with ``t.json``, now holding every rank), ``merged.json``
    inside the directory form, and ``<template>.merged.json`` for
    templates."""
    if "{rank}" in raw:
        base, ext = os.path.splitext(raw.replace("{rank}", "merged"))
        return f"{base}{ext or '.json'}"
    if raw.endswith(os.sep) or os.path.isdir(raw):
        return os.path.join(raw, "merged.json")
    return raw


def merge_glob(raw: str, out_path: Optional[str] = None) -> Optional[str]:
    """Merge every per-rank file derived from the ``HVDTPU_TIMELINE``
    value ``raw``; returns the merged path, or None when no per-rank
    files exist (e.g. remote-only ranks)."""
    out = out_path or merged_output_path(raw)
    paths = [p for p in glob.glob(per_rank_glob(raw))
             if os.path.abspath(p) != os.path.abspath(out)]
    if not paths:
        return None
    merge(paths, out)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print("usage: python -m horovod_tpu_torch.obs.timeline_merge "
              "OUT.json RANK_FILE [RANK_FILE ...]", file=sys.stderr)
        return 2
    n = merge(argv[1:], argv[0])
    print(f"merged {n} events from {len(argv) - 1} files into {argv[0]}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
