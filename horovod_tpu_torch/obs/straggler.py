"""Straggler attribution: who kept everyone waiting, with evidence.

The reference's answer to "which rank is the straggler?" is eyeballing
timeline lanes by hand (or the stall inspector's 60-second warnings,
which only fire for outright stalls).  This module turns the per-op
arrival data both collective paths already see into accumulated metrics:

* ``engine.straggler.last_arrivals{rank=K}`` — counter: how many
  collectives rank K was the *last* to arrive at (only ops whose
  arrivals spanned more than one negotiation cycle / a real wait count —
  same-cycle completion blames nobody).
* ``engine.straggler.skew_ms`` — histogram of first-to-last arrival skew.
* ``engine.straggler.worst_skew_ms`` / ``engine.straggler.last_rank`` —
  gauges for the live digest.
* ``engine.straggler.alerts`` — counter, one per skew past the
  ``--alert-skew-ms`` threshold (which also logs a warning naming the
  rank, the skew, and the tensor).

Producers: the eager controller (runtime/controller.py — deterministic,
so every rank accumulates the identical attribution) and the elastic
context's KV collectives (per-peer wait times; each rank blames the peer
it actually waited on).  Attribution is reset at elastic rendezvous so a
re-formed world — survivors included — starts its incarnation with clean
counts.

Consumers: the live aggregator's digest and ``/metrics`` exposition
(obs/live.py), and the ``--stats-summary`` straggler section
(obs/summary.py).

A copy of the reference's ``horovod_tpu/obs/straggler.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..utils.logging import get_logger
from .registry import get_registry

LOG = get_logger("obs.straggler")

PREFIX = "engine.straggler."

# Elastic KV waits shorter than this are polling noise, not stragglers
# (_POLL_SECS is 0.05; one or two sleeps happen even in a healthy step).
MIN_WAIT_SECS = 0.15

__all__ = [
    "PREFIX",
    "MIN_WAIT_SECS",
    "record",
    "record_waits",
    "merge_blames",
    "reset",
]


def _slice_tag(rank: int) -> dict:
    """``{"slice": str(k)}`` on multi-slice topologies, ``{}`` otherwise.
    Single-slice jobs keep the untagged counter identity so their dumps
    (and every existing consumer) are byte-compatible."""
    try:
        from .. import basics  # noqa: PLC0415

        if basics.is_initialized() and basics.num_slices() > 1:
            return {"slice": str(basics.slice_of_rank(rank))}
    except Exception:
        pass
    return {}


def record(
    rank: int,
    skew_ms: float,
    *,
    tensor: Optional[str] = None,
    timeline=None,
    alert_ms: float = 0.0,
) -> None:
    """Blame ``rank`` for one collective's arrival skew of ``skew_ms``.
    On multi-slice topologies the last-arrivals counter also carries the
    blamed rank's slice, so the merger can name the straggling SLICE —
    the actionable unit when a whole pod's DCN link is the problem."""
    reg = get_registry()
    reg.counter(
        PREFIX + "last_arrivals", rank=str(rank), **_slice_tag(rank)
    ).inc()
    reg.histogram(PREFIX + "skew_ms").observe(skew_ms)
    worst = reg.gauge(PREFIX + "worst_skew_ms")
    if skew_ms > worst.value:
        worst.set(skew_ms)
    reg.gauge(PREFIX + "last_rank").set(rank)
    if timeline is not None:
        timeline.counter(
            "straggler_skew_ms", {"skew_ms": round(skew_ms, 3)}
        )
    if alert_ms and skew_ms > alert_ms:
        reg.counter(PREFIX + "alerts").inc()
        LOG.warning(
            "straggler: rank %d arrived %.0f ms after the first rank%s "
            "(> alert threshold %.0f ms)",
            rank, skew_ms,
            f" for tensor {tensor!r}" if tensor else "",
            alert_ms,
        )


def record_waits(
    waits: Dict[int, float],
    self_rank: int,
    *,
    tensor: Optional[str] = None,
    alert_ms: float = 0.0,
    floor_secs: float = MIN_WAIT_SECS,
) -> Optional[int]:
    """Elastic-path attribution: ``waits`` maps peer rank -> seconds this
    rank spent blocked polling for that peer's contribution.  Blames the
    peer waited on longest when that wait is past the noise floor;
    returns the blamed rank (or None).  A delayed rank waits on nobody,
    so it never blames an innocent peer for its own lateness."""
    candidates = {r: w for r, w in waits.items() if r != self_rank}
    if not candidates:
        return None
    worst_rank = max(candidates, key=lambda r: (candidates[r], -r))
    worst_wait = candidates[worst_rank]
    if worst_wait < floor_secs:
        return None
    record(worst_rank, worst_wait * 1e3, tensor=tensor, alert_ms=alert_ms)
    return worst_rank


def merge_blames(metric_lists) -> Optional[dict]:
    """Merge ``engine.straggler.*`` instruments from several reporters
    (per-rank dumps, or live views) into one verdict — the SINGLE
    implementation behind both the live digest/exposition and the
    ``--stats-summary`` straggler section, so they can never name
    different stragglers for the same data.

    ``metric_lists``: iterable of per-reporter metric-dict iterables
    (dump-schema form).  Counts merge max-per-reporter: eager
    attribution is deterministic and identical on every rank (max ==
    the value), elastic attribution is each rank's personally-suffered
    waits (max keeps the strongest single witness instead of
    double-counting agreement).  Returns None when nobody was blamed,
    else ``{rank, last_arrivals, share, blames, skew, worst_skew_ms,
    alerts}`` with ``blames`` the full per-rank merged counts and
    ``skew`` the largest reporter's histogram fields.  When the counters
    carry slice tags (multi-slice jobs), the verdict also includes
    ``slice`` (the slice whose ranks drew the most blame) and
    ``slice_blames`` — the slice-level verdict the live digest and the
    summary print as "slice K is the straggler"."""
    blames: Dict[int, int] = {}
    rank_slice: Dict[int, int] = {}
    worst_skew = 0.0
    skew = {"count": 0, "p50": None, "p99": None, "max": None}
    alerts = 0
    for metrics in metric_lists:
        for m in metrics:
            name = m.get("name", "")
            if name == PREFIX + "last_arrivals":
                tags = m.get("tags") or {}
                try:
                    blamed = int(tags["rank"])
                except (KeyError, TypeError, ValueError):
                    continue
                blames[blamed] = max(blames.get(blamed, 0),
                                     int(m["value"]))
                if "slice" in tags:
                    try:
                        rank_slice[blamed] = int(tags["slice"])
                    except (TypeError, ValueError):
                        pass
            elif name == PREFIX + "worst_skew_ms":
                worst_skew = max(worst_skew, float(m["value"]))
            elif name == PREFIX + "skew_ms":
                if int(m.get("count") or 0) > skew["count"]:
                    skew = {k: m.get(k)
                            for k in ("count", "p50", "p99", "max")}
            elif name == PREFIX + "alerts":
                alerts = max(alerts, int(m["value"]))
    if not blames:
        return None
    top = max(blames, key=lambda r: (blames[r], -r))
    total = sum(blames.values())
    verdict = {
        "rank": top,
        "last_arrivals": blames[top],
        "share": blames[top] / total if total else 0.0,
        "blames": blames,
        "skew": skew,
        "worst_skew_ms": round(worst_skew, 3),
        "alerts": alerts,
    }
    if rank_slice:
        slice_blames: Dict[int, int] = {}
        for r, count in blames.items():
            s = rank_slice.get(r)
            if s is not None:
                slice_blames[s] = slice_blames.get(s, 0) + count
        if slice_blames:
            top_slice = max(
                slice_blames, key=lambda s: (slice_blames[s], -s)
            )
            verdict["slice"] = top_slice
            verdict["slice_blames"] = slice_blames
            verdict["slice_share"] = (
                slice_blames[top_slice] / total if total else 0.0
            )
    return verdict


def reset() -> None:
    """Drop every straggler instrument — called at elastic rendezvous so
    a re-formed world's attribution starts clean (a respawned rank is a
    fresh process anyway; this covers the surviving ranks)."""
    get_registry().remove_matching(PREFIX)
