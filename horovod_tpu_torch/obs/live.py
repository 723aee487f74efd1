"""Launcher-side live telemetry: merged job view, digest, history,
Prometheus exposition (counterpart of ``horovod_tpu/obs/live.py``).

The consumer half of the streaming plane (worker half: obs/stream.py).
The launcher's aggregator thread scans its own KV store for per-rank
snapshot deltas under ``obs/live/{epoch}/{rank}/{seq}``, applies them to
a merged job-level view keyed by (rank, elastic incarnation), and every
round:

* prints a one-line console digest (ranks reporting, total collectives,
  phase spread, and — the question this plane exists for — the current
  straggler with evidence);
* appends one JSON line to a crash-safe ``live_history.jsonl`` (append +
  flush per round: a killed launcher leaves every completed round
  parseable);
* serves the merged view as Prometheus text exposition from the
  read-only unauthenticated ``GET /metrics`` branch the aggregator
  registers on the ``KVStoreServer`` — an external scraper can attach to
  an in-flight job with nothing but the port (PUTs stay HMAC-gated; the
  exposition leaks only metric values).

Incarnation semantics: a rank respawned by the elastic launcher
publishes under its new spawn epoch; :meth:`LiveAggregator.merged`
surfaces each rank's *newest* incarnation while older incarnations stay
queryable (label ``epoch`` in the exposition) — a dead incarnation's
last snapshot is evidence, not noise.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..utils.logging import get_logger
from . import stream as obs_stream
from . import straggler as obs_straggler

LOG = get_logger("obs.live")

__all__ = ["LiveAggregator", "LivePlane", "prometheus_escape"]


class _RankView:
    """One (rank, epoch) incarnation's latest state."""

    def __init__(self, rank: int, epoch: int):
        self.rank = rank
        self.epoch = epoch
        self.metrics: Dict[str, dict] = {}
        self.seq = -1
        self.phase: Optional[str] = None
        self.progress = 0
        self.wall_time = 0.0
        self.seen_mono = 0.0


def prometheus_escape(value: str) -> str:
    return (
        str(value).replace("\\", r"\\").replace('"', r'\"')
        .replace("\n", r"\n")
    )


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    if not out or out[0].isdigit():
        out = "_" + out
    return "hvdtpu_" + out


# Exposition HELP text for the series operators actually alert on; the
# rest get an honest generic line.  Keyed by instrument name (pre-
# prom-mangling) so the map reads like the metric docs.
_METRIC_HELP = {
    "serve.ttft_ms": "Time to first token per request, milliseconds",
    "serve.tpot_ms": "Per-decode-step latency per emitted token, "
                     "milliseconds",
    "serve.tokens_per_sec": "Sliding wall-clock window token "
                            "throughput (shared timestamps with the "
                            "trace plane's decode spans)",
    "serve.queue_depth": "Requests admitted to the log but not yet in "
                         "a decode slot",
    "serve.active_slots": "Decode slots currently generating",
    "perf.mfu": "Model FLOP/s utilization: model FLOPs per step over "
                "measured step time over device peak (see "
                "perf.mfu_estimate)",
    "perf.mfu_estimate": "1 when perf.mfu's device peak is an "
                         "estimate (CPU/unknown card), 0 on a card in the peak "
                         "table",
    "perf.model_tflops": "Achieved model TFLOP/s from the step's "
                         "analytic FLOP count",
    "perf.step_ms": "Last measured step time, milliseconds",
    "engine.cycle_time_ms": "Background negotiation-loop cycle time, "
                            "milliseconds",
    "engine.negotiation_ms": "Control-plane exchange time per cycle, "
                             "milliseconds",
    "mem.hbm_bytes_in_use": "CUDA caching allocator's device bytes in "
                            "use (memory_stats; absent on CPU)",
    "mem.hbm_peak_bytes": "Backend-reported peak device bytes in use",
    "mem.hbm_limit_bytes": "Backend-reported device memory limit",
    "mem.headroom_bytes": "Device memory limit minus bytes in use",
    "mem.live_bytes": "Device bytes allocated by this process, or the "
                      "owners' tensor bytes on CPU (host-triggered "
                      "census, obs/memplane.py)",
    "mem.owner_bytes": "Tensor bytes per logical owner (params / "
                       "optimizer_state / grad_buckets / kv_cache / "
                       "other)",
    "serve.kv.allocated_bytes": "KV bytes the fixed-row slot pool "
                                "reserves for the busy slots "
                                "(slots-in-use x max_len rows)",
    "serve.kv.live_bytes": "KV bytes the busy slots actually wrote "
                           "(sum of per-slot positions)",
    "serve.kv.waste_ratio": "1 - live/allocated KV bytes: the tail "
                            "paged attention would reclaim",
    "goodput.fraction": "Share of this rank's wall-clock spent in "
                        "productive steps (obs/goodput.py ledger)",
    "goodput.secs": "Wall-clock seconds per goodput class (init / "
                    "compile / productive_step / collective_wait / "
                    "checkpoint / recovery / idle / degraded)",
    "goodput.lost_secs": "Seconds lost to elastic events, attributed "
                         "by cause (rendezvous / respawn / stall)",
    "serve.goodput.token_fraction": "Decode tokens emitted over slot "
                                    "capacity (tokens / steps x slots)",
    "serve.goodput.tokens_per_slot_sec": "Decode tokens per slot per "
                                         "wall-clock second",
    "serve.slo.p50_ms": "Per-tenant/SLO-class sliding-window latency "
                        "median (metric label: ttft or tpot)",
    "serve.slo.p99_ms": "Per-tenant/SLO-class sliding-window latency "
                        "p99 (metric label: ttft or tpot)",
    "serve.slo.burn": "Error-budget burn rate over the labelled "
                      "window (fast=cliffs, slow=slow burns); 1.0 "
                      "spends the budget exactly at the objective",
    "serve.slo.alert": "1 while the labelled window's burn rate is "
                       "over its alerting threshold",
    "serve.slo.breaches": "Requests over their SLO ceiling, by "
                          "tenant/class/metric",
    "serve.slo.alerts": "Burn-rate alert rising edges, by "
                        "tenant/class/metric",
    "health.loss": "Per-step training loss from the in-graph health "
                   "bundle (obs/health.py)",
    "health.grad_norm": "Global gradient L2 norm per step",
    "health.grad_norm_z": "Robust z-score of the last grad norm "
                          "against its EWMA baseline (-1 = nonfinite)",
    "health.update_ratio_max": "Max per-leaf |update|/|param| ratio "
                               "this step",
    "health.nonfinite": "Nonfinite gradient elements this step",
    "health.nonfinite_total": "Cumulative nonfinite gradient elements",
    "health.bucket_grad_norm": "Gradient L2 norm per overlap bucket "
                               "(label: bucket index)",
    "health.alert": "1 while the labelled anomaly class is firing "
                    "(loss-spike / grad-explode / grad-vanish / "
                    "dead-gradient / nonfinite)",
    "health.alerts": "Anomaly alert rising edges, by class",
    "health.divergence.checks": "Cross-rank digest exchanges completed "
                                "by the divergence sentinel",
    "health.divergence.detected": "Confirmed cross-rank state "
                                  "divergences (labels: component, "
                                  "leaf)",
    "health.divergence.last_check_step": "Step of the sentinel's most "
                                         "recent digest exchange",
    "health.divergence.alert": "1 after a divergence was detected, 0 "
                               "while checks pass",
}


def _prom_help(name: str, kind: str) -> str:
    text = _METRIC_HELP.get(
        name, f"horovod_tpu {kind} {name} (per-rank instrument, "
              f"obs/registry.py)"
    )
    # Exposition escaping for HELP: backslash and newline only.
    return text.replace("\\", r"\\").replace("\n", r"\n")


class LiveAggregator:
    """Merged job-level view of every rank's streamed snapshots.
    Thread-safe: the HTTP handler renders from scraper threads while the
    aggregator thread ingests."""

    def __init__(self):
        # RLock: digest()/history_row() compose merged()+straggler(),
        # and every reader holds the lock for its WHOLE traversal — the
        # /metrics handler thread renders concurrently with ingest, and
        # iterating a view dict mid-apply_delta would raise.
        self._lock = threading.RLock()
        self._views: Dict[Tuple[int, int], _RankView] = {}
        self.rounds = 0
        # Last serving-world size the digest printed: the autoscale
        # token shows transitions ("world 4→6") across rounds.
        self._serve_world_prev: Optional[int] = None
        # Perf-trend token, computed once per process: the committed
        # BENCH trajectory can't change mid-job, and digest() runs on
        # every round — don't re-read the record dir each time.
        # False = not yet computed (None is a valid "no token" result).
        self._trend_token: object = False

    # ------------------------------------------------------------ ingest

    def ingest(self, doc: dict) -> None:
        """Apply one worker payload (obs/stream.py wire contract)."""
        rank, epoch = int(doc["rank"]), int(doc.get("epoch", 0))
        with self._lock:
            view = self._views.get((rank, epoch))
            if view is None:
                view = self._views[(rank, epoch)] = _RankView(rank, epoch)
            if doc.get("full"):
                # A full snapshot is authoritative: a publisher restarted
                # in-process (seq reset) must not leave phantom metrics.
                view.metrics = {}
            obs_stream.apply_delta(view.metrics, doc.get("metrics", []))
            view.seq = max(view.seq, int(doc.get("seq", 0)))
            view.phase = doc.get("phase") or view.phase
            view.progress = int(doc.get("progress", view.progress))
            view.wall_time = float(doc.get("t", view.wall_time))
            view.seen_mono = time.monotonic()

    # ------------------------------------------------------------ views

    def merged(self) -> Dict[int, _RankView]:
        """rank -> newest incarnation's view."""
        with self._lock:
            out: Dict[int, _RankView] = {}
            for (rank, _), view in sorted(self._views.items()):
                cur = out.get(rank)
                if cur is None or view.epoch > cur.epoch:
                    out[rank] = view
            return out

    def incarnations(self) -> List[_RankView]:
        with self._lock:
            return [self._views[k] for k in sorted(self._views)]

    # -------------------------------------------------------- straggler

    def straggler(self) -> Optional[dict]:
        """Current top straggler from the merged incarnation views —
        the SAME verdict ``--stats-summary`` computes over the exit
        dumps (shared implementation: obs/straggler.py merge_blames)."""
        with self._lock:
            verdict = obs_straggler.merge_blames(
                [list(v.metrics.values()) for v in self.merged().values()]
            )
        if verdict is None:
            return None
        out = {
            "rank": verdict["rank"],
            "last_arrivals": verdict["last_arrivals"],
            "share": verdict["share"],
            "worst_skew_ms": verdict["worst_skew_ms"],
            "ops_with_skew": int(verdict["skew"]["count"] or 0),
        }
        if "slice" in verdict:
            out["slice"] = verdict["slice"]
            out["slice_share"] = verdict["slice_share"]
        return out

    # ----------------------------------------------------------- digest

    def digest(self, expected_ranks: Optional[int] = None) -> str:
        with self._lock:
            views = self.merged()
            if not views:
                return "live: no rank has reported yet"
            total = "?" if expected_ranks is None else str(expected_ranks)
            progress = {r: v.progress for r, v in views.items()}
            lo_rank = min(progress, key=lambda r: (progress[r], r))
            phases = sorted({v.phase or "?" for v in views.values()})
            strag = self.straggler()
        parts = [
            f"ranks {len(views)}/{total}",
            f"collectives min {progress[lo_rank]} (rank {lo_rank}) "
            f"max {max(progress.values())}",
            "phase " + "/".join(phases),
        ]
        if strag is not None:
            token = (
                f"straggler rank {strag['rank']} "
                f"({strag['last_arrivals']} last-arrivals, "
                f"{strag['share']:.0%}, worst skew "
                f"{strag['worst_skew_ms']:.0f}ms)"
            )
            if "slice" in strag:
                token += (
                    f" — slice {strag['slice']} is the straggler "
                    f"({strag['slice_share']:.0%} of blame)"
                )
            parts.append(token)
        else:
            parts.append("straggler none")
        tuner = self._tuner_part(views)
        if tuner:
            parts.append(tuner)
        fabric = self._fabric_part(views)
        if fabric:
            parts.append(fabric)
        ckpt = self._ckpt_part(views)
        if ckpt:
            parts.append(ckpt)
        serve = self._serve_part(views)
        if serve:
            parts.append(serve)
        slo = self._slo_part(views)
        if slo:
            parts.append(slo)
        health = self._health_part(views)
        if health:
            parts.append(health)
        goodput = self._goodput_part(views)
        if goodput:
            parts.append(goodput)
        autoscale = self._autoscale_part(views)
        if autoscale:
            parts.append(autoscale)
        frontdoor = self._frontdoor_part()
        if frontdoor:
            parts.append(frontdoor)
        perf = self._perf_part(views)
        if perf:
            parts.append(perf)
        mem = self._mem_part(views)
        if mem:
            parts.append(mem)
        trend = self._trend_part()
        if trend:
            parts.append(trend)
        return "live[" + time.strftime("%H:%M:%S") + "] " + " | ".join(parts)

    def _trend_part(self) -> Optional[str]:
        """One digest token for the perf-trend verdict (obs/trend.py):
        only speaks when the committed BENCH trajectory is dark, so an
        operator babysitting a hardware window learns "the last N
        records were all degraded" before burning the window on another
        one.  Quiet on healthy or empty trajectories."""
        if self._trend_token is False:
            token = None
            try:
                from . import trend as obs_trend  # noqa: PLC0415

                stamp = obs_trend.trend_stamp()
                if stamp is not None and stamp["degraded_streak"]:
                    token = (
                        f"trend {stamp['degraded_streak']} records dark"
                        + (f", last real {stamp['last_real_record']}"
                           if stamp["last_real_record"] else "")
                    )
            except Exception:
                token = None
            self._trend_token = token
        return self._trend_token  # type: ignore[return-value]

    @staticmethod
    def _tuner_part(views) -> Optional[str]:
        """One digest token for the rank-0 autotuner + replay fast path
        (runtime/autotune.py gauges; absent when tuning is off), so an
        operator watching the console sees what the tuner is doing and
        how much negotiation the engine is skipping."""
        from ..runtime.autotune import STATE_NAMES  # noqa: PLC0415

        def metric(view, name):
            for m in view.metrics.values():
                if m.get("name") == name and not m.get("tags"):
                    return m.get("value")
            return None

        for view in views.values():
            state = metric(view, "autotune.state")
            if state is None:
                continue
            bits = [
                "tuner "
                + STATE_NAMES.get(int(state), str(int(state)))
                + f" f={metric(view, 'autotune.fusion_mb') or 0:.0f}MB"
                + f" c={metric(view, 'autotune.cycle_ms') or 0:.1f}ms"
            ]
            reopens = metric(view, "autotune.reopens")
            if reopens:
                bits.append(f"reopens {int(reopens)}")
            skip = metric(view, "engine.negotiation_skip_rate")
            if skip is not None:
                bits.append(f"neg-skip {skip:.0%}")
            return " ".join(bits)
        # no tuner: still surface the replay skip rate when present
        for view in views.values():
            skip = metric(view, "engine.negotiation_skip_rate")
            if skip is not None:
                return f"neg-skip {skip:.0%}"
        return None

    @staticmethod
    def _fabric_part(views) -> Optional[str]:
        """One digest token for the two-fabric data path (multislice
        jobs): bytes over DCN vs ICI and the DCN compression factor —
        absent on single-slice jobs, whose planes never touch these
        counters.  Worst (max) per-rank view: the counters are
        deterministic and near-identical across ranks, and max never
        under-reports a fabric."""
        dcn = ici = 0.0
        ratio = None
        for view in views.values():
            for m in view.metrics.values():
                name = m.get("name")
                if name == "engine.dcn_bytes":
                    dcn = max(dcn, float(m["value"]))
                elif name == "engine.ici_bytes":
                    ici = max(ici, float(m["value"]))
                elif name == "engine.dcn_compression_ratio":
                    v = float(m["value"])
                    ratio = v if ratio is None else max(ratio, v)
        if not dcn and not ici:
            return None
        token = f"fabric dcn {dcn / 1e6:.1f}MB ici {ici / 1e6:.1f}MB"
        if ici:
            token += f" (dcn/ici {dcn / ici:.2f})"
        if ratio and ratio > 1.0:
            token += f" wire x{ratio:.1f}"
        return token

    @staticmethod
    def _ckpt_part(views) -> Optional[str]:
        """One digest token for the checkpoint/replica tier (ckpt/):
        how many recoveries sourced from a live peer vs disk, and the
        replica-push latency — absent while the tier is idle, so quiet
        jobs stay quiet."""
        sources: Dict[str, int] = {}
        pushes = 0
        push_p50 = None
        for view in views.values():
            for m in view.metrics.values():
                name = m.get("name")
                if name == "ckpt.restore_source":
                    src = (m.get("tags") or {}).get("source", "?")
                    sources[src] = sources.get(src, 0) + int(m["value"])
                elif name == "ckpt.replica_pushes":
                    pushes += int(m["value"])
                elif name == "ckpt.replica_push_ms" and m.get("count"):
                    # Worst per-rank p50, not last-iterated: the digest
                    # exists to surface the slow rank, not to hide it
                    # behind dict iteration order.
                    p50 = m.get("p50")
                    if p50 is not None:
                        push_p50 = p50 if push_p50 is None \
                            else max(push_p50, p50)
        if not sources and not pushes:
            return None
        bits = []
        if sources:
            bits.append("restores " + " ".join(
                f"{k}={sources[k]}" for k in ("peer", "disk", "none")
                if k in sources
            ))
        if pushes:
            token = f"pushes {pushes}"
            if push_p50 is not None:
                token += f" (worst p50 {push_p50:.0f}ms)"
            bits.append(token)
        return "ckpt " + " ".join(bits)

    @staticmethod
    def _serve_part(views) -> Optional[str]:
        """One digest token for the serving plane (serve/): queue
        depth, live slots, throughput and first-token latency — the
        autoscaling quartet — absent on jobs that never served.  Worst
        (max) per-rank queue/latency: the digest exists to surface the
        pressure, not to average it away."""
        depth = slots = None
        ttft = None
        pages_free = pages_used = None
        # tokens/sec: groups of a width-sharded fleet are INDEPENDENT
        # capacity — sum the per-group rates (max within a group: its
        # replicated peers report the same stream).  Ranks without a
        # serve.group gauge (legacy replicated fleet) all fold into
        # one bucket, preserving the old max semantics.
        tps_by_group: dict = {}
        for view in views.values():
            group_id = None
            for m in view.metrics.values():
                if m.get("name") == "serve.group":
                    group_id = m.get("value")
                    break
            for m in view.metrics.values():
                name = m.get("name")
                if name == "serve.queue_depth":
                    v = float(m["value"])
                    depth = v if depth is None else max(depth, v)
                elif name == "serve.active_slots":
                    v = float(m["value"])
                    slots = v if slots is None else max(slots, v)
                elif name == "serve.tokens_per_sec":
                    v = float(m["value"])
                    tps_by_group[group_id] = max(
                        tps_by_group.get(group_id, 0.0), v)
                elif name == "serve.ttft_ms" and m.get("count"):
                    p50 = m.get("p50")
                    if p50 is not None:
                        ttft = p50 if ttft is None else max(ttft, p50)
                elif name == "serve.kv.page_free":
                    v = float(m["value"])
                    # Tightest (min-free) rank: page pressure is what
                    # gates admission, so surface the worst of it.
                    pages_free = v if pages_free is None \
                        else min(pages_free, v)
                elif name == "serve.kv.page_used":
                    v = float(m["value"])
                    pages_used = v if pages_used is None \
                        else max(pages_used, v)
        if depth is None and slots is None:
            return None
        tps = sum(tps_by_group.values())
        token = (f"serve q={int(depth or 0)} "
                 f"slots={int(slots or 0)} {tps:.0f} tok/s")
        if ttft is not None:
            token += f" ttft p50 {ttft:.0f}ms"
        if pages_free is not None or pages_used is not None:
            token += (f" pages {int(pages_used or 0)}u/"
                      f"{int(pages_free or 0)}f")
        return token

    @staticmethod
    def _slo_part(views) -> Optional[str]:
        """One digest token for the tenant SLO burn-rate plane
        (obs/slo.py): ``slo OK burn 0.4x`` while the budget holds,
        ``slo ALERT acme/interactive ttft fast 12.3x`` the moment a
        window's burn rate crosses its threshold — the alert an
        operator must see without opening /metrics.  Absent on jobs
        that never digested SLO traffic, so untagged fleets stay
        quiet."""
        firing: List[str] = []
        worst_burn = None
        saw_series = False
        for view in views.values():
            for m in view.metrics.values():
                name = m.get("name")
                if name == "serve.slo.burn":
                    saw_series = True
                    v = float(m["value"])
                    worst_burn = v if worst_burn is None \
                        else max(worst_burn, v)
                elif name == "serve.slo.alert" and float(m["value"]):
                    tags = m.get("tags") or {}
                    firing.append(
                        f"{tags.get('tenant', '?')}/"
                        f"{tags.get('slo', '?')} "
                        f"{tags.get('metric', '?')} "
                        f"{tags.get('window', '?')}"
                    )
        if not saw_series:
            return None
        if firing:
            return "slo ALERT " + ", ".join(sorted(set(firing))) + (
                f" (worst burn {worst_burn:.1f}x)"
                if worst_burn is not None else ""
            )
        return f"slo OK burn {worst_burn or 0.0:.1f}x"

    @staticmethod
    def _health_part(views) -> Optional[str]:
        """One digest token for the training-health plane
        (obs/health.py): ``health OK`` while the numerics are clean,
        ``health ALERT(loss-spike, divergence)`` when an anomaly class
        or the cross-rank sentinel is firing — silent corruption an
        operator must see without opening /metrics.  Absent on jobs
        that never armed ``--health``, so serving fleets stay quiet."""
        firing: List[str] = []
        saw_series = False
        for view in views.values():
            for m in view.metrics.values():
                name = m.get("name")
                if name == "health.alert":
                    saw_series = True
                    if float(m["value"]):
                        cls = (m.get("tags") or {}).get("class", "?")
                        firing.append(cls)
                elif name == "health.divergence.alert":
                    saw_series = True
                    if float(m["value"]):
                        firing.append("divergence")
                elif name in ("health.loss", "health.grad_norm"):
                    saw_series = True
        if not saw_series:
            return None
        if firing:
            return "health ALERT(" + ", ".join(sorted(set(firing))) + ")"
        return "health OK"

    @staticmethod
    def _goodput_part(views) -> Optional[str]:
        """One digest token for the goodput ledger (obs/goodput.py):
        the fleet's worst productive fraction (the fleet is only as
        good as its least-productive rank) plus that rank's dominant
        non-productive class — absent on jobs that never armed the
        ledger."""
        worst = None
        worst_view = None
        for view in views.values():
            for m in view.metrics.values():
                if m.get("name") == "goodput.fraction":
                    v = float(m["value"])
                    if worst is None or v < worst:
                        worst, worst_view = v, view
        if worst is None:
            return None
        token = f"goodput {worst:.0%}"
        if worst_view is not None:
            sinks = {
                (m.get("tags") or {}).get("class", "?"): float(m["value"])
                for m in worst_view.metrics.values()
                if m.get("name") == "goodput.secs"
                and (m.get("tags") or {}).get("class") != "productive_step"
            }
            if sinks and max(sinks.values()) > 0:
                top = max(sinks, key=lambda c: sinks[c])
                token += f" (top sink {top} {sinks[top]:.3g}s)"
        return token

    @staticmethod
    def _frontdoor_part() -> Optional[str]:
        """One digest token for the sharded front door (``frontdoor
        2/2 up``, ``1/2 up 1 takeover`` after a kill): frontend count,
        how many are alive, and the takeover total.  The FrontDoor runs
        in the launcher process — its gauges live in the LAUNCHER-local
        registry, not the rank views every other part merges — so this
        part reads :func:`~..obs.registry.get_registry` directly.
        Absent on training jobs and single-pump serving jobs that never
        published ``serve.frontend.count``."""
        from .registry import get_registry  # noqa: PLC0415

        count = alive = takeovers = None
        for m in get_registry().snapshot():
            name = m.get("name")
            if name == "serve.frontend.count":
                count = int(float(m["value"]))
            elif name == "serve.frontend.alive":
                alive = int(float(m["value"]))
            elif name == "serve.frontend.takeovers":
                takeovers = int(float(m["value"]))
        if count is None:
            return None
        token = f"frontdoor {alive if alive is not None else count}" \
                f"/{count} up"
        if takeovers:
            token += (f" {takeovers} takeover"
                      + ("s" if takeovers != 1 else ""))
        return token

    def _autoscale_part(self, views) -> Optional[str]:
        """One digest token for the autoscale/hot-swap plane (``world
        4→6 v=12``): current serving-world size (arrowed across rounds
        when it changed — a resize mid-flight reads as a transition)
        and the weight version every rank reports.  Absent on jobs that
        never set ``serve.world_size``, so training jobs and pre-swap
        fleets stay quiet.  Formatting is shared with the
        ``--stats-summary`` section (serve/autoscale.py world_token —
        one source)."""
        world = version = None
        world_seen = version_seen = -1.0
        for view in views.values():
            for m in view.metrics.values():
                name = m.get("name")
                # Both gauges are fleet-global values every CURRENT
                # member republishes each round, so the freshest view
                # wins — a released rank's final (stale) snapshot must
                # not keep reporting the pre-shrink world forever.
                if name == "serve.world_size" \
                        and view.seen_mono > world_seen:
                    world, world_seen = int(float(m["value"])), \
                        view.seen_mono
                elif name == "serve.weight_version" \
                        and view.seen_mono > version_seen:
                    version, version_seen = int(float(m["value"])), \
                        view.seen_mono
        if world is None:
            return None
        # Imported here, not at module top: only serving jobs reach
        # this branch, and their launcher already imported the serve
        # package (ingest pump) — a training job's launcher never pays
        # for it.
        from ..serve.autoscale import world_token  # noqa: PLC0415

        token = world_token(self._serve_world_prev, world, version)
        self._serve_world_prev = world
        return token

    @staticmethod
    def _perf_part(views) -> Optional[str]:
        """One digest token for the MFU profiler (obs/profile.py):
        where the FLOPs are going, live — absent on jobs that never
        armed a profiler.  Min across ranks (the fleet is only as fast
        as its slowest chip), tilde-marked when the device peak is an
        estimate (CPU dev mode): an estimated MFU must never read like
        a measured one."""
        mfu = None
        estimate = False
        step_ms = None
        for view in views.values():
            for m in view.metrics.values():
                name = m.get("name")
                if name == "perf.mfu":
                    v = float(m["value"])
                    mfu = v if mfu is None else min(mfu, v)
                elif name == "perf.mfu_estimate" and float(m["value"]):
                    estimate = True
                elif name == "perf.step_ms":
                    v = float(m["value"])
                    step_ms = v if step_ms is None else max(step_ms, v)
        if mfu is None:
            return None
        token = f"mfu {'~' if estimate else ''}{mfu:.2f}"
        if estimate:
            token += " (est)"
        if step_ms is not None:
            token += f" step {step_ms:.0f}ms"
        return token

    @staticmethod
    def _mem_part(views) -> Optional[str]:
        """One digest token for the memory plane (obs/memplane.py):
        ``mem 11.2/16.0G kv 38% waste 62%`` — device bytes in use over
        the limit (worst rank: the fleet OOMs at its fullest chip),
        falling back to the census live-bytes total when the backend
        reports no HBM (CPU dev mode, suffix ``live``), plus KV-cache
        utilization/waste when the serving plane published occupancy.
        Absent on jobs that never armed the census."""
        in_use = limit = live = None
        kv_alloc = kv_live = waste = None
        for view in views.values():
            for m in view.metrics.values():
                name = m.get("name")
                if name == "mem.hbm_bytes_in_use":
                    v = float(m["value"])
                    in_use = v if in_use is None else max(in_use, v)
                elif name == "mem.hbm_limit_bytes":
                    v = float(m["value"])
                    limit = v if limit is None else max(limit, v)
                elif name == "mem.live_bytes":
                    v = float(m["value"])
                    live = v if live is None else max(live, v)
                elif name == "serve.kv.allocated_bytes":
                    v = float(m["value"])
                    kv_alloc = v if kv_alloc is None else max(kv_alloc, v)
                elif name == "serve.kv.live_bytes":
                    v = float(m["value"])
                    kv_live = v if kv_live is None else max(kv_live, v)
                elif name == "serve.kv.waste_ratio":
                    v = float(m["value"])
                    waste = v if waste is None else max(waste, v)
        if in_use is None and live is None and waste is None:
            return None
        gib = 2.0 ** 30
        bits = []
        if in_use is not None and limit:
            bits.append(f"mem {in_use / gib:.1f}/{limit / gib:.1f}G")
        elif in_use is not None:
            bits.append(f"mem {in_use / gib:.1f}G")
        elif live is not None:
            bits.append(f"mem {live / gib:.2f}G live")
        if kv_alloc:
            util = (kv_live or 0.0) / kv_alloc
            bits.append(f"kv {util:.0%} waste {waste or 0.0:.0%}")
        elif waste is not None:
            bits.append(f"kv waste {waste:.0%}")
        return " ".join(bits) if bits else None

    # ---------------------------------------------------------- history

    def history_row(self, expected_ranks: Optional[int] = None) -> dict:
        with self._lock:
            views = self.merged()
            row = {
                "t": time.time(),
                "round": self.rounds,
                "ranks_reporting": len(views),
                "ranks_expected": expected_ranks,
                "progress": {str(r): v.progress for r, v in views.items()},
                "phases": {str(r): v.phase for r, v in views.items()},
                "epochs": {str(r): v.epoch for r, v in views.items()},
                "straggler": self.straggler(),
            }
            # SLO burn-rate plane (obs/slo.py): windows currently over
            # threshold + cumulative rising edges, so the history file
            # answers "when did the alert fire" after the job is gone.
            firing = 0
            alerts = 0.0
            saw_slo = False
            for view in views.values():
                for m in view.metrics.values():
                    name = m.get("name")
                    if name == "serve.slo.alert":
                        saw_slo = True
                        firing += 1 if float(m["value"]) else 0
                    elif name == "serve.slo.alerts":
                        saw_slo = True
                        alerts += float(m["value"])
            if saw_slo:
                row["slo"] = {"firing": firing, "alerts": int(alerts)}
            # Training-health plane (obs/health.py): anomaly classes
            # currently firing + cumulative rising edges + divergence
            # checks, so the history file answers "when did the loss
            # spike / which step diverged" after the job is gone.
            h_firing = 0
            h_alerts = 0.0
            div_detected = 0.0
            saw_health = False
            for view in views.values():
                for m in view.metrics.values():
                    name = m.get("name")
                    if name in ("health.alert", "health.divergence.alert"):
                        saw_health = True
                        h_firing += 1 if float(m["value"]) else 0
                    elif name == "health.alerts":
                        saw_health = True
                        h_alerts += float(m["value"])
                    elif name == "health.divergence.detected":
                        saw_health = True
                        div_detected += float(m["value"])
            if saw_health:
                row["health"] = {"firing": h_firing,
                                 "alerts": int(h_alerts),
                                 "divergences": int(div_detected)}
            return row

    # ------------------------------------------------------- prometheus

    def prometheus(self) -> str:
        """Text exposition (format 0.0.4) of every incarnation's view,
        labelled ``rank``/``epoch`` plus the instrument's own tags.
        Histograms render as summaries (quantile label + _sum/_count).
        An instrument tag that collides with a reserved exposition
        label (``rank``, ``epoch``, ``quantile`` — e.g. the blamed-rank
        tag on ``engine.straggler.last_arrivals``) is emitted as
        ``tag_<name>``: duplicate label names are a hard parse error
        for real scrapers."""
        with self._lock:
            incarnations = self.incarnations()
            by_name: Dict[str, List[Tuple[dict, _RankView]]] = {}
            for view in incarnations:
                for m in view.metrics.values():
                    by_name.setdefault(m["name"], []).append((m, view))
            merged = self.merged()
            strag = self.straggler()
        lines: List[str] = []
        _RESERVED = ("rank", "epoch", "quantile")

        def labels(view: _RankView, tags: dict, extra: str = "") -> str:
            items = [f'rank="{view.rank}"', f'epoch="{view.epoch}"']
            for k, v in sorted(tags.items()):
                key = _prom_name(k)[len("hvdtpu_"):]
                if key in _RESERVED:
                    key = "tag_" + key
                items.append(f'{key}="{prometheus_escape(v)}"')
            if extra:
                items.append(extra)
            return "{" + ",".join(items) + "}"

        def num(v) -> str:
            if v is None:
                return "NaN"
            return repr(float(v))

        for name in sorted(by_name):
            entries = by_name[name]
            kind = entries[0][0]["type"]
            prom = _prom_name(name)
            # HELP before TYPE before samples, once per family: real
            # scrapers warn on bare samples, and a second HELP/TYPE for
            # the same name is a hard parse error.
            lines.append(f"# HELP {prom} " + _prom_help(name, kind))
            lines.append(
                f"# TYPE {prom} "
                + {"counter": "counter", "gauge": "gauge",
                   "histogram": "summary"}[kind]
            )
            for m, view in entries:
                tags = m.get("tags") or {}
                if kind == "histogram":
                    for q, field in (("0.5", "p50"), ("0.9", "p90"),
                                     ("0.99", "p99")):
                        lines.append(
                            prom + labels(view, tags, f'quantile="{q}"')
                            + " " + num(m.get(field))
                        )
                    lines.append(
                        f"{prom}_sum" + labels(view, tags)
                        + " " + num(m.get("sum", 0.0))
                    )
                    lines.append(
                        f"{prom}_count" + labels(view, tags)
                        + " " + str(int(m.get("count") or 0))
                    )
                else:
                    lines.append(
                        prom + labels(view, tags) + " " + num(m["value"])
                    )
        # Aggregator-level meta series: scrapers get liveness and the
        # straggler verdict without re-deriving them from raw counters.
        lines.append("# HELP hvdtpu_live_ranks_reporting Ranks whose "
                     "live stream has reported at least once")
        lines.append("# TYPE hvdtpu_live_ranks_reporting gauge")
        lines.append(f"hvdtpu_live_ranks_reporting {len(merged)}")
        lines.append("# HELP hvdtpu_live_straggler_rank Rank the "
                     "shared straggler attribution currently blames "
                     "(-1 = none)")
        lines.append("# TYPE hvdtpu_live_straggler_rank gauge")
        lines.append(
            "hvdtpu_live_straggler_rank "
            + (str(strag["rank"]) if strag else "-1")
        )
        now = time.monotonic()
        lines.append("# HELP hvdtpu_live_update_age_seconds Seconds "
                     "since each rank's newest incarnation last "
                     "streamed a snapshot")
        lines.append("# TYPE hvdtpu_live_update_age_seconds gauge")
        for rank, view in merged.items():
            lines.append(
                f'hvdtpu_live_update_age_seconds{{rank="{rank}"}} '
                + repr(round(now - view.seen_mono, 3))
            )
        return "\n".join(lines) + "\n"


class LivePlane:
    """The launcher's live-telemetry owner: owns the aggregator thread,
    consumes snapshot keys from the KV server, appends history, prints
    the digest, and serves ``/metrics``.

    ``server`` must be the in-process :class:`KVStoreServer` (the
    aggregator reads and prunes its store directly — zero HTTP overhead
    and listing for free, which the HTTP surface deliberately lacks)."""

    def __init__(
        self,
        server,
        *,
        interval: float,
        history_path: Optional[str] = None,
        expected_ranks: Optional[int] = None,
        print_digest: bool = True,
        announce_host: Optional[str] = None,
    ):
        self.server = server
        self.interval = max(float(interval), 0.05)
        self.history_path = history_path
        self.expected_ranks = expected_ranks
        self.print_digest = print_digest
        # The host scrapers should dial — the launcher's ROUTABLE
        # address for multi-host jobs (the announced line is the only
        # discoverable endpoint; 127.0.0.1 would be a lie off-box).
        self.announce_host = announce_host or "127.0.0.1"
        self.agg = LiveAggregator()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Launcher-local series appended to the exposition (e.g. the
        # autoscale controller's gauges — worker snapshots never carry
        # them).  Each callable returns complete exposition lines.
        self._extra_renders: List = []

    def add_render(self, fn) -> None:
        """Append a launcher-side exposition source to ``/metrics``."""
        self._extra_renders.append(fn)

    def _render(self) -> str:
        body = self.agg.prometheus()
        for fn in self._extra_renders:
            try:
                body += fn()
            except Exception as exc:  # pragma: no cover - defensive
                LOG.warning("extra /metrics render failed: %s", exc)
        return body

    def start(self) -> None:
        self.server.set_metrics_render(self._render)
        self._thread = threading.Thread(
            target=self._loop, name="hvdtpu_live_agg", daemon=True
        )
        self._thread.start()
        print(
            f"[live] scrape endpoint "
            f"http://{self.announce_host}:{self.server.port}/metrics "
            f"(every {self.interval:g}s"
            + (f", history -> {self.history_path}" if self.history_path
               else "") + ")",
            flush=True,
        )

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.round()
            except Exception as exc:  # pragma: no cover - defensive
                LOG.warning("live aggregation round failed: %s", exc)

    def round(self) -> int:
        """One aggregation round: consume every pending snapshot key (in
        (epoch, rank, seq) order), append history, print the digest.
        Returns the number of documents ingested."""
        pending = self.server.scan(obs_stream.LIVE_SCOPE + "/")
        docs: List[Tuple[Tuple[int, int, int], str, dict]] = []
        for key, raw in pending.items():
            tail = key[len(obs_stream.LIVE_SCOPE) + 1:].split("/")
            try:
                epoch, rank, seq = (int(t) for t in tail)
                doc = json.loads(raw.decode())
            except (ValueError, UnicodeDecodeError):
                self.server.discard([key])  # junk key: drop, don't wedge
                continue
            docs.append(((epoch, rank, seq), key, doc))
        docs.sort(key=lambda item: item[0])
        for _, key, doc in docs:
            try:
                self.agg.ingest(doc)
            except Exception as exc:
                # JSON-valid but schema-invalid (a version-skewed
                # worker): log and fall through to the discard — a
                # poison doc must cost one warning, never wedge every
                # subsequent round on the same key.
                LOG.warning("unparseable live snapshot %s: %s", key, exc)
            self.server.discard([key])
        self.agg.rounds += 1
        if self.agg.merged():
            self._append_history()
            if self.print_digest:
                print("[live] " + self.agg.digest(self.expected_ranks),
                      flush=True)
        return len(docs)

    def _append_history(self) -> None:
        if not self.history_path:
            return
        row = self.agg.history_row(self.expected_ranks)
        try:
            d = os.path.dirname(self.history_path)
            if d:
                os.makedirs(d, exist_ok=True)
            # Append + flush per round: every completed round survives a
            # launcher kill; a torn final line is the reader's problem
            # (one json.loads failure), never the writer's.
            with open(self.history_path, "a") as f:
                f.write(json.dumps(row, separators=(",", ":")) + "\n")
                f.flush()
        except OSError as exc:  # pragma: no cover - disk full etc.
            LOG.warning("live history append failed: %s", exc)

    def stop(self) -> None:
        """Final round (drain what workers flushed at exit), then stop."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(2.0, self.interval * 2))
            self._thread = None
        try:
            self.round()
        except Exception:  # pragma: no cover - defensive
            pass
        self.server.set_metrics_render(None)
