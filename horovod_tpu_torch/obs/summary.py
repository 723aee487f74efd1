"""End-of-job aggregation of per-rank metrics dumps.

The launcher's ``--stats-summary`` flag reads every
``HVDTPU_METRICS_DUMP`` file the job's ranks wrote (obs/registry.py dump
schema) and renders one table — metrics as rows, ranks as columns — so
cross-rank skew (one rank's cycle p99, one rank's cache hit rate) is
visible without grepping per-rank logs.

A copy of the reference's ``horovod_tpu/obs/summary.py``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

from . import pathspec

__all__ = [
    "collect_dumps",
    "format_summary_table",
    "straggler_section",
    "fabric_section",
    "autoscale_section",
    "perf_section",
    "mem_section",
    "goodput_section",
    "slo_section",
    "health_section",
    "summarize",
]


def _dump_glob(raw: str) -> str:
    return pathspec.glob_pattern(raw, "metrics")


class DumpSet(Dict[str, dict]):
    """collect_dumps result: a plain ``{label -> dump doc}`` mapping
    plus ``.warnings`` — one line per dump that was found on disk but
    skipped (truncated mid-write, corrupt JSON, wrong schema).  A
    half-written dump must not sink the summary, but it must not
    vanish silently either: a missing column that LOOKS like "rank
    never dumped" when the file is sitting right there is exactly the
    kind of misdirection a post-mortem can't afford."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.warnings: List[str] = []


def collect_dumps(raw: str) -> DumpSet:
    """Read every per-rank dump derived from the ``HVDTPU_METRICS_DUMP``
    value; returns {column label -> dump document}.  Elastic epoch tags
    become part of the label so incarnations stay distinguishable.
    Unreadable/corrupt dumps are skipped but named in ``.warnings`` so
    the table header can say which columns are missing and why."""
    out = DumpSet()
    for path in sorted(glob.glob(_dump_glob(raw))):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as exc:
            out.warnings.append(
                f"skipped corrupt metrics dump {os.path.basename(path)}"
                f" ({type(exc).__name__}: truncated or unreadable)"
            )
            continue
        if not isinstance(doc, dict) or "metrics" not in doc:
            out.warnings.append(
                f"skipped metrics dump {os.path.basename(path)} "
                f"(valid JSON but not a metrics dump document)"
            )
            continue
        label = str(doc.get("rank", "?"))
        epoch = pathspec.epoch_of_path(path)
        if epoch:
            label = f"{label}@e{epoch}"
        out[label] = doc
    return out


def _cell(metric: dict) -> str:
    if metric["type"] in ("counter", "gauge"):
        v = metric["value"]
        if isinstance(v, float) and not v.is_integer():
            return f"{v:.3g}"
        return str(int(v))
    # histogram: the three numbers that matter at a glance
    if not metric["count"]:
        return "-"
    return (f"n={metric['count']} p50={metric['p50']:.3g} "
            f"p99={metric['p99']:.3g}")


def _metric_label(metric: dict) -> str:
    tags = metric.get("tags") or {}
    if not tags:
        return metric["name"]
    tag_s = ",".join(f"{k}={v}" for k, v in sorted(tags.items()))
    return f"{metric['name']}{{{tag_s}}}"


def format_summary_table(dumps: Dict[str, dict]) -> str:
    """Metrics as rows, ranks as columns, plain monospace table.
    collect_dumps warnings (corrupt/truncated dumps that were skipped)
    lead the header so a missing column reads as "dump was corrupt",
    never as "rank never dumped"."""
    warn_lines = [
        f"WARNING: {w}" for w in getattr(dumps, "warnings", [])
    ]
    if not dumps:
        return "\n".join(warn_lines + ["(no metrics dumps found)"])

    columns = sorted(dumps, key=_rank_sort_key)
    rows: Dict[str, Dict[str, str]] = {}
    for label in columns:
        for metric in dumps[label].get("metrics", []):
            rows.setdefault(_metric_label(metric), {})[label] = _cell(metric)

    name_w = max([len(r) for r in rows] + [len("metric")])
    col_w = {
        c: max([len(rows[r].get(c, "-")) for r in rows]
               + [len(f"rank {c}")])
        for c in columns
    }
    header = "metric".ljust(name_w) + "".join(
        f"  {f'rank {c}':>{col_w[c]}}" for c in columns
    )
    sep = "-" * len(header)
    lines = warn_lines + [header, sep]
    for r in sorted(rows):
        lines.append(
            r.ljust(name_w)
            + "".join(f"  {rows[r].get(c, '-'):>{col_w[c]}}" for c in columns)
        )
    return "\n".join(lines)


def straggler_section(dumps: Dict[str, dict]) -> Optional[str]:
    """The end-of-job straggler verdict: per-rank last-arrival counts
    (with shares), the skew distribution, and a one-line conclusion
    naming the lagging rank.  None when no rank recorded attribution
    (healthy jobs blame nobody).  The merge semantics are the live
    digest's — one shared implementation, obs/straggler.py
    merge_blames, so the two can never name different stragglers."""
    from . import straggler as obs_straggler  # noqa: PLC0415

    verdict = obs_straggler.merge_blames(
        [doc.get("metrics", []) for doc in dumps.values()]
    )
    if verdict is None:
        return None
    blames = verdict["blames"]
    skew = verdict["skew"]
    total = sum(blames.values())
    lines = []
    for rank in sorted(blames, key=lambda r: (-blames[r], r)):
        share = blames[rank] / total if total else 0.0
        mark = "  <- likely straggler" if rank == verdict["rank"] else ""
        lines.append(
            f"rank {rank}: last to arrive in {blames[rank]} "
            f"collectives ({share:.0%}){mark}"
        )
    if skew["count"]:
        lines.append(
            f"arrival skew: n={skew['count']} p50={skew['p50']:.3g}ms "
            f"p99={skew['p99']:.3g}ms max={skew['max']:.3g}ms"
        )
    if verdict["alerts"]:
        lines.append(f"alerts past --alert-skew-ms: {verdict['alerts']}")
    if "slice" in verdict:
        lines.append(
            f"slice {verdict['slice']} is the straggler "
            f"({verdict['slice_share']:.0%} of blame; per-slice "
            + " ".join(
                f"{s}={c}"
                for s, c in sorted(verdict["slice_blames"].items())
            )
            + ")"
        )
    return "\n".join(lines)


def fabric_section(dumps: Dict[str, dict]) -> Optional[str]:
    """End-of-job two-fabric byte report (multislice jobs): per-rank
    DCN vs ICI bytes the data plane moved and the DCN wire compression
    factor.  None when no rank touched the fabric counters — single-
    slice jobs see no new output."""
    rows = []
    for label in sorted(dumps, key=_rank_sort_key):
        dcn = ici = 0.0
        ratio = None
        for m in dumps[label].get("metrics", []):
            name = m.get("name")
            if name == "engine.dcn_bytes":
                dcn = float(m["value"])
            elif name == "engine.ici_bytes":
                ici = float(m["value"])
            elif name == "engine.dcn_compression_ratio":
                ratio = float(m["value"])
        if not dcn and not ici:
            continue
        row = (
            f"rank {label}: dcn {dcn:.3g} B, ici {ici:.3g} B"
            + (f", dcn/ici {dcn / ici:.3f}" if ici else "")
        )
        if ratio and ratio > 1.0:
            row += f", dcn wire compressed x{ratio:.1f}"
        rows.append(row)
    return "\n".join(rows) if rows else None


def ckpt_section(dumps: Dict[str, dict]) -> Optional[str]:
    """End-of-job checkpoint/recovery verdict: per-rank restore
    provenance (peer / disk / none), shard and replica-push volume,
    and the restore-time distribution.  None when no rank touched the
    checkpoint tier — jobs without it see no new output."""
    rows = []
    restore_ms = []
    for label in sorted(dumps, key=_rank_sort_key):
        metrics = dumps[label].get("metrics", [])
        sources = {}
        pushes = dropped = 0
        shard_bytes = 0.0
        for m in metrics:
            name = m.get("name")
            if name == "ckpt.restore_source":
                src = (m.get("tags") or {}).get("source", "?")
                sources[src] = sources.get(src, 0) + int(m["value"])
            elif name == "ckpt.replica_pushes":
                pushes += int(m["value"])
            elif name == "ckpt.replica_dropped":
                dropped += int(m["value"])
            elif name == "ckpt.shard_bytes" and m.get("count"):
                shard_bytes += float(m.get("sum") or 0.0)
            elif name == "ckpt.restore_ms" and m.get("count"):
                restore_ms.append(m)
        if not sources and not pushes and not shard_bytes:
            continue
        src_s = (" ".join(f"{k}={v}" for k, v in sorted(sources.items()))
                 or "-")
        row = (f"rank {label}: restores {src_s}, replica pushes {pushes}"
               + (f" (dropped {dropped})" if dropped else ""))
        if shard_bytes:
            row += f", shard bytes {shard_bytes:.3g}"
        rows.append(row)
    if not rows:
        return None
    if restore_ms:
        n = sum(m["count"] for m in restore_ms)
        worst = max(m["max"] for m in restore_ms)
        p50s = [m["p50"] for m in restore_ms if m.get("p50") is not None]
        rows.append(
            f"restore time: n={n} p50~{(sum(p50s) / len(p50s)):.3g}ms "
            f"max={worst:.3g}ms" if p50s else f"restore time: n={n}"
        )
    return "\n".join(rows)


def serve_section(dumps: Dict[str, dict]) -> Optional[str]:
    """End-of-job serving-plane report: per-rank admission/eviction
    traffic, replay count, and the latency distributions the SLO
    conversation needs (ttft/tpot percentiles, tokens/sec).  None when
    no rank served — training jobs see no new output."""
    rows = []
    for label in sorted(dumps, key=_rank_sort_key):
        vals = {}
        hists = {}
        tenants: Dict[str, Dict[str, float]] = {}
        for m in dumps[label].get("metrics", []):
            name = m.get("name")
            if name in ("serve.admitted", "serve.evicted",
                        "serve.rejected", "serve.replayed",
                        "serve.steps", "serve.tokens_per_sec",
                        "serve.admitted_while_busy", "serve.frontends",
                        "serve.kv.waste_ratio", "serve.kv.page_size",
                        "serve.kv.page_free", "serve.kv.page_used"):
                vals[name] = float(m["value"])
            elif name in ("serve.tenant.throttled",
                          "serve.tenant.admitted_tokens"):
                t = (m.get("tags") or {}).get("tenant", "?")
                short = ("throttled" if name.endswith("throttled")
                         else "tokens")
                bucket = tenants.setdefault(t, {})
                bucket[short] = bucket.get(short, 0.0) + float(m["value"])
            elif name in ("serve.ttft_ms", "serve.tpot_ms") \
                    and m.get("count"):
                hists[name] = m
        if not vals and not hists:
            continue
        row = (
            f"rank {label}: admitted {int(vals.get('serve.admitted', 0))}"
            f" (mid-decode "
            f"{int(vals.get('serve.admitted_while_busy', 0))})"
            f", evicted {int(vals.get('serve.evicted', 0))}"
            f", rejected {int(vals.get('serve.rejected', 0))}"
        )
        if vals.get("serve.replayed"):
            row += f", replayed {int(vals['serve.replayed'])}"
        if vals.get("serve.frontends", 0) > 1:
            # Sharded front door: only worth a word when the
            # log actually had more than one producer.
            row += f", frontends {int(vals['serve.frontends'])}"
        if vals.get("serve.steps"):
            row += f", steps {int(vals['serve.steps'])}"
        if vals.get("serve.tokens_per_sec"):
            row += f", {vals['serve.tokens_per_sec']:.1f} tok/s"
        for name, short in (("serve.ttft_ms", "ttft"),
                            ("serve.tpot_ms", "tpot")):
            m = hists.get(name)
            if m is not None:
                row += (
                    f", {short} p50 {m.get('p50') or 0:.3g}ms "
                    f"p99 {m.get('p99') or 0:.3g}ms"
                )
        if "serve.kv.page_size" in vals:
            # Paged-pool line (absent on contiguous pools): what the
            # admission gate saw at the final snapshot.
            row += (
                f", kv pages {int(vals.get('serve.kv.page_used', 0))}"
                f"u/{int(vals.get('serve.kv.page_free', 0))}f"
                f" x{int(vals['serve.kv.page_size'])}rows"
            )
            if "serve.kv.waste_ratio" in vals:
                row += (
                    f" waste {vals['serve.kv.waste_ratio']:.2f}"
                )
        rows.append(row)
        if tenants:
            # Tenant-QoS sub-row: who got throttled and how
            # many decode tokens each tenant was admitted — the
            # "one tenant is starving the others" runbook starts here.
            bits = []
            for t in sorted(tenants):
                b = tenants[t]
                bits.append(
                    f"{t} tok={int(b.get('tokens', 0))}"
                    f" throttled={int(b.get('throttled', 0))}"
                )
            rows.append(f"rank {label} tenants: " + ", ".join(bits))
    return "\n".join(rows) if rows else None


def goodput_section(dumps: Dict[str, dict]) -> Optional[str]:
    """End-of-job goodput ledger verdict (obs/goodput.py gauges):
    per-rank productive fraction with the wall-clock class breakdown
    (init/compile/productive/collective_wait/checkpoint/recovery/...)
    and, when any time was lost to elastic events, the per-cause
    attribution (rendezvous / respawn / stall).  Serving ranks add the
    token-goodput line.  None when no rank armed the ledger."""
    rows = []
    for label in sorted(dumps, key=_rank_sort_key):
        frac = None
        secs: Dict[str, float] = {}
        lost: Dict[str, float] = {}
        tok_frac = tok_rate = None
        for m in dumps[label].get("metrics", []):
            name = m.get("name")
            if name == "goodput.fraction":
                frac = float(m["value"])
            elif name == "goodput.secs":
                cls = (m.get("tags") or {}).get("class", "?")
                secs[cls] = float(m["value"])
            elif name == "goodput.lost_secs":
                cause = (m.get("tags") or {}).get("cause", "?")
                lost[cause] = float(m["value"])
            elif name == "serve.goodput.token_fraction":
                tok_frac = float(m["value"])
            elif name == "serve.goodput.tokens_per_slot_sec":
                tok_rate = float(m["value"])
        if frac is None and tok_frac is None:
            continue
        bits = []
        if frac is not None:
            bits.append(f"goodput {frac:.1%}")
            breakdown = " ".join(
                f"{cls}={secs[cls]:.3g}s"
                for cls in sorted(secs, key=lambda c: -secs[c])
                if secs[cls]
            )
            if breakdown:
                bits.append(breakdown)
            if any(lost.values()):
                bits.append("lost " + " ".join(
                    f"{cause}={lost[cause]:.3g}s"
                    for cause in sorted(lost, key=lambda c: -lost[c])
                    if lost[cause]
                ))
        if tok_frac is not None:
            tok = f"token goodput {tok_frac:.1%} of slot capacity"
            if tok_rate is not None:
                tok += f" ({tok_rate:.3g} tok/slot-s)"
            bits.append(tok)
        rows.append(f"rank {label}: " + ", ".join(bits))
    return "\n".join(rows) if rows else None


def slo_section(dumps: Dict[str, dict]) -> Optional[str]:
    """End-of-job SLO burn-rate verdict (obs/slo.py gauges): per
    (tenant, slo class, metric) series the latency digest, breach
    count, fast/slow-window burn rates, and whether an alert ever fired
    — the number the capacity conversation actually needs.  None when
    no rank digested SLO traffic."""
    # (tenant, slo, metric) -> merged view across ranks: digests are
    # per-rank so we show the worst rank's percentiles, and sum the
    # breach/alert counters (they are disjoint per rank).
    series: Dict[tuple, Dict[str, float]] = {}
    for label in sorted(dumps, key=_rank_sort_key):
        for m in dumps[label].get("metrics", []):
            name = m.get("name")
            if not name or not name.startswith("serve.slo."):
                continue
            tags = m.get("tags") or {}
            key = (tags.get("tenant", "?"), tags.get("slo", "?"),
                   tags.get("metric", "?"))
            bucket = series.setdefault(key, {})
            short = name[len("serve.slo."):]
            if short in ("p50_ms", "p99_ms"):
                bucket[short] = max(bucket.get(short, 0.0),
                                    float(m["value"]))
            elif short == "burn":
                win = tags.get("window", "?")
                bucket[f"burn_{win}"] = max(
                    bucket.get(f"burn_{win}", 0.0), float(m["value"]))
            elif short in ("breaches", "alerts"):
                bucket[short] = bucket.get(short, 0.0) + float(m["value"])
    if not series:
        return None
    rows = []
    for (tenant, slo, metric) in sorted(series):
        b = series[(tenant, slo, metric)]
        row = (f"{tenant}/{slo} {metric}: "
               f"p50 {b.get('p50_ms', 0):.3g}ms "
               f"p99 {b.get('p99_ms', 0):.3g}ms")
        if b.get("breaches"):
            row += f", breaches {int(b['breaches'])}"
        if "burn_fast" in b or "burn_slow" in b:
            row += (f", burn fast {b.get('burn_fast', 0.0):.2f}x"
                    f" slow {b.get('burn_slow', 0.0):.2f}x")
        if b.get("alerts"):
            row += (f", ALERTS FIRED {int(b['alerts'])}"
                    f" (see docs/troubleshooting.md burn-rate runbook)")
        rows.append(row)
    return "\n".join(rows)


def health_section(dumps: Dict[str, dict]) -> Optional[str]:
    """End-of-job training-health verdict (obs/health.py +
    obs/divergence.py gauges): anomaly alerts by class, the worst
    grad-norm z-score any rank saw, nonfinite counts, and the
    divergence sentinel's record — checks passed, last check step, and
    any confirmed divergence with its component/leaf.  None when no
    rank armed ``--health``."""
    alerts: Dict[str, float] = {}
    worst_z = None
    nonfinite = 0.0
    checks = 0.0
    last_check = None
    detected: Dict[str, float] = {}
    saw = False
    for label in sorted(dumps, key=_rank_sort_key):
        for m in dumps[label].get("metrics", []):
            name = m.get("name")
            if not name or not name.startswith("health."):
                continue
            saw = True
            tags = m.get("tags") or {}
            if "value" not in m:
                continue  # histograms carry quantiles, not a value
            value = float(m["value"])
            if name == "health.alerts":
                cls = tags.get("class", "?")
                alerts[cls] = alerts.get(cls, 0.0) + value
            elif name == "health.grad_norm_z":
                worst_z = value if worst_z is None else max(worst_z,
                                                            value)
            elif name == "health.nonfinite_total":
                nonfinite += value
            elif name == "health.divergence.checks":
                checks = max(checks, value)
            elif name == "health.divergence.last_check_step":
                last_check = (value if last_check is None
                              else max(last_check, value))
            elif name == "health.divergence.detected":
                where = tags.get("component", "?")
                if tags.get("leaf"):
                    where += f"/{tags['leaf']}"
                detected[where] = detected.get(where, 0.0) + value
    if not saw:
        return None
    rows = []
    fired = {c: int(n) for c, n in sorted(alerts.items()) if n}
    if fired:
        rows.append("alerts: " + ", ".join(
            f"{c} x{n}" for c, n in fired.items()))
    else:
        rows.append("alerts: none")
    if worst_z is not None:
        rows.append(f"worst grad-norm z-score: {worst_z:.2f}")
    if nonfinite:
        rows.append(f"nonfinite gradient elements: {int(nonfinite)}")
    div = f"divergence checks: {int(checks)}"
    if last_check is not None:
        div += f" (last at step {int(last_check)})"
    rows.append(div)
    for where, n in sorted(detected.items()):
        rows.append(
            f"DIVERGENCE DETECTED x{int(n)} in {where} "
            f"(see docs/health.md runbook)"
        )
    return "\n".join(rows)


def autoscale_section(dumps: Dict[str, dict]) -> Optional[str]:
    """End-of-job autoscale / weight hot-swap report: the world/version
    the fleet converged on (every rank must agree — a disagreement here
    is a single-version-guarantee violation worth reading twice), swap
    outcomes per rank, and the launcher's resize decisions/backoffs.
    None when the job neither autoscaled nor armed hot-swap."""
    from ..serve.autoscale import world_token  # noqa: PLC0415

    worlds: Dict[str, int] = {}
    versions: Dict[str, int] = {}
    released_labels = set()
    swap_rows = []
    launcher_bits = []
    for label in sorted(dumps, key=_rank_sort_key):
        vals: Dict[str, float] = {}
        swaps: Dict[str, int] = {}
        for m in dumps[label].get("metrics", []):
            name = m.get("name")
            if name in ("serve.world_size", "serve.weight_version",
                        "serve.released", "serve.log_watermark",
                        "serve.swap_prefetch_failures",
                        "autoscale.world", "autoscale.backoffs"):
                vals[name] = float(m["value"])
            elif name == "serve.swaps":
                outcome = (m.get("tags") or {}).get("outcome", "?")
                swaps[outcome] = swaps.get(outcome, 0) + int(m["value"])
            elif name == "autoscale.decisions":
                d = (m.get("tags") or {}).get("direction", "?")
                launcher_bits.append(f"scale-{d} {int(m['value'])}")
        if vals.get("serve.released"):
            released_labels.add(label)
        if "serve.world_size" in vals:
            worlds[label] = int(vals["serve.world_size"])
        if "serve.weight_version" in vals:
            versions[label] = int(vals["serve.weight_version"])
        if "autoscale.backoffs" in vals and vals["autoscale.backoffs"]:
            launcher_bits.append(
                f"grow-backoffs {int(vals['autoscale.backoffs'])}")
        if swaps or vals.get("serve.swap_prefetch_failures") \
                or vals.get("serve.released"):
            row = f"rank {label}: " + ", ".join(
                [f"swaps {o}={n}" for o, n in sorted(swaps.items())]
                + ([f"prefetch-failures "
                    f"{int(vals['serve.swap_prefetch_failures'])}"]
                   if vals.get("serve.swap_prefetch_failures") else [])
                + (["released"] if vals.get("serve.released") else [])
            )
            swap_rows.append(row)
    if not worlds and not versions and not launcher_bits \
            and not swap_rows:
        return None

    def _newest(per_label: Dict[str, int]) -> Dict[str, int]:
        """One value per rank: the newest incarnation's (labels are
        ``rank`` or ``rank@eN``).  A dead incarnation's stale version
        is evidence elsewhere, not a convergence violation."""
        best: Dict[str, tuple] = {}
        for label, v in per_label.items():
            base, _, etag = label.partition("@e")
            e = int(etag) if etag.isdigit() else 0
            if base not in best or e > best[base][0]:
                best[base] = (e, label, v)
        return {lbl: v for _, lbl, v in best.values()}

    lines = []
    if worlds or versions:
        # A released rank's end-of-life gauges describe the world it
        # was dropped FROM; the surviving ranks' dumps carry the final
        # truth.  Filter by BASE rank (every incarnation of a released
        # rank, not just the one whose dump carries serve.released),
        # and fall back to everything only when the whole fleet was
        # released (shrink-to-zero never happens, but dumps can be
        # partial).
        released_bases = {lbl.partition("@e")[0]
                          for lbl in released_labels}

        def _survivors(per_label: Dict[str, int]) -> Dict[str, int]:
            kept = {lbl: v for lbl, v in per_label.items()
                    if lbl.partition("@e")[0] not in released_bases}
            return kept or per_label

        newest_versions = _newest(_survivors(versions))
        # Worlds get the same newest-incarnation dedup: after a grow
        # then shrink, a survivor's stale earlier-incarnation dump
        # must not keep reporting the pre-shrink peak as "final".
        newest_worlds = _newest(_survivors(worlds))
        world = max(newest_worlds.values()) if newest_worlds else 0
        version = (max(newest_versions.values())
                   if newest_versions else None)
        lines.append("final " + world_token(None, world, version))
        stray_v = {label: v for label, v in newest_versions.items()
                   if version is not None and v != version}
        if stray_v:
            lines.append(
                "WARNING: weight-version disagreement across final "
                "incarnations (violates the single-version "
                f"guarantee): {stray_v}"
            )
    if launcher_bits:
        lines.append("launcher: " + ", ".join(sorted(set(launcher_bits))))
    lines.extend(swap_rows)
    return "\n".join(lines)


def perf_section(dumps: Dict[str, dict]) -> Optional[str]:
    """End-of-job MFU report (obs/profile.py gauges): per-rank model
    FLOP/s utilization, achieved TFLOP/s and step time — estimate-
    marked when the device peak was a guess (CPU dev mode), so a
    placeholder number can never read like a hardware claim.  None when
    no rank armed a profiler."""
    rows = []
    for label in sorted(dumps, key=_rank_sort_key):
        vals = {}
        for m in dumps[label].get("metrics", []):
            name = m.get("name")
            if name in ("perf.mfu", "perf.model_tflops", "perf.step_ms",
                        "perf.mfu_estimate"):
                vals[name] = float(m["value"])
        if "perf.mfu" not in vals:
            continue
        est = bool(vals.get("perf.mfu_estimate"))
        row = (f"rank {label}: mfu {'~' if est else ''}"
               f"{vals['perf.mfu']:.3f}"
               + (" (peak is an estimate — not a hardware claim)"
                  if est else ""))
        if vals.get("perf.model_tflops") is not None:
            row += f", {vals['perf.model_tflops']:.3g} TFLOP/s"
        if vals.get("perf.step_ms") is not None:
            row += f", step {vals['perf.step_ms']:.3g}ms"
        rows.append(row)
    return "\n".join(rows) if rows else None


def _fmt_bytes(b: float) -> str:
    """Human bytes for the memory rows (binary units, one decimal)."""
    b = float(b)
    for unit, div in (("GiB", 2.0 ** 30), ("MiB", 2.0 ** 20),
                      ("KiB", 2.0 ** 10)):
        if b >= div:
            return f"{b / div:.1f}{unit}"
    return f"{int(b)}B"


def mem_section(dumps: Dict[str, dict]) -> Optional[str]:
    """End-of-job device-memory report (obs/memplane.py gauges):
    per-rank HBM in-use/peak/limit (census live-bytes fallback on
    backends that report no stats — CPU dev mode says so instead of
    inventing an HBM), the owner breakdown (params / optimizer_state /
    kv_cache / …), KV-cache occupancy, and the per-program compiled
    breakdowns.  None when no rank armed the memory plane."""
    rows = []
    programs: Dict[str, Dict[str, float]] = {}
    for label in sorted(dumps, key=_rank_sort_key):
        vals: Dict[str, float] = {}
        owners: Dict[str, float] = {}
        for m in dumps[label].get("metrics", []):
            name = m.get("name")
            if name in ("mem.hbm_bytes_in_use", "mem.hbm_peak_bytes",
                        "mem.hbm_limit_bytes", "mem.headroom_bytes",
                        "mem.live_bytes", "serve.kv.allocated_bytes",
                        "serve.kv.live_bytes", "serve.kv.waste_ratio"):
                vals[name] = float(m["value"])
            elif name == "mem.owner_bytes":
                owner = (m.get("tags") or {}).get("owner", "?")
                owners[owner] = float(m["value"])
            elif name and name.startswith("mem.compiled."):
                prog = (m.get("tags") or {}).get("program", "?")
                programs.setdefault(prog, {})[
                    name[len("mem.compiled."):]
                ] = float(m["value"])
        if not vals and not owners:
            continue
        if "mem.hbm_bytes_in_use" in vals:
            row = f"rank {label}: hbm {_fmt_bytes(vals['mem.hbm_bytes_in_use'])}"
            if vals.get("mem.hbm_limit_bytes"):
                row += f"/{_fmt_bytes(vals['mem.hbm_limit_bytes'])}"
            if vals.get("mem.hbm_peak_bytes"):
                row += f" (peak {_fmt_bytes(vals['mem.hbm_peak_bytes'])})"
        else:
            row = (f"rank {label}: live "
                   f"{_fmt_bytes(vals.get('mem.live_bytes', 0))} "
                   f"(no backend memory stats — census only)")
        total = sum(owners.values())
        if total:
            shares = " ".join(
                f"{k}={owners[k] / total:.0%}"
                for k in sorted(owners, key=lambda k: -owners[k])
                if owners[k]
            )
            row += f", owners {shares}"
        if vals.get("serve.kv.allocated_bytes"):
            row += (
                f", kv {_fmt_bytes(vals.get('serve.kv.live_bytes', 0))}"
                f"/{_fmt_bytes(vals['serve.kv.allocated_bytes'])} live "
                f"(waste {vals.get('serve.kv.waste_ratio', 0.0):.0%})"
            )
        rows.append(row)
    if not rows:
        return None
    for prog in sorted(programs):
        b = programs[prog]
        rows.append(
            f"program {prog}: total "
            f"{_fmt_bytes(b.get('total_bytes', 0))} "
            f"(arg {_fmt_bytes(b.get('argument_bytes', 0))}, "
            f"temp {_fmt_bytes(b.get('temp_bytes', 0))}, "
            f"out {_fmt_bytes(b.get('output_bytes', 0))}, "
            f"alias {_fmt_bytes(b.get('alias_bytes', 0))})"
        )
    return "\n".join(rows)


def trend_section(dumps: Dict[str, dict]) -> Optional[str]:
    """Perf-trend verdict (obs/trend.py) over the checkout's committed
    BENCH records.  Unlike the other sections this reads the record
    directory, not the dumps: the trajectory is a property of the repo,
    and a dark streak ("N records without a real measurement") must
    reach the operator at end-of-job even when the job itself produced
    no perf gauges.  None on a fresh checkout (no records) so dev runs
    stay quiet."""
    del dumps  # same call shape as the other sections
    from . import trend as obs_trend  # noqa: PLC0415

    stamp = obs_trend.trend_stamp()
    if stamp is None:
        return None
    lines = [
        f"records {stamp['records']} "
        f"(real {stamp['real']}, degraded {stamp['degraded']}, "
        f"failed {stamp['failed']})",
    ]
    if stamp["verdict"]:
        lines.append(stamp["verdict"])
    return "\n".join(lines)


def _rank_sort_key(label: str):
    """Rank-label ordering shared by the summary table's columns and
    the ckpt section's rows: numeric ranks first (numerically, with
    ``@e<N>`` incarnation tags ignored), everything else after."""
    head = label.split("@", 1)[0]
    return (0, int(head), label) if head.isdigit() else (1, label, "")


def summarize(raw: str) -> Optional[str]:
    """Collect + format in one call; None when nothing was dumped."""
    dumps = collect_dumps(raw)
    if not dumps:
        return None
    return format_summary_table(dumps)
