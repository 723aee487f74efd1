"""Per-tenant / per-SLO-class latency objectives with burn-rate alerts
(a copy of ``horovod_tpu/obs/slo.py``: standard library only).

Requests carry a tenant and an SLO class (interactive / standard /
batch); this module says what a class *means* in milliseconds:

* **Targets** — per-class latency objectives (``ttft_ms`` /
  ``tpot_ms`` ceilings with an ``objective`` fraction, e.g. "99% of
  interactive first tokens under 500ms"), parsed from the serve spec
  (:func:`targets_from_spec`; fed by ``--slo-ttft-ms`` and friends).
* **Sliding-window digests** — per (tenant, SLO class, metric) sample
  windows with p50/p90/p99 on demand.  Bounded; old samples age out of
  the slow window.
* **Two-window error-budget burn rates** — the *fast* window (default
  60s) with a *high* threshold catches cliffs within a window or two;
  the *slow* window (default 600s) with a *low* threshold catches slow
  burns.  ``burn = observed error rate / (1 - objective)``: burn 1.0
  spends the budget exactly at the objective's rate.
* **Pure clocks** — every method takes ``now`` from the caller.
  Registry writes happen only in :meth:`SLOPlane.publish`.

Traffic whose SLO class has no configured target is digested but can
never alert: untagged traffic trips nothing by construction.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

__all__ = [
    "SLOTarget",
    "SLOPlane",
    "targets_from_spec",
    "DEFAULT_FAST_WINDOW",
    "DEFAULT_SLOW_WINDOW",
    "DEFAULT_FAST_BURN",
    "DEFAULT_SLOW_BURN",
    "DEFAULT_OBJECTIVE",
]

DEFAULT_FAST_WINDOW = 60.0
DEFAULT_SLOW_WINDOW = 600.0
# Burn thresholds: fast/high pages on cliffs (14.4 is the classic
# 1h/5m pair's threshold; 8 suits our shorter windows), slow/low warns
# on sustained overspend.
DEFAULT_FAST_BURN = 8.0
DEFAULT_SLOW_BURN = 2.0
DEFAULT_OBJECTIVE = 0.99
# Minimum samples in a window before its burn rate is trusted: one
# unlucky request must not page anybody.
MIN_WINDOW_SAMPLES = 3
# Per-series sample cap (slow-window retention is the real bound; this
# is the memory backstop under pathological request rates).
MAX_SAMPLES = 4096

_METRICS = ("ttft", "tpot")


class SLOTarget:
    """One SLO class's latency objective."""

    def __init__(self, ttft_ms: Optional[float] = None,
                 tpot_ms: Optional[float] = None,
                 objective: float = DEFAULT_OBJECTIVE):
        self.ttft_ms = float(ttft_ms) if ttft_ms else None
        self.tpot_ms = float(tpot_ms) if tpot_ms else None
        objective = float(objective)
        if not 0.0 < objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {objective}")
        self.objective = objective

    def threshold_ms(self, metric: str) -> Optional[float]:
        return self.ttft_ms if metric == "ttft" else self.tpot_ms

    @property
    def budget(self) -> float:
        """The error budget: the fraction of requests ALLOWED to miss."""
        return 1.0 - self.objective

    def as_dict(self) -> dict:
        out = {"objective": self.objective}
        if self.ttft_ms is not None:
            out["ttft_ms"] = self.ttft_ms
        if self.tpot_ms is not None:
            out["tpot_ms"] = self.tpot_ms
        return out

    def __repr__(self):  # pragma: no cover - debug aid
        return f"SLOTarget({self.as_dict()})"


def targets_from_spec(spec: dict) -> Dict[str, SLOTarget]:
    """``spec['slo']`` → {slo class: :class:`SLOTarget`}.  The spec form
    is ``{"interactive": {"ttft_ms": 500, "tpot_ms": 80,
    "objective": 0.99}, ...}``; classes absent from the dict carry no
    objective and never alert."""
    raw = spec.get("slo") if isinstance(spec, dict) else None
    if not isinstance(raw, dict):
        return {}
    out: Dict[str, SLOTarget] = {}
    for cls, doc in raw.items():
        if not isinstance(doc, dict):
            continue
        tgt = SLOTarget(
            ttft_ms=doc.get("ttft_ms"),
            tpot_ms=doc.get("tpot_ms"),
            objective=doc.get("objective", DEFAULT_OBJECTIVE),
        )
        if tgt.ttft_ms is not None or tgt.tpot_ms is not None:
            out[str(cls)] = tgt
    return out


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


class _Series:
    """One (tenant, slo, metric) sample window: (t, ms, breach)."""

    __slots__ = ("samples", "breaches_total", "alerts_total", "firing")

    def __init__(self):
        self.samples: Deque[Tuple[float, float, bool]] = deque()
        self.breaches_total = 0
        self.alerts_total = 0
        # window -> currently firing (rising-edge alert counting)
        self.firing: Dict[str, bool] = {"fast": False, "slow": False}

    def observe(self, t: float, ms: float, breach: bool,
                keep_secs: float) -> None:
        self.samples.append((t, ms, breach))
        if breach:
            self.breaches_total += 1
        cut = t - keep_secs
        while self.samples and self.samples[0][0] < cut:
            self.samples.popleft()
        while len(self.samples) > MAX_SAMPLES:
            self.samples.popleft()

    def window(self, now: float, secs: float
               ) -> Tuple[int, int]:
        """(samples, breaches) within the trailing ``secs``."""
        cut = now - secs
        n = bad = 0
        for t, _, breach in self.samples:
            if t >= cut:
                n += 1
                bad += 1 if breach else 0
        return n, bad

    def percentiles(self, now: float, secs: float) -> dict:
        cut = now - secs
        vals = sorted(ms for t, ms, _ in self.samples if t >= cut)
        return {
            "n": len(vals),
            "p50": round(_percentile(vals, 0.50), 3),
            "p90": round(_percentile(vals, 0.90), 3),
            "p99": round(_percentile(vals, 0.99), 3),
        }


class SLOPlane:
    """The per-tenant SLO accountant for one serving rank.

    Feed it every ttft/tpot observation with its (tenant, slo) tag and
    a timestamp; ask it for burn rates, firing alerts, registry gauges
    and the drain summary.  No internal clocks, no sleeps."""

    def __init__(self, targets: Dict[str, SLOTarget],
                 fast_window: float = DEFAULT_FAST_WINDOW,
                 slow_window: float = DEFAULT_SLOW_WINDOW,
                 fast_burn: float = DEFAULT_FAST_BURN,
                 slow_burn: float = DEFAULT_SLOW_BURN,
                 min_samples: int = MIN_WINDOW_SAMPLES):
        self.targets = dict(targets or {})
        self.fast_window = float(fast_window)
        self.slow_window = max(float(slow_window), self.fast_window)
        self.thresholds = {"fast": float(fast_burn),
                           "slow": float(slow_burn)}
        self.windows = {"fast": self.fast_window,
                        "slow": self.slow_window}
        self.min_samples = max(int(min_samples), 1)
        self._series: Dict[Tuple[str, str, str], _Series] = {}

    @property
    def armed(self) -> bool:
        """Whether any class carries an objective (alerting possible)."""
        return bool(self.targets)

    @property
    def observed(self) -> bool:
        """Whether any sample has ever landed (summary worth printing)."""
        return bool(self._series)

    # --------------------------------------------------------- observing

    def _observe(self, metric: str, tenant: str, slo: str, ms: float,
                 now: float) -> None:
        tgt = self.targets.get(slo)
        threshold = tgt.threshold_ms(metric) if tgt else None
        breach = threshold is not None and float(ms) > threshold
        key = (str(tenant), str(slo), metric)
        series = self._series.get(key)
        if series is None:
            series = self._series[key] = _Series()
        series.observe(float(now), float(ms), breach, self.slow_window)

    def observe_ttft(self, tenant: str, slo: str, ms: float,
                     now: float) -> None:
        self._observe("ttft", tenant, slo, ms, now)

    def observe_tpot(self, tenant: str, slo: str, ms: float,
                     now: float) -> None:
        self._observe("tpot", tenant, slo, ms, now)

    # -------------------------------------------------------- evaluating

    def burn_rates(self, now: float) -> Dict[Tuple[str, str, str],
                                             Dict[str, float]]:
        """{(tenant, slo, metric): {window: burn}} for targeted series.
        Burn is error-rate over budget; 0.0 when the window is empty."""
        out = {}
        for key, series in self._series.items():
            tgt = self.targets.get(key[1])
            if tgt is None or tgt.threshold_ms(key[2]) is None:
                continue
            burns = {}
            for win, secs in self.windows.items():
                n, bad = series.window(now, secs)
                rate = bad / n if n else 0.0
                burns[win] = rate / tgt.budget
            out[key] = burns
        return out

    def evaluate(self, now: float) -> List[dict]:
        """Advance alert state and return the CURRENTLY-FIRING alerts.
        Rising edges increment the per-series alert total — re-asserting
        a still-firing alert is not a new page."""
        alerts = []
        for key, burns in self.burn_rates(now).items():
            series = self._series[key]
            for win, burn in burns.items():
                n, _ = series.window(now, self.windows[win])
                firing = (n >= self.min_samples
                          and burn >= self.thresholds[win])
                if firing and not series.firing[win]:
                    series.alerts_total += 1
                series.firing[win] = firing
                if firing:
                    tenant, slo, metric = key
                    alerts.append({
                        "tenant": tenant,
                        "slo": slo,
                        "metric": metric,
                        "window": win,
                        "burn": round(burn, 2),
                        "threshold": self.thresholds[win],
                        "samples": n,
                    })
        return alerts

    # -------------------------------------------------------- publishing

    def publish(self, reg, now: float) -> None:
        """Land the plane in a metrics registry as ``serve.slo.*``:
        burn-rate and alert gauges per (tenant, slo, metric, window),
        breach counters, and p50/p99 digests per series."""
        alerts = self.evaluate(now)
        firing = {(a["tenant"], a["slo"], a["metric"], a["window"])
                  for a in alerts}
        burns = self.burn_rates(now)
        for key, series in sorted(self._series.items()):
            tenant, slo, metric = key
            tags = {"tenant": tenant, "slo": slo, "metric": metric}
            pct = series.percentiles(now, self.slow_window)
            reg.gauge("serve.slo.p50_ms", **tags).set(pct["p50"])
            reg.gauge("serve.slo.p99_ms", **tags).set(pct["p99"])
            if key not in burns:
                continue  # undigested objective: no target, no alerting
            for win, burn in burns[key].items():
                reg.gauge("serve.slo.burn", window=win, **tags).set(
                    round(burn, 3))
                reg.gauge("serve.slo.alert", window=win, **tags).set(
                    1.0 if key + (win,) in firing else 0.0)
            breach_c = reg.counter("serve.slo.breaches", **tags)
            delta = series.breaches_total - int(breach_c.value)
            if delta > 0:
                breach_c.inc(delta)
            alert_c = reg.counter("serve.slo.alerts", **tags)
            delta = series.alerts_total - int(alert_c.value)
            if delta > 0:
                alert_c.inc(delta)

    def summary(self, now: float) -> dict:
        """The drain / ``--stats-summary`` document."""
        out: Dict[str, dict] = {}
        burns = self.burn_rates(now)
        for key, series in sorted(self._series.items()):
            tenant, slo, metric = key
            doc = series.percentiles(now, self.slow_window)
            doc["breaches"] = series.breaches_total
            if key in burns:
                doc["burn_fast"] = round(burns[key]["fast"], 2)
                doc["burn_slow"] = round(burns[key]["slow"], 2)
                doc["alerts"] = series.alerts_total
                doc["firing"] = any(series.firing.values())
            out.setdefault(f"{tenant}/{slo}", {})[metric] = doc
        return out
