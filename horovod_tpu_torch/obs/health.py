"""Training-health plane: the step's numerics bundle and the anomaly
judge (counterpart of ``horovod_tpu/obs/health.py``).

The observability planes watch time and bytes; this module watches the
*numbers*.  Three pieces:

* **The bundle** (:func:`health_bundle`) — a device-side vector of
  scalars computed from values the step already holds (loss, grads,
  updates, params): global grad norm, per-bucket grad norms (the
  ``build_layout`` buckets the overlap plan fuses), max |update|/|param|
  ratio, and the nonfinite count, in :func:`bundle_names` order.  The
  reference fuses it into the step's HLO; here it is a handful of torch
  ops queued on the step's stream, with no host read: the
  :class:`~..optim.overlap.OverlapPlan` computes it over its flat bucket
  buffers with multi-tensor (``torch._foreach_*``) reductions
  (``OverlapPlan(health=True)``), and :class:`StepHealth` reads it one
  step late, when the device has finished with it.  With health off the
  step is unchanged.

* **The judge** (:class:`AnomalyJudge`) — a pure decision table over
  the bundle stream.  Per-series EWMA mean + EWMA absolute deviation
  (a robust MAD-flavored scale, cheap and clock-free); alert classes
  ``loss-spike``, ``grad-explode``, ``grad-vanish``, ``dead-gradient``
  (a bucket's norm pinned at zero for ``dead_steps``), and
  ``nonfinite`` (absolute — no baseline needed to know NaN is bad).
  Alerts are edge-triggered: the counter increments once per episode,
  the gauge holds while the condition persists (the same discipline as
  obs/slo.py's burn-rate alerts).

* **The monitor** (:class:`HealthMonitor`) — host-side glue: feeds the
  judge, publishes ``health.*`` gauges/histograms into the registry
  (→ /metrics, live digest, history rows, ``--stats-summary``, bench
  records), records flightrec events on rising edges, and on the FIRST
  nonfinite runs the off-hot-path provenance bisection
  (:func:`nonfinite_provenance`) that names the first offending leaf.

Everything but :func:`health_bundle` is decision logic over small host
scalars, the reference's.  :class:`StepHealth` is the port's glue of a
training loop to the monitor and the divergence sentinel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import env as envmod
from ..utils.logging import get_logger

LOG = get_logger("obs.health")

__all__ = [
    "HealthConfig",
    "ALERT_CLASSES",
    "health_bundle",
    "bundle_names",
    "nonfinite_provenance",
    "AnomalyJudge",
    "Alert",
    "HealthMonitor",
    "StepHealth",
]

ALERT_CLASSES = (
    "loss-spike",
    "grad-explode",
    "grad-vanish",
    "dead-gradient",
    "nonfinite",
)


@dataclass(frozen=True)
class HealthConfig:
    """Knobs, resolved once from env (set by run/config_parser.py from
    ``--health`` / ``--health-check-steps`` / ``--divergence-action``)."""

    enabled: bool = False
    check_steps: int = 100
    divergence_action: str = "warn"

    @classmethod
    def from_env(cls) -> "HealthConfig":
        import os  # noqa: PLC0415

        raw = os.environ.get(envmod.HEALTH, "off").strip().lower()
        enabled = raw in ("on", "1", "true", "yes")
        return cls(
            enabled=enabled,
            check_steps=max(1, envmod.env_int(envmod.HEALTH_CHECK_STEPS,
                                              100)),
            divergence_action=os.environ.get(
                envmod.DIVERGENCE_ACTION, "warn").strip().lower() or "warn",
        )


# ---------------------------------------------------------------------------
# the in-graph bundle
# ---------------------------------------------------------------------------


def bundle_names(n_buckets: int) -> List[str]:
    """Stable component order of the bundle vector."""
    return (["loss", "grad_norm", "update_ratio_max", "nonfinite"]
            + [f"bucket{i}_grad_norm" for i in range(n_buckets)])


def health_bundle(loss, grads_flat: Sequence, layout,
                  updates_flat: Optional[Sequence] = None,
                  params_flat: Optional[Sequence] = None):
    """The health vector from a step's flat leaves (``layout``'s leaf
    order): a float32 tensor of ``4 + n_buckets`` scalars in
    :func:`bundle_names` order, on the leaves' device, with no host
    read.  Per bucket one fp32 sum of squares and one nonfinite count;
    the ratio is the max over leaves of ``max|u| / (max|p| + 1e-12)``.
    The straightforward form, per leaf: the plan's bundle
    (``OverlapPlan(health=True)``) computes the same vector over its flat
    buffers."""
    import torch  # noqa: PLC0415

    f32 = torch.float32
    dev = grads_flat[0].device if len(grads_flat) else None
    per_bucket = []
    nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
    total_sq = torch.zeros((), dtype=f32, device=dev)
    for b in layout.buckets:
        sq = torch.zeros((), dtype=f32, device=dev)
        for i in b.leaf_indices:
            g = grads_flat[i].detach().to(f32)
            sq = sq + torch.sum(g * g)
            nonfinite = nonfinite + torch.sum(~torch.isfinite(g))
        per_bucket.append(torch.sqrt(sq))
        total_sq = total_sq + sq
    ratio = torch.zeros((), dtype=f32, device=dev)
    if updates_flat is not None and params_flat is not None:
        for u, p in zip(updates_flat, params_flat):
            r = (u.detach().to(f32).abs().max()
                 / (p.detach().to(f32).abs().max() + 1e-12))
            ratio = torch.maximum(ratio, r)
    loss = torch.as_tensor(loss).detach().to(device=dev, dtype=f32)
    return torch.stack([loss.reshape(()), torch.sqrt(total_sq), ratio,
                        nonfinite.to(f32)] + per_bucket)


def _host(t) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    if hasattr(t, "detach"):
        t = t.detach()
        if t.dtype.is_floating_point and t.element_size() == 2:
            t = t.float()  # numpy has no bfloat16; finiteness survives
        return t.cpu().numpy()
    return np.asarray(t)


def nonfinite_provenance(grads_flat: Sequence, layout,
                         leaf_names: Optional[Sequence[str]] = None
                         ) -> Optional[Tuple[int, int, str]]:
    """Off-hot-path bisection: name the FIRST leaf carrying a
    nonfinite value.  Host-side, runs only after the bundle has already
    reported ``nonfinite > 0`` — cost does not matter by then.  Returns
    ``(bucket_index, leaf_index, leaf_name)`` or None."""
    for b in layout.buckets:
        for i in b.leaf_indices:
            g = _host(grads_flat[i])
            if not np.isfinite(g).all():
                name = (leaf_names[i]
                        if leaf_names and i < len(leaf_names)
                        else f"leaf{i}")
                return b.index, i, name
    return None


# ---------------------------------------------------------------------------
# the anomaly judge (pure)
# ---------------------------------------------------------------------------


@dataclass
class _Series:
    """EWMA mean + EWMA absolute deviation of one scalar stream."""

    alpha: float
    mean: float = 0.0
    dev: float = 0.0
    n: int = 0

    def z(self, x: float) -> float:
        """Robust z-score of ``x`` against the history BEFORE observing
        it.  The relative floor on the scale means a perfectly flat or
        smoothly ramping series (dev ~ 0) only alerts on a step change
        of >~ ``z_spike * 2%`` of the mean — not on sub-percent drift."""
        if self.n == 0:
            return 0.0
        scale = max(self.dev, 1e-9, 2e-2 * abs(self.mean))
        return (x - self.mean) / scale

    def observe(self, x: float) -> None:
        if self.n == 0:
            self.mean = x
            self.dev = 0.0
        else:
            a = self.alpha
            self.dev = (1 - a) * self.dev + a * abs(x - self.mean)
            self.mean = (1 - a) * self.mean + a * x
        self.n += 1


@dataclass(frozen=True)
class Alert:
    cls: str          # one of ALERT_CLASSES
    rising: bool      # True exactly once per episode
    detail: str = ""


class AnomalyJudge:
    """Pure decision table over bundle observations — no clocks, no
    I/O, fully deterministic, so it is testable as a table of (series
    in, alerts out).

    Rules (evaluated per :meth:`observe` call):

    * ``nonfinite``     — bundle's nonfinite count > 0 or loss not
                          finite.  Absolute: fires even before
                          ``min_samples``.
    * ``loss-spike``    — loss z-score > ``z_spike`` AND loss above its
                          EWMA mean (a downward "spike" is good news).
    * ``grad-explode``  — grad-norm z-score > ``z_spike``, norm above
                          mean.
    * ``grad-vanish``   — grad norm below ``vanish_frac`` of its EWMA
                          mean (scale-relative: an absolute threshold
                          would need per-model tuning).
    * ``dead-gradient`` — any bucket's grad norm exactly 0.0 for
                          ``dead_steps`` consecutive observations (a
                          detached/frozen subtree).

    Relative rules hold off until ``min_samples`` observations so a
    cold EWMA can't fire on warmup transients.
    """

    def __init__(self, *, alpha: float = 0.1, z_spike: float = 6.0,
                 vanish_frac: float = 1e-3, dead_steps: int = 10,
                 min_samples: int = 8):
        self.z_spike = float(z_spike)
        self.vanish_frac = float(vanish_frac)
        self.dead_steps = int(dead_steps)
        self.min_samples = int(min_samples)
        self.loss = _Series(alpha)
        self.grad = _Series(alpha)
        self._zero_streak: Dict[int, int] = {}
        self.firing: Dict[str, bool] = {c: False for c in ALERT_CLASSES}
        self.alerts_total: Dict[str, int] = {c: 0 for c in ALERT_CLASSES}
        self.last_loss_z = 0.0
        self.last_grad_z = 0.0

    def observe(self, *, loss: float, grad_norm: float,
                nonfinite: int = 0,
                bucket_norms: Sequence[float] = ()) -> List[Alert]:
        """Feed one step's bundle; returns the alerts active AFTER this
        observation (``rising=True`` on the first step of an episode)."""
        active: Dict[str, str] = {}

        finite = math.isfinite(loss) and math.isfinite(grad_norm)
        if nonfinite > 0 or not finite:
            active["nonfinite"] = f"count={int(nonfinite)}"

        warm = (self.loss.n >= self.min_samples and finite)
        self.last_loss_z = self.loss.z(loss) if finite else float("inf")
        self.last_grad_z = (self.grad.z(grad_norm) if finite
                            else float("inf"))
        if warm:
            if (self.last_loss_z > self.z_spike
                    and loss > self.loss.mean):
                active["loss-spike"] = f"z={self.last_loss_z:.1f}"
            if (self.last_grad_z > self.z_spike
                    and grad_norm > self.grad.mean):
                active["grad-explode"] = f"z={self.last_grad_z:.1f}"
            if (self.grad.mean > 0
                    and grad_norm < self.vanish_frac * self.grad.mean):
                active["grad-vanish"] = f"norm={grad_norm:.3g}"

        for i, bn in enumerate(bucket_norms):
            streak = self._zero_streak.get(i, 0)
            streak = streak + 1 if bn == 0.0 else 0
            self._zero_streak[i] = streak
            if streak >= self.dead_steps and "dead-gradient" not in active:
                active["dead-gradient"] = f"bucket={i} steps={streak}"

        # Only clean samples train the baseline — a NaN loss would
        # poison the EWMA and mask everything after it.
        if finite:
            self.loss.observe(loss)
            self.grad.observe(grad_norm)

        out: List[Alert] = []
        for cls in ALERT_CLASSES:
            now = cls in active
            rising = now and not self.firing[cls]
            if rising:
                self.alerts_total[cls] += 1
            self.firing[cls] = now
            if now:
                out.append(Alert(cls=cls, rising=rising,
                                 detail=active[cls]))
        return out


# ---------------------------------------------------------------------------
# the monitor (host-side glue)
# ---------------------------------------------------------------------------


class HealthMonitor:
    """Publishes the bundle + judge verdicts to every obs surface."""

    def __init__(self, n_buckets: int = 0, *, rank: int = 0,
                 judge: Optional[AnomalyJudge] = None,
                 leaf_names: Optional[Sequence[str]] = None,
                 registry=None):
        self.n_buckets = int(n_buckets)
        self.rank = int(rank)
        self.judge = judge or AnomalyJudge()
        self.leaf_names = list(leaf_names) if leaf_names else None
        if registry is None:
            from .registry import get_registry  # noqa: PLC0415

            registry = get_registry()
        self._reg = registry
        self.nonfinite_total = 0
        self.first_nonfinite: Optional[dict] = None

    # -- feeding ----------------------------------------------------------

    def observe_bundle(self, step: int, bundle,
                       grads_flat: Optional[Sequence] = None,
                       layout=None) -> List[Alert]:
        """Consume one step's bundle vector (:func:`health_bundle`
        order).  ``grads_flat``/``layout``, when provided, enable the
        first-nonfinite provenance bisection."""
        vec = np.asarray(_host(bundle), dtype=np.float64).ravel()
        loss, grad_norm, ratio, nonfinite = (
            float(vec[0]), float(vec[1]), float(vec[2]), int(vec[3]))
        bucket_norms = [float(x) for x in vec[4:4 + self.n_buckets]]
        return self.observe(step, loss=loss, grad_norm=grad_norm,
                            update_ratio=ratio, nonfinite=nonfinite,
                            bucket_norms=bucket_norms,
                            grads_flat=grads_flat, layout=layout)

    def observe(self, step: int, *, loss: float, grad_norm: float,
                update_ratio: float = 0.0, nonfinite: int = 0,
                bucket_norms: Sequence[float] = (),
                grads_flat: Optional[Sequence] = None,
                layout=None) -> List[Alert]:
        alerts = self.judge.observe(loss=loss, grad_norm=grad_norm,
                                    nonfinite=nonfinite,
                                    bucket_norms=bucket_norms)
        self._publish(step, loss, grad_norm, update_ratio, nonfinite,
                      bucket_norms, alerts)
        if nonfinite > 0 or not math.isfinite(loss):
            self._first_nonfinite(step, nonfinite, grads_flat, layout)
        return alerts

    # -- publishing -------------------------------------------------------

    def _publish(self, step: int, loss: float, grad_norm: float,
                 ratio: float, nonfinite: int,
                 bucket_norms: Sequence[float],
                 alerts: List[Alert]) -> None:
        reg = self._reg
        if math.isfinite(loss):
            reg.gauge("health.loss").set(loss)
        if math.isfinite(grad_norm):
            reg.gauge("health.grad_norm").set(grad_norm)
            reg.histogram("health.grad_norm_hist").observe(grad_norm)
        reg.gauge("health.grad_norm_z").set(
            self.judge.last_grad_z
            if math.isfinite(self.judge.last_grad_z) else -1.0)
        reg.gauge("health.update_ratio_max").set(ratio)
        reg.gauge("health.nonfinite").set(nonfinite)
        if nonfinite > 0:
            self.nonfinite_total += nonfinite
            reg.counter("health.nonfinite_total").inc(int(nonfinite))
        for i, bn in enumerate(bucket_norms):
            reg.gauge("health.bucket_grad_norm", bucket=str(i)).set(
                bn if math.isfinite(bn) else -1.0)

        firing = {a.cls for a in alerts}
        for cls in ALERT_CLASSES:
            reg.gauge("health.alert", **{"class": cls}).set(
                1 if cls in firing else 0)
        for a in alerts:
            if not a.rising:
                continue
            reg.counter("health.alerts", **{"class": a.cls}).inc()
            detail = f"step={step} {a.detail}".strip()
            from . import flightrec  # noqa: PLC0415

            flightrec.record("health.alert", name=a.cls, cycle=step,
                             detail=detail)
            LOG.warning("health alert [%s] at step %d (%s)",
                        a.cls, step, a.detail)

    # -- provenance -------------------------------------------------------

    def _first_nonfinite(self, step: int, count: int,
                         grads_flat: Optional[Sequence],
                         layout) -> None:
        if self.first_nonfinite is not None:
            return
        info = {"step": int(step), "rank": self.rank,
                "count": int(count)}
        if grads_flat is not None and layout is not None:
            found = nonfinite_provenance(grads_flat, layout,
                                         self.leaf_names)
            if found is not None:
                bucket, leaf_index, leaf_name = found
                info.update(bucket=bucket, leaf_index=leaf_index,
                            leaf=leaf_name)
        self.first_nonfinite = info
        detail = " ".join(f"{k}={v}" for k, v in info.items())
        from . import flightrec  # noqa: PLC0415

        flightrec.record("health.nonfinite", name="first", cycle=step,
                         detail=detail)
        LOG.error("first nonfinite at step %d (%s)", step, detail)


# ---------------------------------------------------------------------------
# a training loop's glue (the port's)
# ---------------------------------------------------------------------------


class StepHealth:
    """Feeds a training loop's health bundles to a :class:`HealthMonitor`
    and runs the :class:`~.divergence.DivergenceSentinel` on the
    on-device digest, for an ``OverlapPlan(health=True)``.

    :meth:`after_step` queues the step's bundle (a device tensor): on
    CUDA a non-blocking copy into pinned memory with an event behind it,
    consumed by a later call once the event has completed, so the loop
    never waits for the device on the monitor's account.  Every
    ``check_steps`` steps (``HVDTPU_HEALTH_CHECK_STEPS``) it digests the
    parameters on their device (:func:`~.divergence.device_digest`),
    fetches the ``(buckets, 2)`` digest words (the one host sync of a
    check) and runs the sentinel's exchange and verdict; a ``halt``
    raises :class:`~.divergence.DivergenceHalt` from here.  :meth:`drain`
    waits for and observes every queued bundle (the loop's end)."""

    def __init__(self, plan, *, rank: int = 0,
                 config: Optional[HealthConfig] = None,
                 leaf_names: Optional[Sequence[str]] = None,
                 exchange=None, registry=None):
        from .divergence import DivergenceSentinel, device_digest  # noqa: PLC0415

        self.config = config or HealthConfig.from_env()
        self.plan = plan
        self.layout = plan.layout
        self.monitor = HealthMonitor(len(self.layout.buckets), rank=rank,
                                     leaf_names=leaf_names,
                                     registry=registry)
        self.sentinel = DivergenceSentinel(
            self.layout, rank=rank, check_steps=self.config.check_steps,
            action=self.config.divergence_action, exchange=exchange,
            leaf_names=leaf_names, registry=registry)
        self._digest = device_digest(self.layout)
        self._pending: List[tuple] = []
        self.observed: List[Tuple[int, np.ndarray]] = []
        self.digests: List[Tuple[int, np.ndarray]] = []
        self.reports: List = []

    def after_step(self, step: int, bundle) -> None:
        import torch  # noqa: PLC0415

        if bundle is not None:
            event = None
            if bundle.is_cuda:
                host = torch.empty(bundle.shape, dtype=bundle.dtype,
                                   pin_memory=True)
                host.copy_(bundle, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host = bundle.detach().clone()
            self._pending.append((step, host, event))
        self._observe(block=False)
        if step % self.config.check_steps == 0:
            self.check(step)

    def check(self, step: int):
        """Digest the parameters on their device and run the sentinel;
        returns its report (None when every rank agrees)."""
        from .divergence import digest_matrix_host  # noqa: PLC0415

        leaves = list(self.plan.params)
        mat = digest_matrix_host(self._digest(*leaves))
        self.digests.append((step, mat))
        report = self.sentinel.check(step, leaves, bucket_digests=mat)
        if report is not None:
            self.reports.append(report)
        return report

    def drain(self) -> None:
        self._observe(block=True)

    def _observe(self, block: bool) -> None:
        while self._pending:
            step, host, event = self._pending[0]
            if event is not None and not event.query():
                if not block:
                    return
                event.synchronize()
            self._pending.pop(0)
            vec = host.numpy().astype(np.float64)
            self.observed.append((step, vec))
            self.monitor.observe_bundle(step, vec)
