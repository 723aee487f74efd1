"""Load-driven autoscaling for serving fleets: grow and shrink the
elastic world deliberately, not only on failure (counterpart of
``horovod_tpu/serve/autoscale.py``; host code, copied with the port's
imports).

The serving plane (``service.py``) streams its pressure signals —
``serve.queue_depth``, ``serve.active_slots`` and ``serve.ttft_ms`` — to
the launcher's live plane every round, and the elastic launcher already
re-forms a world around a membership change (a re-minted rendezvous
epoch and replay recovery).  This module closes the loop: a
launcher-resident controller watches those gauges and drives the same
epoch machinery on purpose, so a scale event is indistinguishable from a
survived failure — in-flight requests replay, none is dropped.

Split on the same line as the scheduler: :class:`AutoscalePolicy` is a
**pure decision table** — no clocks read, no I/O, every input passed in
— so hysteresis, per-direction cooldowns, and the grow-failure backoff
are unit-testable as a function of (time, pressure) sequences.
:class:`AutoscaleController` is the launcher-side glue: it reads the
live plane's merged views, feeds the policy, and publishes the
``autoscale.*`` metrics; the launcher's monitor loop *executes*
decisions, because only it owns epoch minting and process spawn.

Decision rules:

* **grow** when ``queue_depth`` has stayed at/above ``scale_up_queue``
  (or ttft p50 above ``scale_up_ttft_ms``, when set) continuously for
  ``up_window_secs`` — a one-round spike never scales — and the up
  cooldown and any grow-failure backoff have expired and the world is
  below ``max_workers``.
* **shrink** when the fleet is fully drained (queue empty AND no active
  slot) continuously for ``scale_down_idle_secs`` and the down cooldown
  has expired and the world is above ``min_workers``.
* both directions measure their cooldown from the LAST resize in
  EITHER direction, so an up immediately chased by a down (flapping)
  is structurally impossible within one cooldown window.
* a failed grow (standby host refuses admission — chaos point
  ``scale_admit``/``action=scale_fail``) backs off exponentially:
  ``backoff_base_secs * 2^(failures-1)`` capped at
  ``backoff_max_secs``; one successful grow resets the ladder.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..utils.logging import get_logger

LOG = get_logger("serve.autoscale")

__all__ = [
    "AutoscaleConfig",
    "AutoscalePolicy",
    "AutoscaleController",
    "Decision",
    "gauges_from_views",
    "world_token",
]

DEFAULT_SCALE_UP_QUEUE = 4
DEFAULT_UP_WINDOW_SECS = 1.0
DEFAULT_SCALE_DOWN_IDLE_SECS = 10.0
DEFAULT_COOLDOWN_SECS = 15.0
DEFAULT_BACKOFF_BASE_SECS = 5.0
DEFAULT_BACKOFF_MAX_SECS = 300.0


@dataclass(frozen=True)
class AutoscaleConfig:
    """The envelope and the knobs (CLI: ``--serve-autoscale``,
    ``--scale-up-queue``, ``--scale-down-idle-secs``,
    ``--scale-cooldown-secs``, plus ``--min-workers``/``--max-workers``
    for the envelope)."""

    min_workers: int
    max_workers: int
    scale_up_queue: int = DEFAULT_SCALE_UP_QUEUE
    scale_up_ttft_ms: Optional[float] = None
    up_window_secs: float = DEFAULT_UP_WINDOW_SECS
    scale_down_idle_secs: float = DEFAULT_SCALE_DOWN_IDLE_SECS
    up_cooldown_secs: float = DEFAULT_COOLDOWN_SECS
    down_cooldown_secs: float = DEFAULT_COOLDOWN_SECS
    grow_step: int = 1
    shrink_step: int = 1
    backoff_base_secs: float = DEFAULT_BACKOFF_BASE_SECS
    backoff_max_secs: float = DEFAULT_BACKOFF_MAX_SECS

    def __post_init__(self):
        if not 1 <= self.min_workers <= self.max_workers:
            raise ValueError(
                f"autoscale envelope must satisfy 1 <= min_workers "
                f"({self.min_workers}) <= max_workers "
                f"({self.max_workers})"
            )
        if self.scale_up_queue < 1:
            raise ValueError("scale_up_queue must be >= 1")
        if self.grow_step < 1 or self.shrink_step < 1:
            raise ValueError("grow_step/shrink_step must be >= 1")


@dataclass(frozen=True)
class Decision:
    direction: str  # "up" | "down"
    target: int     # desired world size
    reason: str


class AutoscalePolicy:
    """Pure hysteresis/cooldown/backoff state machine.

    ``observe(now, ...)`` is the only input channel and ``now`` is a
    caller-supplied monotonic timestamp — this class never reads a
    clock, so the decision table is a deterministic function of its
    observation sequence (tests drive it with a fake clock, exactly
    like the scheduler's decision-table tests)."""

    def __init__(self, cfg: AutoscaleConfig):
        self.cfg = cfg
        self._pressure_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_resize: Optional[float] = None
        self._backoff_until: Optional[float] = None
        self._grow_failures = 0
        # (now, direction, target, reason) — the decision trace the
        # no-flapping acceptance asserts cooldowns against.
        self.trace: List[Tuple[float, str, int, str]] = []

    # ----------------------------------------------------------- inputs

    def observe(self, now: float, *, queue_depth: int, active_slots: int,
                world_size: int,
                ttft_p50_ms: Optional[float] = None
                ) -> Optional[Decision]:
        """One pressure observation; returns the resize decision the
        caller should execute, or None."""
        cfg = self.cfg
        pressured = queue_depth >= cfg.scale_up_queue or (
            cfg.scale_up_ttft_ms is not None
            and ttft_p50_ms is not None
            and ttft_p50_ms >= cfg.scale_up_ttft_ms
        )
        idle = queue_depth == 0 and active_slots == 0

        # Hysteresis windows: pressure/idle must be CONTINUOUS — any
        # contrary observation restarts the window.
        self._pressure_since = (
            self._pressure_since if pressured and
            self._pressure_since is not None
            else (now if pressured else None)
        )
        self._idle_since = (
            self._idle_since if idle and self._idle_since is not None
            else (now if idle else None)
        )

        if (
            self._pressure_since is not None
            and now - self._pressure_since >= cfg.up_window_secs
            and world_size < cfg.max_workers
            and self._cooldown_ok(now, cfg.up_cooldown_secs)
            and (self._backoff_until is None or now >= self._backoff_until)
        ):
            target = min(world_size + cfg.grow_step, cfg.max_workers)
            return self._decide(now, "up", target, (
                f"queue {queue_depth} >= {cfg.scale_up_queue} for "
                f"{now - self._pressure_since:.1f}s"
            ))
        if (
            self._idle_since is not None
            and now - self._idle_since >= cfg.scale_down_idle_secs
            and world_size > cfg.min_workers
            and self._cooldown_ok(now, cfg.down_cooldown_secs)
        ):
            target = max(world_size - cfg.shrink_step, cfg.min_workers)
            return self._decide(now, "down", target, (
                f"idle for {now - self._idle_since:.1f}s"
            ))
        return None

    def _cooldown_ok(self, now: float, cooldown: float) -> bool:
        return (self._last_resize is None
                or now - self._last_resize >= cooldown)

    def _decide(self, now: float, direction: str, target: int,
                reason: str) -> Decision:
        # The cooldown clock starts at the DECISION (the launcher
        # executes it synchronously), and both hysteresis windows
        # restart so the next decision needs fresh evidence.
        self._last_resize = now
        self._pressure_since = None
        self._idle_since = None
        self.trace.append((now, direction, target, reason))
        return Decision(direction=direction, target=target, reason=reason)

    # ------------------------------------------------- grow-failure path

    def record_grow_ok(self) -> None:
        self._grow_failures = 0
        self._backoff_until = None

    def record_grow_failed(self, now: float) -> float:
        """Exponential backoff on a refused admission; returns the
        backoff window in seconds."""
        self._grow_failures += 1
        backoff = min(
            self.cfg.backoff_base_secs * (2 ** (self._grow_failures - 1)),
            self.cfg.backoff_max_secs,
        )
        self._backoff_until = now + backoff
        self.trace.append((now, "grow_failed", self._grow_failures,
                           f"backoff {backoff:.1f}s"))
        return backoff


def gauges_from_views(views, world=None) -> Optional[Dict[str, float]]:
    """The autoscale pressure signals from the live plane's merged
    per-rank views (obs/live.py ``LiveAggregator.merged()``): worst
    (max) queue depth and active slots across ranks — the gauges are
    near-identical by the identical-schedule invariant, and max never
    hides pressure — plus the worst ttft p50.  None until some rank has
    streamed a serve gauge (the policy must not decide on silence).

    ``world`` restricts the read to CURRENT members: the aggregator
    keeps a dead or released rank's final view forever, and a rank
    that died busy would otherwise pin frozen queue/active values into
    every future decision (perpetual pressure, or an idle-shrink that
    can never fire)."""
    if world is not None:
        members = set(world)
        views = {r: v for r, v in views.items() if r in members}
    queue = active = ttft = None
    for view in views.values():
        for m in view.metrics.values():
            name = m.get("name")
            if name == "serve.queue_depth":
                v = float(m["value"])
                queue = v if queue is None else max(queue, v)
            elif name == "serve.active_slots":
                v = float(m["value"])
                active = v if active is None else max(active, v)
            elif name == "serve.ttft_ms" and m.get("count"):
                p50 = m.get("p50")
                if p50 is not None:
                    ttft = p50 if ttft is None else max(ttft, p50)
    if queue is None:
        return None
    out: Dict[str, float] = {
        "queue_depth": queue,
        "active_slots": active or 0.0,
    }
    if ttft is not None:
        out["ttft_p50_ms"] = ttft
    return out


def world_token(prev_world: Optional[int], world: int,
                version: Optional[int] = None) -> str:
    """The live-digest / summary autoscale token (``world 4→6 v=12``)
    — ONE formatter so the console digest and ``--stats-summary`` can
    never disagree about what a resize or a swap looked like (the PR-3
    single-source rule)."""
    if prev_world is not None and prev_world != world:
        token = f"world {prev_world}→{world}"
    else:
        token = f"world {world}"
    if version is not None:
        token += f" v={int(version)}"
    return token


class AutoscaleController:
    """Launcher-side glue around the pure policy.

    Owns nothing it does not need: the launcher's monitor loop calls
    :meth:`tick` on its own cadence and executes any returned decision
    itself (epoch mint + spawn/drop), then reports the outcome through
    :meth:`executed` / :meth:`grow_failed`.  Metrics land in the
    launcher process's own registry (dumped with the ``launcher`` tag,
    so ``--stats-summary`` picks them up) and are appended to the
    ``/metrics`` exposition via :meth:`prometheus`."""

    def __init__(self, cfg: AutoscaleConfig, registry=None):
        from ..obs import get_registry  # noqa: PLC0415

        self.cfg = cfg
        self.policy = AutoscalePolicy(cfg)
        self._reg = registry if registry is not None else get_registry()

    def tick(self, now: float, views, world) -> Optional[Decision]:
        """``world``: the CURRENT membership list — views from ranks
        outside it (dead, released) are ignored, not averaged in."""
        world = list(world)
        self._reg.gauge("autoscale.world").set(len(world))
        gauges = gauges_from_views(views, world)
        if gauges is None:
            return None
        return self.policy.observe(
            now,
            queue_depth=int(gauges["queue_depth"]),
            active_slots=int(gauges["active_slots"]),
            world_size=len(world),
            ttft_p50_ms=gauges.get("ttft_p50_ms"),
        )

    def executed(self, decision: Decision, epoch: int,
                 world_size: int) -> None:
        self._reg.counter("autoscale.decisions",
                          direction=decision.direction).inc()
        self._reg.gauge("autoscale.world").set(world_size)
        if decision.direction == "up":
            self.policy.record_grow_ok()
        LOG.info("autoscale %s -> world %d at epoch %d (%s)",
                 decision.direction, world_size, epoch, decision.reason)

    def grow_failed(self, now: float, rank: int) -> None:
        backoff = self.policy.record_grow_failed(now)
        self._reg.counter("autoscale.backoffs").inc()
        LOG.warning(
            "autoscale grow refused admission for rank %d; backing off "
            "%.1fs", rank, backoff,
        )

    # ------------------------------------------------------- exposition

    def prometheus(self) -> str:
        """Launcher-local autoscale series appended to the live plane's
        ``/metrics`` render (worker snapshots never carry these — the
        controller lives in the launcher)."""
        lines = [
            "# HELP hvdtpu_autoscale_world Current serving world size "
            "as the autoscale controller last saw it",
            "# TYPE hvdtpu_autoscale_world gauge",
            f"hvdtpu_autoscale_world "
            f"{self._reg.gauge('autoscale.world').value}",
            "# HELP hvdtpu_autoscale_decisions Resize decisions "
            "executed, by direction",
            "# TYPE hvdtpu_autoscale_decisions counter",
        ]
        for direction in ("up", "down"):
            lines.append(
                f'hvdtpu_autoscale_decisions{{direction="{direction}"}} '
                f"{int(self._reg.counter('autoscale.decisions', direction=direction).value)}"
            )
        lines += [
            "# HELP hvdtpu_autoscale_backoffs Grow attempts refused "
            "admission (exponential backoff armed)",
            "# TYPE hvdtpu_autoscale_backoffs counter",
            f"hvdtpu_autoscale_backoffs "
            f"{int(self._reg.counter('autoscale.backoffs').value)}",
        ]
        return "\n".join(lines) + "\n"
