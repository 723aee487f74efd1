"""horovod_tpu_torch.obs — the per-rank observability planes (counterpart
of ``horovod_tpu/obs``).

* **metrics** (:mod:`.registry`) — Counter / Gauge / Histogram
  instruments updated by the engine, the elastic and checkpoint paths and
  the serving loop; dumped per rank as JSON via ``HVDTPU_METRICS_DUMP``
  and aggregated by the launcher's ``--stats-summary`` (:mod:`.summary`).
* **progress beat** (:mod:`.progress`) — the collective-path counter the
  elastic launcher's deadlock watchdog reads.
* **all-rank timeline merge** (:mod:`.timeline_merge`).
* **live telemetry** (:mod:`.stream` worker side, :mod:`.live` launcher
  side) — per-rank snapshot deltas over the signed KV path: console
  digests, ``live_history.jsonl`` and a Prometheus ``GET /metrics``.
* **straggler attribution** (:mod:`.straggler`).
* **flight recorder** (:mod:`.flightrec`) + **post-mortem**
  (:mod:`.postmortem`) — a bounded per-rank event ring flushed on every
  death path, and the launcher-side analyzer that names the root cause.
* **request-level tracing** (:mod:`.trace`, :mod:`.trace_merge`) —
  deterministically sampled spans per request and per training step.
* **MFU profiler** (:mod:`.profile`), **goodput ledger**
  (:mod:`.goodput`), **tenant SLO burn rates** (:mod:`.slo`).
* **training health** (:mod:`.health` + :mod:`.divergence`) — the step's
  numerics bundle judged by an EWMA anomaly table, and the cross-rank
  divergence sentinel over bitwise digests of the parameters.
* **memory plane** (:mod:`.memplane`) — owner-tagged census of device
  memory, per-program breakdowns and the OOM black box.
"""

from . import divergence  # noqa: F401
from . import flightrec  # noqa: F401
from . import goodput  # noqa: F401
from . import health  # noqa: F401
from . import memplane  # noqa: F401
from . import slo  # noqa: F401
from . import pathspec  # noqa: F401
from . import profile  # noqa: F401
from . import progress  # noqa: F401
from . import straggler  # noqa: F401
from . import stream  # noqa: F401
from . import trace  # noqa: F401
from .registry import (  # noqa: F401
    METRICS_DUMP_ENV,
    CollectorRetired,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    dump_metrics,
    get_registry,
    reset_registry,
)

set_phase = progress.set_phase
dump_flight_recorder = flightrec.dump_flight_recorder
install_death_hooks = flightrec.install_death_hooks

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "CollectorRetired",
    "METRICS_DUMP_ENV",
    "get_registry",
    "reset_registry",
    "dump_metrics",
    "dump_flight_recorder",
    "install_death_hooks",
    "divergence",
    "flightrec",
    "goodput",
    "health",
    "memplane",
    "pathspec",
    "profile",
    "progress",
    "slo",
    "straggler",
    "stream",
    "trace",
    "set_phase",
]
