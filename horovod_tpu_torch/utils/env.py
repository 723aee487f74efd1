"""Environment knob names and parsing (counterpart of
``horovod_tpu/utils/env.py``, copied, not imported: only the names this
package reads).

The rendezvous contract is the ``hvdrun`` launcher's (``HVDTPU_*``);
``torchrun``'s names are read when those are absent.
"""

from __future__ import annotations

import os

# hvdrun's per-rank environment (horovod_tpu/basics.py:244-306)
RANK = "HVDTPU_RANK"
SIZE = "HVDTPU_SIZE"
LOCAL_RANK = "HVDTPU_LOCAL_RANK"
LOCAL_SIZE = "HVDTPU_LOCAL_SIZE"
CROSS_RANK = "HVDTPU_CROSS_RANK"
CROSS_SIZE = "HVDTPU_CROSS_SIZE"
COORDINATOR = "HVDTPU_COORDINATOR"  # host:port of the rendezvous store
START_TIMEOUT = "HVDTPU_START_TIMEOUT"

# A forced slice partition (horovod_tpu/utils/env.py:26-31): NUM_SLICES
# splits the world into that many contiguous equal blocks of processes;
# SLICE_SIZE is the same knob as processes per slice.  NUM_SLICES wins when
# both are set.
NUM_SLICES = "HVDTPU_NUM_SLICES"
SLICE_SIZE = "HVDTPU_SLICE_SIZE"

# torchrun's per-rank environment
TORCHRUN_RANK = "RANK"
TORCHRUN_WORLD_SIZE = "WORLD_SIZE"
TORCHRUN_LOCAL_RANK = "LOCAL_RANK"
TORCHRUN_LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"
TORCHRUN_GROUP_RANK = "GROUP_RANK"
TORCHRUN_MASTER_ADDR = "MASTER_ADDR"
TORCHRUN_MASTER_PORT = "MASTER_PORT"

# Tensor fusion: grouped_allreduce and the eager engine fuse per dtype up to
# this many bytes (reference operations.cc:419 default of 64 MB).
FUSION_THRESHOLD = "HVDTPU_FUSION_THRESHOLD"
DEFAULT_FUSION_BYTES = 64 * 1024 * 1024

# The eager engine's knobs (horovod_tpu/utils/env.py:13-88, same names and
# defaults): cycle time in ms, the Chrome timeline, the stall inspector,
# the response cache's capacity, the two-level allreduce and its cross-leg
# wire, the online autotuner and schedule replay.
CYCLE_TIME = "HVDTPU_CYCLE_TIME"
TIMELINE = "HVDTPU_TIMELINE"
TIMELINE_MARK_CYCLES = "HVDTPU_TIMELINE_MARK_CYCLES"
STALL_CHECK_TIME = "HVDTPU_STALL_CHECK_TIME_SECONDS"
STALL_SHUTDOWN_TIME = "HVDTPU_STALL_SHUTDOWN_TIME_SECONDS"
STALL_CHECK_DISABLE = "HVDTPU_STALL_CHECK_DISABLE"
CACHE_CAPACITY = "HVDTPU_CACHE_CAPACITY"
HIERARCHICAL_ALLREDUCE = "HVDTPU_HIERARCHICAL_ALLREDUCE"
DCN_COMPRESSION = "HVDTPU_DCN_COMPRESSION"
AUTOTUNE = "HVDTPU_AUTOTUNE"
AUTOTUNE_LOG = "HVDTPU_AUTOTUNE_LOG"
AUTOTUNE_WARMUP_SAMPLES = "HVDTPU_AUTOTUNE_WARMUP_SAMPLES"
AUTOTUNE_STEPS_PER_SAMPLE = "HVDTPU_AUTOTUNE_STEPS_PER_SAMPLE"
AUTOTUNE_BAYES_OPT_MAX_SAMPLES = "HVDTPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES"
AUTOTUNE_GP_NOISE = "HVDTPU_AUTOTUNE_GAUSSIAN_PROCESS_NOISE"
AUTOTUNE_DRIFT_THRESHOLD = "HVDTPU_AUTOTUNE_DRIFT_THRESHOLD"
AUTOTUNE_DRIFT_SAMPLES = "HVDTPU_AUTOTUNE_DRIFT_SAMPLES"
SCHEDULE_REPLAY = "HVDTPU_SCHEDULE_REPLAY"
SCHEDULE_REPLAY_CYCLES = "HVDTPU_SCHEDULE_REPLAY_CYCLES"
DEFAULT_REPLAY_CYCLES = 50
# Logging (utils/logging.py)
LOG_LEVEL = "HVDTPU_LOG_LEVEL"

# Observability planes (obs/, horovod_tpu/utils/env.py:75-120, 181-187):
# the per-rank metrics dump target (a dir, a {rank} template or a plain
# path that gets a rank tag); the live stream's snapshot period in seconds
# and its KV endpoint (the elastic store's when unset); the straggler
# alert threshold in ms; the flight recorder's dump target and ring
# capacity; the span dump target, sample rate and ring capacity.  The
# sample verdict is a pure function of the trace id, so every rank and the
# launcher reach the same one.
METRICS_DUMP = "HVDTPU_METRICS_DUMP"
LIVE_STATS = "HVDTPU_LIVE_STATS_SECS"
LIVE_KV = "HVDTPU_LIVE_KV"
ALERT_SKEW = "HVDTPU_ALERT_SKEW_MS"
FLIGHTREC_DUMP = "HVDTPU_FLIGHTREC_DUMP"
FLIGHTREC_CAPACITY = "HVDTPU_FLIGHTREC_CAPACITY"
TRACE = "HVDTPU_TRACE"
TRACE_SAMPLE_RATE = "HVDTPU_TRACE_SAMPLE_RATE"
TRACE_CAPACITY = "HVDTPU_TRACE_CAPACITY"
# Training-health plane (obs/health.py, obs/divergence.py): HEALTH arms
# the step's numerics bundle and the anomaly judge ("on"/"off", default
# off: off leaves the step as it was); HEALTH_CHECK_STEPS is the
# divergence sentinel's cadence (default 100); DIVERGENCE_ACTION is what a
# confirmed divergence does: warn | dump | halt.  Fleet-wide: the
# sentinel's exchange is a collective, so every rank derives the same
# cadence and action.
HEALTH = "HVDTPU_HEALTH"
HEALTH_CHECK_STEPS = "HVDTPU_HEALTH_CHECK_STEPS"
DIVERGENCE_ACTION = "HVDTPU_DIVERGENCE_ACTION"

# Sharded checkpoint + peer-replica recovery tier (ckpt/,
# horovod_tpu/utils/env.py:97-109): CKPT_DIR is the sharded-manifest
# directory the elastic State saves to and falls back to on restore when
# no live peer holds a valid replica; CKPT_REPLICA turns on the replica
# push after every commit (chunked at CKPT_REPLICA_CHUNK_KB over the
# signed KV path); CKPT_COMMIT_TIMEOUT bounds the manifest-commit wait.
CKPT_DIR = "HVDTPU_CKPT_DIR"
CKPT_REPLICA = "HVDTPU_CKPT_REPLICA"
CKPT_REPLICA_CHUNK_KB = "HVDTPU_CKPT_REPLICA_CHUNK_KB"
DEFAULT_REPLICA_CHUNK_KB = 1024
CKPT_COMMIT_TIMEOUT = "HVDTPU_CKPT_COMMIT_TIMEOUT_SECS"
DEFAULT_CKPT_COMMIT_TIMEOUT = 120.0

# Which eager engine (``_engine_registry``): auto / python / native (the C++
# engine, runtime/native.py); MESH_ADDR overrides the address the native
# engine's TCP mesh advertises for this host.
EAGER_ENGINE = "HVDTPU_EAGER_ENGINE"
MESH_ADDR = "HVDTPU_MESH_ADDR"

# Backward-overlap plane (optim/overlap.py): the gradient bucket cap in MB
# and the default overlap mode of the bench (horovod_tpu/utils/env.py:58-60).
GRAD_BUCKET_MB = "HVDTPU_GRAD_BUCKET_MB"
DEFAULT_GRAD_BUCKET_MB = 16.0
OVERLAP = "HVDTPU_OVERLAP"


# Serving plane (serve/, horovod_tpu/utils/env.py:121-167): the fleet-wide
# model geometry and policies ``hvdrun --elastic --serve`` forwards to every
# serving rank (``python -m horovod_tpu_torch.serve`` reads them as flag
# fallbacks).  SERVE_SEED must be identical on every rank: the replicated
# weights and the sampler's keys rest on it.  SERVE_OUT_TTL bounds how long
# the ingest pump keeps a finished request's compacted result doc.
SERVE_MODEL = "HVDTPU_SERVE_MODEL"
SERVE_SLOTS = "HVDTPU_SERVE_SLOTS"
SERVE_MAX_LEN = "HVDTPU_SERVE_MAX_LEN"
SERVE_SEED = "HVDTPU_SERVE_SEED"
SERVE_KV_MODE = "HVDTPU_SERVE_KV_MODE"
SERVE_PAGE_SIZE = "HVDTPU_SERVE_PAGE_SIZE"
SERVE_KV_PAGES = "HVDTPU_SERVE_KV_PAGES"
SERVE_WIDTH = "HVDTPU_SERVE_WIDTH"
SERVE_WEIGHTS_DIR = "HVDTPU_SERVE_WEIGHTS_DIR"
SERVE_SWAP_POLL_STEPS = "HVDTPU_SERVE_SWAP_POLL_STEPS"
SERVE_OUT_TTL = "HVDTPU_SERVE_OUT_TTL_SECS"
DEFAULT_SERVE_OUT_TTL = 300.0
SERVE_FRONTENDS = "HVDTPU_SERVE_FRONTENDS"
SERVE_TENANT_BUDGET = "HVDTPU_SERVE_TENANT_BUDGET"
SERVE_SLO_CLASS = "HVDTPU_SERVE_SLO_CLASS"
SERVE_SLO_TTFT_MS = "HVDTPU_SERVE_SLO_TTFT_MS"
SERVE_SLO_TPOT_MS = "HVDTPU_SERVE_SLO_TPOT_MS"
SERVE_SLO_OBJECTIVE = "HVDTPU_SERVE_SLO_OBJECTIVE"
# Autoscale (serve/autoscale.py): launcher-local knobs, carried as env so
# config files can set them.  The envelope ceiling MAX_WORKERS also sizes
# the launcher's slot allocation (standby ranks need a host the moment a
# grow admits them).
SERVE_AUTOSCALE = "HVDTPU_SERVE_AUTOSCALE"
MAX_WORKERS = "HVDTPU_MAX_WORKERS"
SCALE_UP_QUEUE = "HVDTPU_SCALE_UP_QUEUE"
SCALE_DOWN_IDLE_SECS = "HVDTPU_SCALE_DOWN_IDLE_SECS"
SCALE_COOLDOWN_SECS = "HVDTPU_SCALE_COOLDOWN_SECS"


def env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def env_float(name: str, default: float) -> float:
    value = os.environ.get(name)
    return float(value) if value not in (None, "") else default


def env_bool(name: str, default: bool = False) -> bool:
    value = os.environ.get(name)
    if value in (None, ""):
        return default
    return value.lower() in ("1", "true", "yes", "on")


def resolve_rank(default=None):
    """This process's rank per the launcher env contract: ``HVDTPU_RANK``
    (static jobs) first, then ``HVDTPU_ELASTIC_RANK`` (elastic workers);
    the fault injector reads it (horovod_tpu/utils/env.py:190-199)."""
    for name in (RANK, "HVDTPU_ELASTIC_RANK"):
        value = os.environ.get(name)
        if value not in (None, ""):
            return int(value)
    return default


# The launcher inherits the job's dump env but has no rank, so an
# env-driven dump there would resolve to rank 0 and overwrite worker rank
# 0's file.  Launchers mark themselves here; their artifacts take the tag
# "launcher", which the aggregators skip.
_is_launcher = False


def mark_launcher() -> None:
    global _is_launcher
    _is_launcher = True


def artifact_rank() -> str:
    """The rank tag of this process's per-rank artifacts (metrics, flight
    recorder, spans): the resolved rank for a worker, ``launcher`` for a
    marked launcher.  A rank in the env wins over the mark."""
    rank = resolve_rank(None)
    if rank is None and _is_launcher:
        return "launcher"
    return str(rank if rank is not None else 0)
