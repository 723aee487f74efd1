"""CLI-args <-> env-var mapping and YAML config layering (a copy of
``horovod_tpu/run/config_parser.py``).

Reference: horovod/run/common/util/config_parser.py (set_env_from_args,
args<->yaml key maps) and runner.py:163-218,446-450 (the override-action
trick: explicit CLI flags win over the config file, which wins over
defaults)."""

from __future__ import annotations

import argparse
from typing import Dict, Optional

from ..utils import env as envmod

# arg attribute -> (env var, yaml section.key)
_ARG_ENV_MAP = {
    "fusion_threshold_mb": (envmod.FUSION_THRESHOLD, "params.fusion-threshold-mb"),
    "cycle_time_ms": (envmod.CYCLE_TIME, "params.cycle-time-ms"),
    "cache_capacity": (envmod.CACHE_CAPACITY, "params.cache-capacity"),
    "hierarchical_allreduce": (
        envmod.HIERARCHICAL_ALLREDUCE,
        "params.hierarchical-allreduce",
    ),
    "num_slices": (envmod.NUM_SLICES, "params.num-slices"),
    "dcn_compression": (envmod.DCN_COMPRESSION, "params.dcn-compression"),
    # --no-schedule-replay writes "0" into the positive env knob (see
    # the inversion in set_env_from_args): one env var, default-on.
    "no_schedule_replay": (envmod.SCHEDULE_REPLAY, "params.no-schedule-replay"),
    "schedule_replay_cycles": (
        envmod.SCHEDULE_REPLAY_CYCLES,
        "params.schedule-replay-cycles",
    ),
    "ckpt_dir": (envmod.CKPT_DIR, "checkpoint.dir"),
    "ckpt_replica": (envmod.CKPT_REPLICA, "checkpoint.replica"),
    "ckpt_replica_chunk_kb": (
        envmod.CKPT_REPLICA_CHUNK_KB,
        "checkpoint.replica-chunk-kb",
    ),
    "ckpt_commit_timeout_secs": (
        envmod.CKPT_COMMIT_TIMEOUT,
        "checkpoint.commit-timeout-secs",
    ),
    "metrics_dump": (envmod.METRICS_DUMP, "metrics.dump"),
    "flightrec_dump": (envmod.FLIGHTREC_DUMP, "metrics.flightrec-dump"),
    "live_stats_secs": (envmod.LIVE_STATS, "metrics.live-stats-secs"),
    "alert_skew_ms": (envmod.ALERT_SKEW, "metrics.alert-skew-ms"),
    "trace": (envmod.TRACE, "trace.target"),
    "trace_sample_rate": (envmod.TRACE_SAMPLE_RATE, "trace.sample-rate"),
    "timeline_filename": (envmod.TIMELINE, "timeline.filename"),
    "timeline_mark_cycles": (envmod.TIMELINE_MARK_CYCLES, "timeline.mark-cycles"),
    "no_stall_check": (envmod.STALL_CHECK_DISABLE, "stall-check.disable"),
    "stall_check_warning_time_seconds": (
        envmod.STALL_CHECK_TIME,
        "stall-check.warning-time-seconds",
    ),
    "stall_check_shutdown_time_seconds": (
        envmod.STALL_SHUTDOWN_TIME,
        "stall-check.shutdown-time-seconds",
    ),
    "autotune": (envmod.AUTOTUNE, "autotune.enabled"),
    "autotune_log_file": (envmod.AUTOTUNE_LOG, "autotune.log-file"),
    "autotune_warmup_samples": (
        envmod.AUTOTUNE_WARMUP_SAMPLES,
        "autotune.warmup-samples",
    ),
    "autotune_steps_per_sample": (
        envmod.AUTOTUNE_STEPS_PER_SAMPLE,
        "autotune.steps-per-sample",
    ),
    "autotune_bayes_opt_max_samples": (
        envmod.AUTOTUNE_BAYES_OPT_MAX_SAMPLES,
        "autotune.bayes-opt-max-samples",
    ),
    "autotune_gaussian_process_noise": (
        envmod.AUTOTUNE_GP_NOISE,
        "autotune.gaussian-process-noise",
    ),
    "autotune_drift_threshold": (
        envmod.AUTOTUNE_DRIFT_THRESHOLD,
        "autotune.drift-threshold",
    ),
    "autotune_drift_samples": (
        envmod.AUTOTUNE_DRIFT_SAMPLES,
        "autotune.drift-samples",
    ),
    "log_level": (envmod.LOG_LEVEL, "logging.level"),
    "serve_model": (envmod.SERVE_MODEL, "serve.model"),
    "serve_slots": (envmod.SERVE_SLOTS, "serve.slots"),
    "serve_max_len": (envmod.SERVE_MAX_LEN, "serve.max-len"),
    "serve_seed": (envmod.SERVE_SEED, "serve.seed"),
    "serve_kv_mode": (envmod.SERVE_KV_MODE, "serve.kv-mode"),
    "serve_page_size": (envmod.SERVE_PAGE_SIZE, "serve.page-size"),
    "serve_kv_pages": (envmod.SERVE_KV_PAGES, "serve.kv-pages"),
    "serve_width": (envmod.SERVE_WIDTH, "serve.width"),
    "serve_weights_dir": (envmod.SERVE_WEIGHTS_DIR, "serve.weights-dir"),
    "serve_swap_poll_steps": (
        envmod.SERVE_SWAP_POLL_STEPS,
        "serve.swap-poll-steps",
    ),
    "serve_frontends": (envmod.SERVE_FRONTENDS, "serve.frontends"),
    "serve_tenant_budget": (
        envmod.SERVE_TENANT_BUDGET,
        "serve.tenant-budget",
    ),
    "slo_ttft_ms": (envmod.SERVE_SLO_TTFT_MS, "serve.slo-ttft-ms"),
    "slo_tpot_ms": (envmod.SERVE_SLO_TPOT_MS, "serve.slo-tpot-ms"),
    "slo_objective": (envmod.SERVE_SLO_OBJECTIVE, "serve.slo-objective"),
    "slo_class": (envmod.SERVE_SLO_CLASS, "serve.slo-class"),
    "serve_autoscale": (envmod.SERVE_AUTOSCALE, "serve.autoscale"),
    "max_workers": (envmod.MAX_WORKERS, "serve.max-workers"),
    "scale_up_queue": (envmod.SCALE_UP_QUEUE, "serve.scale-up-queue"),
    "scale_down_idle_secs": (
        envmod.SCALE_DOWN_IDLE_SECS,
        "serve.scale-down-idle-secs",
    ),
    "scale_cooldown_secs": (
        envmod.SCALE_COOLDOWN_SECS,
        "serve.scale-cooldown-secs",
    ),
    "health": (envmod.HEALTH, "metrics.health"),
    "health_check_steps": (
        envmod.HEALTH_CHECK_STEPS,
        "metrics.health-check-steps",
    ),
    "divergence_action": (
        envmod.DIVERGENCE_ACTION,
        "metrics.divergence-action",
    ),
}

def set_env_from_args(env: Dict[str, str], args: argparse.Namespace) -> Dict[str, str]:
    """Write HVDTPU_* entries for every set arg (reference
    config_parser.set_env_from_args, called at runner.py:693-695)."""
    for attr, (env_name, _) in _ARG_ENV_MAP.items():
        value = getattr(args, attr, None)
        # `is`-checks: 0 is a legitimate explicit value (e.g.
        # --fusion-threshold-mb 0 disables fusion) and 0 == False in python.
        if value is None or value is False:
            continue
        if attr == "fusion_threshold_mb":
            value = int(value) * 1024 * 1024
        if attr == "no_schedule_replay":
            # negative flag onto the positive default-on env knob
            value = "0"
        if value is True:
            value = "1"
        env[env_name] = str(value)
    return env


class _StoreOverrideAction(argparse.Action):
    """Tracks which args the user set explicitly so config-file values
    don't clobber them (reference runner.py:163-218)."""

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, values)
        overrides = getattr(namespace, "_explicit_args", set())
        overrides.add(self.dest)
        namespace._explicit_args = overrides


class _StoreTrueOverrideAction(_StoreOverrideAction):
    def __init__(self, option_strings, dest, **kwargs):
        kwargs.pop("nargs", None)
        super().__init__(option_strings, dest, nargs=0, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        super().__call__(parser, namespace, True, option_string)


def apply_config_file(args: argparse.Namespace, path: Optional[str]) -> None:
    """Layer a YAML config under explicit CLI args (reference
    runner.py:446-450: `read_config_file` + `validate_config_args`)."""
    if not path:
        return
    import yaml  # noqa: PLC0415

    with open(path) as f:
        config = yaml.safe_load(f) or {}
    explicit = getattr(args, "_explicit_args", set())
    for attr, (_, yaml_key) in _ARG_ENV_MAP.items():
        section, key = yaml_key.split(".")
        if section in config and key in (config[section] or {}):
            if attr not in explicit:
                setattr(args, attr, config[section][key])
