"""`hvdrun` CLI of the port (counterpart of ``horovod_tpu/run/runner.py``;
reference: horovod/run/runner.py:221-452 arg surface, bin/horovodrun).

Usage::

    python -m horovod_tpu_torch.run -np 4 python train.py
    python -m horovod_tpu_torch.run -np 8 -H host1:4,host2:4 python train.py
    python -m horovod_tpu_torch.run --elastic -np 2 --ckpt-replica \\
        python train.py

Static jobs: every slot gets the ``HVDTPU_*`` rendezvous environment
(rank, size, local and cross coordinates, and the coordinator address),
and ``horovod_tpu_torch.init()`` in each worker opens the
``torch.distributed`` world on it: NCCL on ``cuda:local_rank``, or gloo
with ``device="cpu"``.  Elastic jobs (``--elastic``): the workers meet in
the launcher's KV store (``elastic/context.py``), which detects failures,
blacklists hosts and respawns ranks into a re-minted epoch.

Every runtime knob maps onto an ``HVDTPU_*`` env var for all ranks
(``config_parser.py``); a YAML ``--config-file`` layers under explicit CLI
flags.  ``--serve`` (which implies ``--elastic``) runs a serving fleet:
the launcher's front door ingests client requests into the store, and each
rank runs ``python -m horovod_tpu_torch.serve`` unless a command is given.
``--discover-nics`` prints the interfaces every host can reach.  The
observability planes' flags (``--metrics-dump``, ``--flightrec-dump``,
``--stats-summary``, ``--live-*``, ``--trace``, ``--health``, ...) arm
them in every rank and in the launcher, which merges the traces, prints
the summary and, after a failure, the post-mortem verdict.
``--serve-autoscale`` grows and shrinks a serving fleet between
``--min-workers`` and ``--max-workers`` from the live plane's queue and
TTFT gauges (``serve/autoscale.py``), through re-minted epochs.
"""

from __future__ import annotations

import argparse
import os
import pickle
import socket
import sys
import time
from typing import Dict, List, Optional

from ..utils import env as envmod
from ..utils.logging import get_logger
from . import config_parser
from .allocate import SlotInfo, allocate, is_local_host, parse_hostfile, \
    parse_hosts
from .blacklist import HostBlacklist
from .config_parser import _StoreOverrideAction, _StoreTrueOverrideAction
from .exec import ProcessSet, make_ssh_command

LOG = get_logger("run")

# Fixed default for remote coordinators, where the launcher cannot probe a
# free port on the target host; overridable with --coordinator-port.
DEFAULT_COORDINATOR_PORT = 29500

# env families that travel to a remote rank over ssh: the launcher's own
# and the ones torch, CUDA and NCCL read
TRAVEL_ENV = ("HVDTPU_", "CUDA_", "NCCL_", "TORCH_")

__all__ = ["parse_args", "check_build", "discover_nics",
           "build_slot_env", "launch_job", "launch_elastic_job",
           "ElasticJobResult", "main"]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="hvdrun",
        description=(
            "Launch a horovod_tpu_torch distributed job: one process per "
            "slot (one GPU each), wired to a torch.distributed world."
        ),
    )
    parser.add_argument("-v", "--version", action="store_true", dest="version")
    parser.add_argument(
        "-np", "--num-proc", type=int, dest="np",
        help="Total number of worker processes.",
    )
    parser.add_argument(
        "-H", "--hosts", action=_StoreOverrideAction, dest="hosts",
        help='Host list with slots, e.g. "h1:2,h2:2". Default: localhost '
             "with np slots.",
    )
    parser.add_argument(
        "-hostfile", "--hostfile", action=_StoreOverrideAction, dest="hostfile",
        help='Hostfile with lines "hostname slots=N".',
    )
    parser.add_argument(
        "--ssh-port", type=int, action=_StoreOverrideAction, dest="ssh_port"
    )
    parser.add_argument(
        "--coordinator-port", type=int, action=_StoreOverrideAction,
        dest="coordinator_port", default=None,
        help=f"Port of the torch.distributed TCP store on the first host "
             f"(default: probe a free port locally, {DEFAULT_COORDINATOR_PORT} "
             f"when the first host is remote).",
    )
    parser.add_argument(
        "--start-timeout", type=int, action=_StoreOverrideAction,
        dest="start_timeout", default=None,
        help="Seconds each rank waits for the whole world to form "
             "(HVDTPU_START_TIMEOUT, the init_process_group timeout; "
             "default 300).",
    )
    parser.add_argument(
        "--config-file", action=_StoreOverrideAction, dest="config_file"
    )
    parser.add_argument(
        "--check-build", action="store_true", dest="check_build",
        help="Print the capability report and exit (reference "
             "runner.py:115-150).",
    )
    parser.add_argument(
        "--discover-nics", action="store_true", dest="discover_nics",
        help="Start a task server on every host (-H/--hostfile), ring-probe "
             "interface reachability, print the NICs usable by every host, "
             "and exit (reference driver/task NIC discovery, "
             "driver_service.py:128-197).",
    )
    parser.add_argument("--verbose", action="store_true", dest="verbose")

    elastic = parser.add_argument_group("elastic fault tolerance")
    elastic.add_argument(
        "--elastic", action="store_true", dest="elastic",
        help="Launch in elastic mode: per-rank failure detection, host "
             "blacklisting, bounded respawn into a re-minted rendezvous "
             "epoch (workers use the horovod_tpu_torch.elastic API).",
    )
    elastic.add_argument(
        "--min-workers", type=int, action=_StoreOverrideAction,
        dest="min_workers", default=None,
        help="Smallest world the elastic job may shrink to once the "
             "respawn budget is spent (default: np — never shrink).",
    )
    elastic.add_argument(
        "--max-workers", type=int, action=_StoreOverrideAction,
        dest="max_workers", default=None,
        help="Largest world the job may grow to (default: np).  Ranks "
             "np..max_workers-1 are standby slots the autoscale "
             "controller can admit under load; the host list must "
             "carry slots for all of them.",
    )
    elastic.add_argument(
        "--max-elastic-retries", type=int, action=_StoreOverrideAction,
        dest="max_elastic_retries", default=None,
        help="Total failed-rank respawns across the job (default 3).",
    )
    elastic.add_argument(
        "--blacklist-cooldown-secs", type=float,
        action=_StoreOverrideAction,
        dest="blacklist_cooldown_secs", default=None,
        help="Base host-blacklist cooldown; doubles per repeat failure "
             "(default 10).",
    )
    elastic.add_argument(
        "--progress-timeout-secs", type=float,
        action=_StoreOverrideAction,
        dest="progress_timeout_secs", default=None,
        help="Steady-state progress-beat budget: a rank whose process "
             "heartbeat lives but whose collectives-completed counter "
             "has not advanced for this long is declared deadlocked and "
             "respawned (default 300; 0 disables).",
    )
    elastic.add_argument(
        "--progress-grace-secs", type=float,
        action=_StoreOverrideAction,
        dest="progress_grace_secs", default=None,
        help="The same budget while the worker reports an init/compile "
             "phase (default 0 = never kill during those phases).",
    )
    elastic.add_argument(
        "--dump-grace-secs", type=float,
        action=_StoreOverrideAction,
        dest="dump_grace_secs", default=None,
        help="When the monitor kills a hung rank (heartbeat/progress "
             "lost), send SIGUSR1+SIGTERM first so its flight recorder "
             "can dump, and SIGKILL only after this many seconds "
             "(default 5; 0 = immediate SIGKILL, no black box).",
    )
    parser.add_argument(
        "--output-filename", action=_StoreOverrideAction,
        dest="output_filename", default=None,
        help="Also write every rank's output to "
             "<output_filename>/rank.<rank>/<stdout|stderr> (rank "
             "zero-padded; reference gloo_run.py:204-217).",
    )

    params = parser.add_argument_group("tunable parameters")
    params.add_argument(
        "--fusion-threshold-mb", type=int, action=_StoreOverrideAction,
        dest="fusion_threshold_mb", default=None,
    )
    params.add_argument(
        "--cycle-time-ms", type=float, action=_StoreOverrideAction,
        dest="cycle_time_ms", default=None,
    )
    params.add_argument(
        "--cache-capacity", type=int, action=_StoreOverrideAction,
        dest="cache_capacity", default=None,
    )
    params.add_argument(
        "--hierarchical-allreduce", action=_StoreTrueOverrideAction,
        dest="hierarchical_allreduce", default=None,
        help="Pin the eager engine's two-level allreduce on.",
    )
    params.add_argument(
        "--num-slices", type=int, action=_StoreOverrideAction,
        dest="num_slices", default=None,
        help="Slice partition of the world: that many contiguous equal "
             "blocks of ranks.  Must divide -np.",
    )
    params.add_argument(
        "--dcn-compression", action=_StoreOverrideAction,
        dest="dcn_compression", default=None,
        choices=["none", "bf16", "fp16"],
        help="Wire dtype of the cross leg of the two-level allreduce "
             "(default none).",
    )
    params.add_argument(
        "--no-schedule-replay", action=_StoreTrueOverrideAction,
        dest="no_schedule_replay", default=None,
        help="Disable the eager engine's steady-state schedule replay.",
    )
    params.add_argument(
        "--schedule-replay-cycles", type=int, action=_StoreOverrideAction,
        dest="schedule_replay_cycles", default=None,
        help="Consecutive bitwise-identical cycles before a replay "
             "epoch opens (default 50).",
    )

    serve = parser.add_argument_group("serving")
    serve.add_argument(
        "--serve", action="store_true", dest="serve",
        help="Serving mode: implies --elastic, arms the request ingest "
             "front door on the rendezvous store (clients submit over the "
             "signed KV protocol, horovod_tpu_torch.serve.ServeClient), and "
             "defaults the worker command to `python -m "
             "horovod_tpu_torch.serve` — a continuous-batching inference "
             "fleet where a dead rank respawns and replays its in-flight "
             "requests instead of dropping traffic.",
    )
    for flag, kind, help_ in (
            ("--serve-model", str, "gpt() model family entry every serving "
             "rank builds (HVDTPU_SERVE_MODEL, default nano)."),
            ("--serve-slots", int, "Decode slot pool size per rank — the "
             "max simultaneous in-flight requests (HVDTPU_SERVE_SLOTS, "
             "default 4)."),
            ("--serve-max-len", int, "Slot KV-cache length in tokens "
             "(HVDTPU_SERVE_MAX_LEN; default: the model's max_len)."),
            ("--serve-seed", int, "Weights init seed AND the per-request "
             "sampling root — identical on every rank by construction "
             "(HVDTPU_SERVE_SEED, default 0)."),
            ("--serve-page-size", int, "KV page size in token rows "
             "(HVDTPU_SERVE_PAGE_SIZE, default 16)."),
            ("--serve-kv-pages", int, "KV page-pool size "
             "(HVDTPU_SERVE_KV_PAGES; default: the worst case, slots x "
             "pages-per-slot).  Admission capacity is judged in free "
             "pages."),
            ("--serve-weights-dir", str, "Weight hot-swap source "
             "(HVDTPU_SERVE_WEIGHTS_DIR): a sharded-checkpoint directory "
             "versions are published into "
             "(horovod_tpu_torch.serve.publish_weights).  The fleet polls "
             "it between decode steps and flips on a version-stamped step; "
             "a failed or dying swap rolls the whole fleet back."),
            ("--serve-swap-poll-steps", int, "Serving steps between "
             "hot-swap manifest polls (HVDTPU_SERVE_SWAP_POLL_STEPS, "
             "default 16)."),
            ("--serve-tenant-budget", int, "Tenant-aware admission "
             "(HVDTPU_SERVE_TENANT_BUDGET, default off = plain FCFS): "
             "per-tenant token budget per scheduling window."),
            ("--slo-ttft-ms", float, "Time-to-first-token SLO ceiling in "
             "ms for --slo-class requests (HVDTPU_SERVE_SLO_TTFT_MS)."),
            ("--slo-tpot-ms", float, "Per-output-token SLO ceiling in ms "
             "for --slo-class requests (HVDTPU_SERVE_SLO_TPOT_MS)."),
            ("--slo-objective", float, "Fraction of requests that must "
             "meet the SLO ceilings (HVDTPU_SERVE_SLO_OBJECTIVE, default "
             "0.99)."),
            ("--slo-class", str, "Which SLO class the ceilings apply to "
             "(HVDTPU_SERVE_SLO_CLASS, default interactive).")):
        serve.add_argument(flag, type=kind, action=_StoreOverrideAction,
                           dest=flag[2:].replace("-", "_"), default=None,
                           help=help_)
    serve.add_argument(
        "--serve-kv-mode", action=_StoreOverrideAction,
        dest="serve_kv_mode", default=None, choices=["paged", "contiguous"],
        help="KV cache layout (HVDTPU_SERVE_KV_MODE, default paged).",
    )
    serve.add_argument(
        "--frontends", type=int, action=_StoreOverrideAction,
        dest="serve_frontends", default=None,
        help="Front-door shard count F (HVDTPU_SERVE_FRONTENDS, default "
             "1): F launcher-resident ingest pumps each own the "
             "request-log partition crc32(rid) %% F; clients route by the "
             "same hash.  A dead frontend's shards are adopted by the "
             "lowest survivor and the serving epoch is re-minted.",
    )
    serve.add_argument(
        "--serve-width", type=int, action=_StoreOverrideAction,
        dest="serve_width", default=None,
        help="Width-sharded serving fleet (HVDTPU_SERVE_WIDTH, default "
             "0 = replicated standbys): the world splits into np//width "
             "serving groups, each serving its partition of the request "
             "log; above 1 the ranks of a group hold one Megatron shard "
             "each of the model (one GPU per rank) and decode together "
             "over a torch.distributed group re-formed every epoch.",
    )
    serve.add_argument(
        "--serve-autoscale", action=_StoreTrueOverrideAction,
        dest="serve_autoscale", default=None,
        help="Load-driven autoscaling: the launcher watches the "
             "serve.queue_depth/serve.ttft_ms gauges the live plane "
             "aggregates and grows/shrinks the fleet between "
             "--min-workers and --max-workers through deliberately "
             "re-minted rendezvous epochs — in-flight requests replay, "
             "none is dropped.  Implies live stats at 0.5s when "
             "--live-stats-secs is unset.",
    )
    serve.add_argument(
        "--scale-up-queue", type=int, action=_StoreOverrideAction,
        dest="scale_up_queue", default=None,
        help="Queue-depth high-water mark: grow one worker when the "
             "queue stays at/above this for the hysteresis window "
             "(default 4).",
    )
    serve.add_argument(
        "--scale-down-idle-secs", type=float, action=_StoreOverrideAction,
        dest="scale_down_idle_secs", default=None,
        help="Release one worker after the fleet has been fully "
             "drained (empty queue, no active slot) this long "
             "(default 10).",
    )
    serve.add_argument(
        "--scale-cooldown-secs", type=float, action=_StoreOverrideAction,
        dest="scale_cooldown_secs", default=None,
        help="Minimum seconds between resizes in either direction "
             "(flap guard, default 15).  Failed grows also back off "
             "exponentially.",
    )

    ckpt = parser.add_argument_group("checkpointing")
    ckpt.add_argument(
        "--ckpt-dir", action=_StoreOverrideAction, dest="ckpt_dir",
        default=None,
        help="Sharded-checkpoint directory (HVDTPU_CKPT_DIR): every "
             "rank writes only its own shard; rank 0 commits the "
             "manifest last; elastic State.sync falls back to the "
             "newest valid manifest here when no live peer replica "
             "exists.",
    )
    ckpt.add_argument(
        "--ckpt-replica", action=_StoreTrueOverrideAction,
        dest="ckpt_replica", default=None,
        help="Peer-replica recovery tier: after every State.commit "
             "each rank pushes its committed snapshot to its replica key "
             "over the HMAC-signed KV path, so a respawned rank restores "
             "from a live copy instead of from disk.",
    )
    ckpt.add_argument(
        "--ckpt-replica-chunk-kb", type=int, action=_StoreOverrideAction,
        dest="ckpt_replica_chunk_kb", default=None,
        help="Replica push chunk size in KiB (default 1024).",
    )
    ckpt.add_argument(
        "--ckpt-commit-timeout-secs", type=float,
        action=_StoreOverrideAction,
        dest="ckpt_commit_timeout_secs", default=None,
        help="Seconds each rank waits for the sharded manifest to "
             "commit (default 120).",
    )

    timeline = parser.add_argument_group("timeline")
    timeline.add_argument(
        "--timeline-filename", action=_StoreOverrideAction,
        dest="timeline_filename", default=None,
        help="Per-rank Chrome trace of the eager engine: each rank writes "
             "its own file derived from this value (template with "
             "{rank}, directory, or plain path getting a rank tag).",
    )
    timeline.add_argument(
        "--timeline-mark-cycles", action=_StoreTrueOverrideAction,
        dest="timeline_mark_cycles", default=None,
    )

    obs_group = parser.add_argument_group("observability")
    obs_group.add_argument(
        "--metrics-dump", action=_StoreOverrideAction,
        dest="metrics_dump", default=None,
        help="Per-rank metrics dump target (HVDTPU_METRICS_DUMP): a "
             "directory, a {rank} template, or a plain path that gets a "
             "rank tag inserted.",
    )
    obs_group.add_argument(
        "--flightrec-dump", action=_StoreOverrideAction,
        dest="flightrec_dump", default=None,
        help="Per-rank flight-recorder dump target "
             "(HVDTPU_FLIGHTREC_DUMP): same dir/{rank}/plain-path forms "
             "as --metrics-dump.  Unset, the launcher still arms a "
             "temporary black-box dir so a crashed job gets a "
             "post-mortem; set it to keep the per-rank rings after "
             "clean runs too.",
    )
    obs_group.add_argument(
        "--stats-summary", action="store_true", dest="stats_summary",
        help="After the job ends, aggregate every rank's metrics dump "
             "into one per-rank summary table on stdout (implies a "
             "temporary --metrics-dump when none is given).",
    )
    obs_group.add_argument(
        "--live-stats-secs", type=float, action=_StoreOverrideAction,
        dest="live_stats_secs", default=None,
        help="Stream each rank's metrics to the launcher every N "
             "seconds (default off): one-line console digests, a "
             "crash-safe live_history.jsonl, and a read-only Prometheus "
             "GET /metrics endpoint on the launcher's KV port.",
    )
    obs_group.add_argument(
        "--live-port", type=int, action=_StoreOverrideAction,
        dest="live_port", default=None,
        help="Fixed port for the live telemetry KV/scrape server in "
             "non-elastic jobs (default: ephemeral, announced on "
             "stdout).  Elastic jobs serve /metrics from the existing "
             "rendezvous port.",
    )
    obs_group.add_argument(
        "--live-history-file", action=_StoreOverrideAction,
        dest="live_history_file", default=None,
        help="Where the launcher appends one JSON line per live "
             "aggregation round (default: ./live_history.jsonl while "
             "--live-stats-secs is on).",
    )
    obs_group.add_argument(
        "--alert-skew-ms", type=float, action=_StoreOverrideAction,
        dest="alert_skew_ms", default=None,
        help="Warn (and count engine.straggler.alerts) when a "
             "collective's first-to-last rank arrival skew exceeds this "
             "many milliseconds (default 0 = accumulate silently).",
    )
    obs_group.add_argument(
        "--trace", action=_StoreOverrideAction, dest="trace",
        default=None, metavar="TARGET",
        help="Request-level distributed tracing (HVDTPU_TRACE): each "
             "rank dumps its span ring to a file derived from TARGET "
             "(directory, {rank} template, or plain path getting a "
             "rank tag).  At job end the launcher merges every rank's "
             "spans (its own ingest-side spans included) into a "
             "per-request Chrome-trace waterfall plus a ttft/tpot "
             "latency-decomposition report.",
    )
    obs_group.add_argument(
        "--trace-sample-rate", type=float, action=_StoreOverrideAction,
        dest="trace_sample_rate", default=None,
        help="Fraction of requests traced (HVDTPU_TRACE_SAMPLE_RATE, "
             "default 1.0).  The verdict is a pure function of the "
             "request id, so every rank samples the identical set.",
    )
    obs_group.add_argument(
        "--health", choices=("on", "off"), action=_StoreOverrideAction,
        dest="health", default=None,
        help="Training-health plane (HVDTPU_HEALTH, default off): "
             "per-step numerics bundle (loss, per-bucket grad "
             "norms, update/param ratio, nonfinite counts) + EWMA "
             "anomaly alerts, and the cross-rank divergence sentinel. "
             "Off leaves the training step as it was.",
    )
    obs_group.add_argument(
        "--health-check-steps", type=int, action=_StoreOverrideAction,
        dest="health_check_steps", default=None,
        help="Divergence-sentinel cadence (HVDTPU_HEALTH_CHECK_STEPS, "
             "default 100): every N steps each rank allgathers a tiny "
             "bitwise digest of params/optimizer state/PRNG key and "
             "all ranks compare — the runtime check of the bitwise-"
             "replication invariant.",
    )
    obs_group.add_argument(
        "--divergence-action", choices=("warn", "dump", "halt"),
        action=_StoreOverrideAction, dest="divergence_action",
        default=None,
        help="What a confirmed cross-rank divergence does "
             "(HVDTPU_DIVERGENCE_ACTION, default warn): warn logs and "
             "alerts; dump additionally flushes the flight recorder "
             "and metrics immediately; halt raises on every rank — "
             "stop before the next checkpoint poisons every future "
             "restart.",
    )

    stall = parser.add_argument_group("stall check")
    stall.add_argument(
        "--no-stall-check", action=_StoreTrueOverrideAction,
        dest="no_stall_check", default=None,
    )
    stall.add_argument(
        "--stall-check-warning-time-seconds", type=int,
        action=_StoreOverrideAction,
        dest="stall_check_warning_time_seconds", default=None,
    )
    stall.add_argument(
        "--stall-check-shutdown-time-seconds", type=int,
        action=_StoreOverrideAction,
        dest="stall_check_shutdown_time_seconds", default=None,
    )

    autotune = parser.add_argument_group("autotune")
    autotune.add_argument(
        "--autotune", action=_StoreTrueOverrideAction, dest="autotune",
        default=None,
    )
    autotune.add_argument(
        "--autotune-log-file", action=_StoreOverrideAction,
        dest="autotune_log_file", default=None,
    )
    for flag, kind in (("--autotune-warmup-samples", int),
                       ("--autotune-steps-per-sample", int),
                       ("--autotune-bayes-opt-max-samples", int),
                       ("--autotune-gaussian-process-noise", float),
                       ("--autotune-drift-threshold", float),
                       ("--autotune-drift-samples", int)):
        autotune.add_argument(
            flag, type=kind, action=_StoreOverrideAction,
            dest=flag[2:].replace("-", "_"), default=None,
        )

    logging_group = parser.add_argument_group("logging")
    logging_group.add_argument(
        "--log-level", action=_StoreOverrideAction, dest="log_level",
        default=None,
        choices=["trace", "debug", "info", "warning", "error", "fatal"],
    )

    parser.add_argument(
        "command", nargs=argparse.REMAINDER,
        help="Command to run on every slot (e.g. python train.py).",
    )
    args = parser.parse_args(argv)
    config_parser.apply_config_file(args, getattr(args, "config_file", None))
    return args


def check_build() -> str:
    """Capability report (reference horovodrun --check-build): torch,
    CUDA, NCCL and gloo, and whether the CUDA kernels are built in this
    checkout."""
    import torch  # noqa: PLC0415
    import torch.distributed as dist  # noqa: PLC0415

    from .. import __version__  # noqa: PLC0415
    from ..ops import kernels  # noqa: PLC0415

    def mark(ok: bool) -> str:
        return "X" if ok else " "

    cuda = torch.cuda.is_available()
    nccl = dist.is_available() and dist.is_nccl_available()
    nccl_version = None
    if nccl and cuda:
        nccl_version = ".".join(map(str, torch.cuda.nccl.version()))
    built = kernels.built()
    gpus = [torch.cuda.get_device_name(i)
            for i in range(torch.cuda.device_count())] if cuda else []
    lines = [
        f"horovod_tpu_torch v{__version__}:",
        "",
        f"    torch {torch.__version__}, CUDA {torch.version.cuda}",
        f"    GPUs: {', '.join(gpus) if gpus else 'none visible'}",
        "",
        "Available backends:",
        f"    [{mark(nccl)}] NCCL"
        + (f" {nccl_version}" if nccl_version else ""),
        f"    [{mark(dist.is_available() and dist.is_gloo_available())}] "
        "gloo",
        "Available features:",
        f"    [{mark(cuda)}] CUDA device",
        f"    [{mark(all(built.values()))}] flash-attention kernels built "
        f"({sum(built.values())} of {len(built)} under "
        f"{kernels.build_dir()})",
        "    [X] eager per-op engine (negotiation, fusion, join, timeline)",
        "    [X] elastic launcher, KV rendezvous, checkpoint tiers",
        "    [X] serving plane (continuous-batching inference, --serve)",
    ]
    return "\n".join(lines)


def _pick_free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _resolve_host_slots(
    hosts: Optional[str], hostfile: Optional[str], default: str
):
    """hosts/hostfile/default cascade shared by the launchers and
    :func:`discover_nics` (reference hostfile/LSF resolution,
    runner.py:552-627)."""
    if hostfile:
        return parse_hostfile(hostfile)
    if hosts:
        return parse_hosts(hosts)
    return parse_hosts(default)


def _read_port_line(p, deadline: float) -> Optional[int]:
    """Read the HVDTPU_TASK_PORT= line with a real deadline — readline has
    no timeout, so it runs on a reaper thread joined with the remaining
    time (a hung ssh channel must not wedge discovery)."""
    import threading  # noqa: PLC0415

    result: List[Optional[int]] = [None]

    def reader():
        while True:
            line = p.stdout.readline()
            if not line:
                return
            if line.startswith(b"HVDTPU_TASK_PORT="):
                result[0] = int(line.strip().split(b"=", 1)[1])
                return

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    t.join(max(deadline - time.time(), 0.1))
    return result[0]


def discover_nics(
    hosts: Optional[str] = None,
    hostfile: Optional[str] = None,
    *,
    ssh_port: Optional[int] = None,
    timeout: float = 30.0,
) -> List[str]:
    """Start a task server on every job host, ring-probe reachability,
    return the interfaces usable by all (reference _run's NIC discovery,
    runner.py:552-627 + driver/driver_service.py:128-197)."""
    import subprocess  # noqa: PLC0415

    from . import driver_service as ds  # noqa: PLC0415

    host_slots = _resolve_host_slots(hosts, hostfile, "localhost:1")
    hostnames = [hs.hostname for hs in host_slots]

    key = ds.make_secret()
    server_cmd = [sys.executable, "-m", "horovod_tpu_torch.run.driver_service"]
    procs: List[subprocess.Popen] = []
    tasks: List[tuple] = []
    try:
        for host in hostnames:
            # Binary pipes throughout (like exec.py's ProcessSet.launch):
            # make_ssh_command returns bytes stdin_data, and mixing
            # text=True with bytes writes raises TypeError.
            if is_local_host(host):
                p = subprocess.Popen(
                    server_cmd,
                    env={**os.environ, "HVDTPU_NIC_SECRET": key},
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                )
            else:
                # The secret travels over the ssh channel's stdin
                # (SENSITIVE_ENV), never on the command line.
                cmd, stdin_data = make_ssh_command(
                    host, server_cmd, {"HVDTPU_NIC_SECRET": key}, ssh_port
                )
                p = subprocess.Popen(
                    cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                )
                if stdin_data:
                    p.stdin.write(stdin_data)
                    p.stdin.flush()
            procs.append(p)
        deadline = time.time() + timeout
        for host, p in zip(hostnames, procs):
            port = _read_port_line(p, deadline)
            if port is None:
                raise RuntimeError(f"task server on {host} did not report a port")
            tasks.append((host if not is_local_host(host) else "127.0.0.1",
                          port))
        return ds.discover_common_interfaces(tasks, key)
    finally:
        for p in procs:
            try:
                p.stdin.close()  # task server exits on stdin EOF
            except OSError:
                pass
            try:
                p.terminate()
            except OSError:
                pass
        for p in procs:
            # Reap: without wait() a long-lived caller of the Python API
            # accumulates zombies (the CLI path exits so it never noticed).
            try:
                p.wait(timeout=2.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            except OSError:
                pass


def build_slot_env(
    slot: SlotInfo,
    coordinator: str,
    base_env: Dict[str, str],
) -> Dict[str, str]:
    """Per-slot environment (reference gloo_run.py:143-165,257-269:
    HOROVOD_RANK/SIZE/..., rendezvous addr/port)."""
    env = dict(base_env)
    env.update(
        {
            "HVDTPU_RANK": str(slot.rank),
            "HVDTPU_SIZE": str(slot.size),
            "HVDTPU_LOCAL_RANK": str(slot.local_rank),
            "HVDTPU_LOCAL_SIZE": str(slot.local_size),
            "HVDTPU_CROSS_RANK": str(slot.cross_rank),
            "HVDTPU_CROSS_SIZE": str(slot.cross_size),
            "HVDTPU_COORDINATOR": coordinator,
        }
    )
    return env


def _maybe_start_live_plane(
    base_env: Dict[str, str],
    np: int,
    *,
    kv_server=None,
    kv_addr: Optional[str] = None,
    live_stats_secs: Optional[float] = None,
    live_port: Optional[int] = None,
    live_history: Optional[str] = None,
    bind_all: bool = False,
    announce_host: Optional[str] = None,
):
    """Start the launcher half of the live telemetry plane when
    ``--live-stats-secs`` (or the env) enables it; returns
    ``(LivePlane, owned_server)`` or ``(None, None)``.

    The interval resolves from ``base_env`` — the SAME source the
    spawned workers read — never from the launcher's own os.environ: an
    env-dict override must arm both halves or neither (workers
    streaming into a store nobody drains would grow launcher memory
    unboundedly).

    MUTATES ``base_env`` — the KV endpoint, interval and per-job secret
    must be in place before any worker spawns.  Non-elastic jobs get a
    dedicated KV server here (their only launcher-side socket); elastic
    jobs pass their existing rendezvous server + already-routable
    address, and /metrics shares its port.  ``announce_host``: the
    launcher address remote scrapers (and remote workers) should dial;
    default loopback for all-local jobs."""
    try:
        interval = (
            float(live_stats_secs)
            if live_stats_secs is not None
            else float(base_env.get(envmod.LIVE_STATS) or 0.0)
        )
    except ValueError:
        raise ValueError(
            f"{envmod.LIVE_STATS} must be a number of seconds; got "
            f"{base_env.get(envmod.LIVE_STATS)!r}"
        )
    if interval <= 0:
        return None, None
    from ..obs.live import LivePlane  # noqa: PLC0415
    from .rendezvous import KVStoreServer, SECRET_ENV  # noqa: PLC0415

    owned = None
    if kv_server is None:
        owned = kv_server = KVStoreServer(
            port=int(live_port or 0),
            secret=base_env.get(SECRET_ENV) or None,
            bind_all=bind_all,
        )
        kv_server.start()
    host = (announce_host
            or (kv_addr.rsplit(":", 1)[0] if kv_addr else None)
            or "127.0.0.1")
    base_env[SECRET_ENV] = kv_server.secret
    base_env[envmod.LIVE_KV] = kv_addr or f"{host}:{kv_server.port}"
    base_env[envmod.LIVE_STATS] = str(interval)
    plane = LivePlane(
        kv_server,
        interval=interval,
        history_path=live_history or "live_history.jsonl",
        expected_ranks=np,
        announce_host=host,
    )
    plane.start()
    return plane, owned


def _ensure_black_box(base_env: Dict[str, str]):
    """Every job gets a flight-recorder dump target before any rank
    spawns: the black box only pays off if it was armed BEFORE the
    crash.  A user-provided ``--flightrec-dump`` / env value is left
    alone; otherwise the launcher mints a temp dir it owns (removed
    after a clean run, kept — and named in the verdict — after a
    failed one).  Returns ``(dump_spec, launcher_owned)``.

    Also marks THIS process as a launcher: it inherits the job's dump
    env but must not dump its own (empty) artifacts under rank 0's
    filename — a launcher-process ring/metrics dump would clobber
    worker rank 0's evidence."""
    envmod.mark_launcher()
    raw = base_env.get(envmod.FLIGHTREC_DUMP)
    if raw:
        return raw, False
    import tempfile  # noqa: PLC0415

    d = tempfile.mkdtemp(prefix="hvdtpu_blackbox_")
    base_env[envmod.FLIGHTREC_DUMP] = d
    return d, True


def _finish_black_box(
    dump_spec: str,
    owned: bool,
    *,
    failed: bool,
    np: int,
    live_history: Optional[str] = None,
    timeline_path: Optional[str] = None,
) -> None:
    """Job-end half of the flight recorder: on abnormal end, correlate
    every rank's ring dump into ``postmortem.json`` and print the
    verdict; on a clean end, remove a launcher-owned temp dir (the
    clean path writes no post-mortem).  Best-effort throughout — a
    post-mortem failure must never mask the job's real error."""
    if not failed:
        if owned:
            import shutil  # noqa: PLC0415

            shutil.rmtree(dump_spec, ignore_errors=True)
        return
    try:
        from ..obs import postmortem  # noqa: PLC0415

        out_dir = (dump_spec if os.path.isdir(dump_spec)
                   else (os.path.dirname(dump_spec) or "."))
        report = postmortem.generate(
            dump_spec,
            expected_ranks=np,
            live_history=live_history,
            timeline_path=timeline_path,
            output=os.path.join(out_dir, "postmortem.json"),
        )
        if report is None:
            return
        print("\n== post-mortem ==")
        print(report["verdict"])
        if report.get("report_path"):
            print(f"postmortem report: {report['report_path']}")
        print(f"flight-recorder dumps: {dump_spec}")
    except Exception as exc:  # pragma: no cover - defensive
        LOG.warning("post-mortem failed: %s", exc)


def _stop_live_plane(plane, owned_server) -> None:
    """Tear down best-effort: a telemetry failure must never turn a
    finished job into an error."""
    if plane is None:
        return
    try:
        plane.stop()
    except Exception:  # pragma: no cover - defensive
        pass
    if owned_server is not None:
        try:
            owned_server.stop()
        except Exception:  # pragma: no cover - defensive
            pass


def launch_job(
    command: List[str],
    np: int,
    hosts: Optional[str] = None,
    hostfile: Optional[str] = None,
    *,
    env: Optional[Dict[str, str]] = None,
    ssh_port: Optional[int] = None,
    start_timeout: Optional[float] = None,
    job_timeout: Optional[float] = None,
    coordinator_port: Optional[int] = None,
    tag_output: bool = True,
    output_filename: Optional[str] = None,
    live_stats_secs: Optional[float] = None,
    live_port: Optional[int] = None,
    live_history: Optional[str] = None,
) -> Dict[int, int]:
    """Allocate slots, spawn workers, wait for completion (reference
    gloo_run.launch_gloo, gloo_run.py:237-304).

    ``start_timeout`` bounds world formation (exported as
    HVDTPU_START_TIMEOUT, the workers' ``init_process_group`` timeout);
    ``job_timeout`` is a whole-job watchdog — unset means run forever.
    The first slot's host runs the ``torch.distributed`` TCP store at the
    coordinator address.  ``live_stats_secs`` (or
    ``HVDTPU_LIVE_STATS_SECS``) turns on the live telemetry plane:
    per-rank metric streaming into a launcher KV server, console digests,
    ``live_history.jsonl``, and a Prometheus ``GET /metrics`` endpoint.
    Every job gets a flight-recorder dump target; a failed one ends with
    the post-mortem verdict (the survivors get SIGUSR1 + SIGTERM and
    ``exec.GRACEFUL_TERM_SECS`` to dump before SIGKILL)."""
    host_slots = _resolve_host_slots(hosts, hostfile, f"localhost:{np}")
    slots = allocate(host_slots, np)

    first_host = slots[0].hostname
    if is_local_host(first_host):
        coord_host = "127.0.0.1"
        port = coordinator_port or _pick_free_port()
    else:
        # The store binds on the remote first host, where we cannot
        # probe; use the fixed (overridable) port.
        coord_host = first_host
        port = coordinator_port or DEFAULT_COORDINATOR_PORT
    coordinator = f"{coord_host}:{port}"

    base_env = dict(os.environ)
    if env:
        base_env.update(env)
    if start_timeout is not None:
        base_env[envmod.START_TIMEOUT] = str(int(start_timeout))
    if output_filename:
        os.makedirs(output_filename, exist_ok=True)

    # Live telemetry before any spawn: workers read the KV endpoint and
    # interval from their spawn env.  The dedicated server binds beyond
    # loopback only when some worker is remote, and both the worker env
    # and the announced scrape endpoint then carry the launcher's
    # routable address instead of loopback.
    all_local = all(is_local_host(s.hostname) for s in slots)
    live_announce = None
    if not all_local and (
        live_stats_secs or base_env.get(envmod.LIVE_STATS)
    ):
        from .allocate import routable_ip  # noqa: PLC0415

        probe = next(
            (s.hostname for s in slots if not is_local_host(s.hostname)),
            "127.0.0.1",
        )
        live_announce = routable_ip(probe)
    live_plane, live_server = _maybe_start_live_plane(
        base_env, np,
        live_stats_secs=live_stats_secs, live_port=live_port,
        live_history=live_history, bind_all=not all_local,
        announce_host=live_announce,
    )

    black_box, owns_black_box = _ensure_black_box(base_env)
    procs = ProcessSet()
    procs.install_signal_handlers()
    _clean_stale_obs_files(base_env)
    for slot in slots:
        slot_env = build_slot_env(slot, coordinator, base_env)
        _spawn_worker(
            procs, slot.rank, slot.hostname, command, slot_env, base_env,
            ssh_port=ssh_port, tag_output=tag_output,
            output_dir=output_filename, num_proc=np,
        )
    failed = True
    try:
        result = procs.wait(timeout=job_timeout)
        failed = False
        return result
    finally:
        # Failed jobs merge too — a partial trace of a dead job is the
        # most valuable trace there is.  The live plane drains its final
        # round (workers flush at exit) before the server goes away.
        _stop_live_plane(live_plane, live_server)
        merged = _merge_rank_timelines(base_env)
        _merge_rank_traces(base_env, np)
        # On abnormal end the dead ranks' flight recorders already
        # flushed (their handlers ran inside wait()'s terminate);
        # correlate them into postmortem.json and print the verdict.
        _finish_black_box(
            black_box, owns_black_box, failed=failed, np=np,
            live_history=(
                (live_history or "live_history.jsonl")
                if live_plane is not None else None
            ),
            timeline_path=merged,
        )


def _arm_launcher_trace_env(env: Dict[str, str]) -> None:
    """The launcher is a span producer too (ingest pump, client result
    fetches): flag-derived trace knobs must land in ITS os.environ, not
    just the workers' env dict, or ``--trace`` records no launcher-side
    spans at all — and a flag-given sample rate would diverge from the
    workers', violating the identical-verdict invariant obs/trace.py
    documents."""
    for var in (envmod.TRACE, envmod.TRACE_SAMPLE_RATE):
        if env.get(var):
            os.environ[var] = env[var]


def _clean_stale_obs_files(env: Dict[str, str]) -> None:
    """Remove LEFTOVER per-rank timeline/metrics files from a previous
    job pointed at the same paths — the end-of-job merge and summary
    glob everything matching, and a 2-rank run must not inherit phantom
    lanes/columns from an earlier 4-rank run.  The merged/summary
    outputs themselves never match the per-rank glob."""
    import glob as _glob  # noqa: PLC0415

    from ..obs import pathspec  # noqa: PLC0415

    for var, stem in ((envmod.TIMELINE, "trace"),
                      (envmod.METRICS_DUMP, "metrics"),
                      (envmod.FLIGHTREC_DUMP, "flightrec"),
                      (envmod.TRACE, "spans")):
        raw = env.get(var)
        if not raw:
            continue
        if var == envmod.TRACE and "{rank}" not in raw:
            # A previous run's merged waterfall/report — and the
            # launcher's own span file, whose ``launcher`` tag has no
            # digits for rank_of_path to anchor on — would read as
            # THIS run's; none of them survive the rank-tag loop
            # below, so remove them here.
            from ..obs import trace_merge  # noqa: PLC0415

            doomed = [pathspec.resolve(raw, "spans", "launcher",
                                       epoch="")]
            doomed += list(trace_merge.merged_output_paths(raw))
            for path in doomed:
                try:
                    os.remove(path)
                except OSError:
                    pass
        if var == envmod.FLIGHTREC_DUMP:
            # A previous crashed run's verdict would read as THIS
            # run's — it is ours by name, remove it from wherever
            # _finish_black_box would write it (the dir itself, or the
            # parent of a plain-path/template spec).  Ditto orphaned
            # atomic-write tmp files: a rank killed mid-dump dies
            # inside its signal handler and never unwinds to clean its
            # own tmp.
            out_dir = (raw if os.path.isdir(raw)
                       else (os.path.dirname(raw) or "."))
            try:
                os.remove(os.path.join(out_dir, "postmortem.json"))
            except OSError:
                pass
            for tmp in _glob.glob(
                os.path.join(out_dir, "flightrec.*.tmp.*")
            ):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
        if "{rank}" in raw:
            # A user template has no rank/epoch token to anchor on —
            # its glob would match arbitrary sibling files, and deleting
            # those is worse than a phantom lane.  Template users own
            # their files.
            continue
        try:
            for path in _glob.glob(pathspec.glob_pattern(raw, stem)):
                # Belt and braces: only files that carry our rank tag —
                # never anything a user might have put next to them.
                if pathspec.rank_of_path(path) is not None:
                    os.remove(path)
        except OSError:
            pass


def _merge_rank_traces(env: Dict[str, str], np: int) -> Optional[dict]:
    """Flush the launcher's own spans (ingest pump, client result
    fetches — tagged ``launcher``) and merge every rank's span file
    into the per-request waterfall + latency-decomposition report
    (``--trace``).  Best-effort like the timeline merge: a trace
    failure must never turn a finished job into an error."""
    raw = env.get(envmod.TRACE)
    if not raw:
        return None
    try:
        from ..obs import trace as obs_trace  # noqa: PLC0415
        from ..obs import trace_merge  # noqa: PLC0415

        if obs_trace.get_buffer().recorded:
            # Explicit path: the dump target may live only in the
            # workers' env dict, not this process's os.environ.
            obs_trace.flush(obs_trace.resolve_dump_path(raw))
        out = trace_merge.merge_glob(raw, expected_ranks=np)
        if out is not None:
            doc = out["doc"]
            line = (f"[trace] waterfall {out['waterfall']} "
                    f"({out['events']} spans, "
                    f"{len(doc['requests'])} requests); "
                    f"report {out['report']}")
            if doc["missing_ranks"]:
                line += f"; MISSING ranks {doc['missing_ranks']}"
            print(line, flush=True)
        return out
    except Exception as exc:  # pragma: no cover - defensive
        LOG.warning("trace merge failed: %s", exc)
        return None


def _merge_rank_timelines(env: Dict[str, str]) -> Optional[str]:
    """Merge the job's per-rank Chrome traces (every rank records now;
    HVDTPU_TIMELINE names the template/dir) into one valid trace with a
    lane per rank.  Best-effort: remote ranks' files are not fetched,
    and a merge failure must never turn a finished job into an error."""
    raw = env.get(envmod.TIMELINE)
    if not raw:
        return None
    try:
        from ..obs import timeline_merge  # noqa: PLC0415

        merged = timeline_merge.merge_glob(raw)
        if merged:
            LOG.info("merged all-rank timeline -> %s", merged)
        return merged
    except Exception as exc:  # pragma: no cover - defensive
        LOG.warning("timeline merge failed: %s", exc)
        return None




def _spawn_worker(
    procs, rank: int, host: str, command: List[str],
    worker_env: Dict[str, str], local_env: Dict[str, str], *,
    ssh_port: Optional[int], tag_output: bool,
    output_dir: Optional[str], num_proc: int,
) -> None:
    """Shared local/ssh rank spawn for :func:`launch_job` and the
    elastic monitor.  Local ranks get ``worker_env`` directly; remote
    ranks go over ssh with env inlined (reference gloo_run
    get_remote_command) — only the :data:`TRAVEL_ENV` families travel,
    a full env copy would break the remote shell.  ``local_env`` is what
    the local ssh client process itself runs under."""
    if is_local_host(host):
        procs.launch(rank, command, worker_env, tag_output=tag_output,
                     output_dir=output_dir, num_proc=num_proc)
        return
    travel = {k: v for k, v in worker_env.items()
              if k.startswith(TRAVEL_ENV)}
    ssh_cmd, stdin_data = make_ssh_command(host, command, travel, ssh_port)
    procs.launch(rank, ssh_cmd, local_env, tag_output=tag_output,
                 stdin_data=stdin_data, output_dir=output_dir,
                 num_proc=num_proc)


class ElasticJobResult:
    """What an elastic run leaves behind: per-rank exit codes of the
    FINAL incarnation of each rank, the last epoch, the world (every
    rank that completed and delivered a result), and the recovery
    trace — a deterministic event list (no timestamps) so two runs with
    the same fault spec compare equal."""

    def __init__(self):
        self.exit_codes: Dict[int, int] = {}
        self.epoch = 0
        self.world: List[int] = []
        self.trace: List[tuple] = []

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"ElasticJobResult(epoch={self.epoch}, "
                f"world={self.world}, trace={self.trace})")


def launch_elastic_job(
    command: List[str],
    np: int,
    hosts: Optional[str] = None,
    hostfile: Optional[str] = None,
    *,
    env: Optional[Dict[str, str]] = None,
    ssh_port: Optional[int] = None,
    min_workers: Optional[int] = None,
    max_retries: int = 3,
    heartbeat_timeout: float = 60.0,
    progress_timeout: float = 300.0,
    progress_grace: float = 0.0,
    blacklist_cooldown: float = 10.0,
    dump_grace_secs: float = 5.0,
    job_timeout: Optional[float] = None,
    kv_server=None,
    tag_output: bool = True,
    output_filename: Optional[str] = None,
    max_workers: Optional[int] = None,
    autoscale: Optional[dict] = None,
    serve_ingest: bool = False,
    serve_frontends: int = 1,
    front_door=None,
    live_stats_secs: Optional[float] = None,
    live_history: Optional[str] = None,
) -> ElasticJobResult:
    """Elastic counterpart of :func:`launch_job`: per-rank failure
    detection (exit code + KV heartbeat + collective-path progress
    beat), host blacklisting with exponential-backoff re-admission, and
    bounded respawn of failed ranks into a re-minted rendezvous epoch.

    Worker contract: each rank runs ``command`` with the
    ``HVDTPU_ELASTIC_*`` env (see elastic/context.py) and coordinates
    through the launcher's KV store; no ``torch.distributed`` world is
    bootstrapped (its membership cannot survive a rank death).  Each rank
    also gets its slot's ``HVDTPU_LOCAL_RANK``, which picks its GPU.

    ``min_workers``: once the respawn budget is spent, the job may
    continue with a SHRUNKEN world as long as at least this many ranks
    survive (default np — any unrecoverable failure aborts); under
    autoscale it is also the envelope floor.
    ``max_workers``: the envelope ceiling (default np) — ranks
    ``np..max_workers-1`` are standby slots a deliberate grow admits;
    the host list must carry slots for all of them.
    ``autoscale``: a dict of :class:`~..serve.autoscale.AutoscaleConfig`
    overrides; when set, the launcher reads the live plane's merged
    ``serve.queue_depth`` / ``serve.ttft_ms`` gauges and executes the
    policy's grow and shrink decisions through the same epoch-mint and
    spawn/drop path failures use (``scale_up`` / ``scale_down`` trace
    events).  Live stats are forced on (0.5 s) when nothing else armed
    them: the gauges are the controller's only input.
    ``max_retries`` bounds total respawns across the job.
    ``progress_timeout`` / ``progress_grace``: the workload-aware
    progress-beat policy (``obs.progress.ProgressPolicy``).  Worker
    beats piggyback the collectives-completed counter and phase; a rank
    whose beat thread lives but whose counter is frozen in steady state
    for ``progress_timeout`` seconds has a deadlocked training thread and
    is killed and respawned directly.  ``progress_grace`` is the same
    window for init/compile phases (0 = never kill there).
    A rank declared dead is killed at once (SIGKILL to its process
    group).
    ``kv_server``: a caller-started rendezvous server already seeded
    with job payloads (the ``elastic.launch`` and ``ServeJob`` paths);
    created and stopped here when None, with the secret of
    ``HVDTPU_SECRET`` when the launcher's environment sets it (so the
    process that started a serving launcher can submit requests as a
    client), else a fresh one.
    ``serve_ingest``: serving mode (``--serve``): a launcher-resident
    :class:`~..serve.frontend.FrontDoor` of ``serve_frontends`` ingest
    pumps orders client submissions into the store's request logs, which
    the serving leaders drain; a frontend takeover re-mints the epoch, so
    every rank replays in-flight requests from the logs.  ``front_door``:
    a caller-built door on this store (``ServeJob``), adopted for
    takeovers and left to its owner to stop.

    ``dump_grace_secs`` (default 5): a rank declared dead gets SIGUSR1 +
    SIGTERM first, so its flight recorder dumps, and SIGKILL after this
    many seconds (0 = SIGKILL at once).  ``live_stats_secs`` /
    ``live_history``: the live telemetry plane, which rides the
    rendezvous store (snapshots on the signed PUT path, ``/metrics`` on
    its port).  Every job gets a flight-recorder dump target; a failed one
    ends with the post-mortem verdict.
    """
    from ..obs import get_registry  # noqa: PLC0415
    from ..obs.progress import ProgressPolicy, beat_epoch  # noqa: PLC0415
    from .rendezvous import (  # noqa: PLC0415
        KVStoreClient, KVStoreServer, SECRET_ENV,
    )

    if min_workers is None:
        min_workers = np
    if not 1 <= min_workers <= np:
        raise ValueError(
            f"min_workers must be in [1, np]; got {min_workers} for np={np}"
        )
    capacity = np if max_workers is None else int(max_workers)
    if capacity < np:
        raise ValueError(
            f"max_workers must be >= np; got {capacity} for np={np}"
        )

    # Slots are allocated for the whole envelope: standby ranks
    # np..capacity-1 need a host the moment a grow admits them, and a
    # host list that cannot carry them must fail here, before a spawn.
    host_slots = _resolve_host_slots(hosts, hostfile,
                                     f"localhost:{capacity}")
    slots = allocate(host_slots, capacity)
    host_of: Dict[int, str] = {s.rank: s.hostname for s in slots}
    slot_of: Dict[int, SlotInfo] = {s.rank: s for s in slots}
    host_order: List[str] = []
    for hs in host_slots:
        if hs.hostname not in host_order:
            host_order.append(hs.hostname)
    all_local = all(is_local_host(h) for h in host_order)

    owns_server = kv_server is None
    if owns_server:
        kv_server = KVStoreServer(bind_all=not all_local,
                                  secret=os.environ.get(SECRET_ENV) or None)
        kv_server.start()
    port = kv_server.port
    kv = KVStoreClient(f"127.0.0.1:{port}", kv_server.secret)
    if all_local:
        kv_addr = f"127.0.0.1:{port}"
    else:
        from .allocate import routable_ip  # noqa: PLC0415

        probe = next((h for h in host_order if not is_local_host(h)),
                     "127.0.0.1")
        kv_addr = f"{routable_ip(probe)}:{port}"

    base_env = dict(os.environ)
    if env:
        base_env.update(env)
    base_env[SECRET_ENV] = kv_server.secret
    base_env["HVDTPU_ELASTIC_KV"] = kv_addr
    if output_filename:
        os.makedirs(output_filename, exist_ok=True)

    # Live telemetry rides the rendezvous store: snapshots travel the
    # same signed PUT path as heartbeats, and /metrics shares the port.
    # The autoscale controller's only input is this plane's merged
    # gauges, so autoscale forces it on when nothing else armed it.
    if autoscale is not None and live_stats_secs is None \
            and not base_env.get(envmod.LIVE_STATS):
        live_stats_secs = 0.5
    live_plane, _ = _maybe_start_live_plane(
        base_env, np, kv_server=kv_server, kv_addr=kv_addr,
        live_stats_secs=live_stats_secs, live_history=live_history,
    )

    # Serving mode: the request front end rides the same store — the
    # launcher-resident front door (serve/frontend.py) totally orders
    # client submissions into the per-shard request logs the serving
    # leaders drain.
    ingest_pump = front_door
    owns_front_door = False
    if serve_ingest and ingest_pump is None:
        from ..serve.frontend import FrontDoor  # noqa: PLC0415

        ingest_pump = FrontDoor(kv_server,
                                frontends=max(int(serve_frontends), 1))
        ingest_pump.start()
        owns_front_door = True
        print(
            f"[serve] ingest endpoint http://{kv_addr} "
            f"({ingest_pump.frontends} frontend shard(s), signed KV "
            f"protocol, scope serve/ — horovod_tpu_torch.serve.ServeClient)",
            flush=True,
        )
    if ingest_pump is not None and live_plane is not None:
        # serve.frontend.* series are launcher-local: expose them on the
        # same /metrics page the worker gauges land on.
        live_plane.add_render(ingest_pump.prometheus)

    metrics = get_registry()
    result = ElasticJobResult()
    trace = result.trace
    blacklist = HostBlacklist(cooldown_base=blacklist_cooldown)

    # Deliberate-resize controller (serving autoscale): the pure policy
    # and its metrics live in serve/autoscale.py; this loop executes its
    # decisions, because only it mints epochs and spawns processes.
    scaler = None
    if autoscale is not None:
        from ..serve.autoscale import (  # noqa: PLC0415
            AutoscaleConfig, AutoscaleController,
        )
        from ..testing.faults import maybe_fail  # noqa: PLC0415

        scaler = AutoscaleController(
            AutoscaleConfig(
                min_workers=min_workers, max_workers=capacity,
                **{k: v for k, v in autoscale.items() if v is not None},
            ),
            registry=metrics,
        )
        if live_plane is not None:
            # autoscale.* series live in the launcher's registry, which
            # worker snapshots never carry: expose them on /metrics
            live_plane.add_render(scaler.prometheus)

    # Slice-aware blacklisting (multislice jobs): a failure is recorded
    # against its rank's slice too, and a quorum of dead hosts within
    # one slice blacklists the whole slice — same contiguous-block
    # rank->slice rule as basics.resolve_slice_partition.
    try:
        num_slices = int(base_env.get(envmod.NUM_SLICES) or 0)
    except ValueError:
        num_slices = 0
    if num_slices <= 0:
        try:
            ssize = int(base_env.get(envmod.SLICE_SIZE) or 0)
        except ValueError:
            ssize = 0
        num_slices = np // ssize if ssize > 0 and np % ssize == 0 else 0
    slice_of: Dict[int, int] = {}
    if num_slices > 1 and np % num_slices == 0:
        from .allocate import slice_assignment  # noqa: PLC0415

        slice_of = dict(enumerate(slice_assignment(np, num_slices)))

    def record_rank_failure(rank: int, host: str) -> int:
        sid = slice_of.get(rank)
        if sid is None:
            return blacklist.record_failure(host)
        members = sorted(
            {host_of[r] for r, s in slice_of.items()
             if s == sid and r in host_of}
        )
        return blacklist.record_failure(
            host, slice_id=sid, slice_hosts=members
        )
    progress_policy = ProgressPolicy(progress_timeout, progress_grace)
    procs = ProcessSet()
    procs.install_signal_handlers()

    def mint_epoch(epoch: int, world: List[int]) -> None:
        # World before epoch: a worker that sees the new epoch number
        # must find its membership already published.
        kv.put("elastic", f"world_{epoch}", pickle.dumps(sorted(world)))
        kv.put("elastic", "epoch", str(epoch).encode())
        metrics.counter("launcher.epochs_minted").inc()

    # rank -> epoch its CURRENT incarnation was spawned into; beats
    # stamped with an older epoch are a dead predecessor's leftovers.
    spawn_epoch: Dict[int, int] = {}

    def spawn(rank: int, host: str, epoch: int) -> None:
        spawn_epoch[rank] = epoch
        worker_env = dict(base_env)
        worker_env.update({
            "HVDTPU_ELASTIC_RANK": str(rank),
            "HVDTPU_ELASTIC_EPOCH": str(epoch),
            "HVDTPU_ELASTIC_NP": str(np),
            # the slot's GPU on its host (basics._resolve_device)
            envmod.LOCAL_RANK: str(slot_of[rank].local_rank),
            envmod.LOCAL_SIZE: str(slot_of[rank].local_size),
        })
        # Epoch-qualified capture dir: a respawn must not truncate the
        # dead incarnation's logs — they are the primary evidence of
        # why it died.
        out_dir = (os.path.join(output_filename, f"epoch.{epoch}")
                   if output_filename else None)
        _spawn_worker(
            procs, rank, host, command, worker_env, base_env,
            ssh_port=ssh_port, tag_output=tag_output,
            output_dir=out_dir, num_proc=np,
        )

    def posted_error(rank: int, up_to_epoch: int) -> Optional[str]:
        """A worker that RAISED (vs crashed) posted its traceback, a
        pickled string, under an epoch-qualified key before exiting;
        that diagnostic both aborts the job and wins over the generic
        exit-code error."""
        for e in range(up_to_epoch + 1):
            raw = kv.get("elastic", f"error_{rank}_{e}")
            if raw is not None:
                return pickle.loads(raw)
        return None

    epoch = 0
    world = list(range(np))
    finished: Dict[int, int] = {}
    # Ranks a deliberate scale-down released (they exit 0 and land in
    # `finished`, but the job is not draining — the distinction keeps
    # autoscale alive after its own shrinks).
    released: set = set()
    hb_seen: Dict[int, tuple] = {}
    hb_next_scan = 0.0
    scale_next = 0.0
    respawns_used = 0
    deadline = time.monotonic() + job_timeout if job_timeout else None
    black_box, owns_black_box = _ensure_black_box(base_env)
    job_failed = False

    try:
        _clean_stale_obs_files(base_env)
        mint_epoch(epoch, world)
        for rank in world:
            spawn(rank, host_of[rank], epoch)
            trace.append(("spawn", rank, epoch, host_of[rank]))

        while True:
            for rank, rc in procs.poll_exits():
                if rc == 0:
                    finished[rank] = 0
                    continue
                if rank in released:
                    # A released rank that died on its way out owes the
                    # job nothing: it is neither respawned nor counted
                    # as a host failure.
                    trace.append(("released_exit", rank, rc, epoch))
                    continue
                tb = posted_error(rank, epoch)
                if tb is not None:
                    raise RuntimeError(
                        f"elastic rank {rank} raised:\n{tb}"
                    )
                host = host_of[rank]
                count = record_rank_failure(rank, host)
                metrics.counter("launcher.rank_failures").inc()
                metrics.counter("launcher.blacklists").inc()
                trace.append(("failure", rank, rc, epoch))
                trace.append(("blacklist", host, count))
                LOG.warning(
                    "elastic: rank %d on %s exited %d (failure %d on "
                    "this host)", rank, host, rc, count,
                )
                alive = procs.alive_ranks()
                # Released ranks exited 0 but did not finish the job's
                # work: counting them as contributors would let a crash
                # of the last real worker "complete" the job on a
                # released rank's summary, dropping in-flight requests.
                contributed = set(finished) - released
                if not alive and contributed:
                    # Every peer already exited 0: a replacement would
                    # have no survivor to sync state from and would
                    # retrain alone from initial values.  The committed
                    # result is already replicated across the finished
                    # ranks — finish with them instead of respawning.
                    if len(contributed) < min_workers:
                        raise RuntimeError(
                            f"elastic job lost rank {rank} after only "
                            f"{len(contributed)} workers finished "
                            f"(< min_workers={min_workers})"
                        )
                    epoch += 1
                    world = sorted(contributed)
                    mint_epoch(epoch, world)
                    trace.append(("shrink", epoch, tuple(world)))
                    LOG.warning(
                        "elastic: rank %d died after all peers finished; "
                        "completing with %d/%d workers", rank,
                        len(world), np,
                    )
                    continue
                if respawns_used < max_retries:
                    respawns_used += 1
                    new_host = blacklist.select(host_order, prefer=host)
                    host_of[rank] = new_host
                    epoch += 1
                    world = sorted(set(alive) | {rank})
                    mint_epoch(epoch, world)
                    # The dead incarnation's last observed beat must not
                    # count against the successor's first-beat window.
                    hb_seen.pop(rank, None)
                    progress_policy.forget(rank)
                    spawn(rank, new_host, epoch)
                    metrics.counter("launcher.respawns").inc()
                    trace.append(("respawn", rank, epoch, new_host))
                    LOG.warning("elastic: respawned rank %d on %s into "
                                "epoch %d", rank, new_host, epoch)
                elif len(set(alive) | contributed) >= min_workers:
                    # Budget spent: continue with the shrunken world
                    # (the dead rank's slot is dropped for good).
                    # min_workers counts CONTRIBUTING ranks — alive ones
                    # plus those that already delivered a result.
                    epoch += 1
                    world = sorted(alive)
                    mint_epoch(epoch, world)
                    trace.append(("shrink", epoch, tuple(world)))
                    LOG.warning(
                        "elastic: respawn budget spent; continuing with "
                        "%d/%d workers", len(world), np,
                    )
                else:
                    raise RuntimeError(
                        f"elastic job lost rank {rank} with the respawn "
                        f"budget spent and only "
                        f"{len(set(alive) | contributed)} workers "
                        f"contributing (< min_workers={min_workers})"
                    )
            hb_enabled = bool(heartbeat_timeout and heartbeat_timeout > 0)
            if ((hb_enabled or progress_policy.enabled)
                    and time.monotonic() >= hb_next_scan):
                # Beats only change once per worker heartbeat period, so
                # scanning them on every 50 ms monitor tick is np wasted
                # KV round-trips; exits stay on the fast tick.  The scan
                # runs for EITHER rule: disabling the process-heartbeat
                # rule must not silently disable deadlock detection.
                hb_next_scan = time.monotonic() + min(
                    1.0,
                    heartbeat_timeout / 4 if hb_enabled else 1.0,
                )
                # Staleness is judged entirely on the launcher's clock —
                # the window starts when the launcher OBSERVES a new beat
                # value, never by comparing against the worker's wall
                # clock (cross-host skew > timeout would otherwise kill
                # healthy remote workers in a loop).
                now = time.monotonic()
                for rank in procs.alive_ranks():
                    raw = kv.get("elastic", f"hb_{rank}")
                    if raw is None:
                        continue  # not beating yet (still importing)
                    be = beat_epoch(raw)
                    if be is not None and be < spawn_epoch.get(rank, 0):
                        # A dead incarnation's leftover beat: the
                        # respawned successor has not beaten yet.
                        continue
                    # Rule 1 — process liveness: the beat body changing
                    # at all proves the beat thread (and process) lives.
                    seen = hb_seen.get(rank)
                    if seen is None or seen[0] != raw:
                        hb_seen[rank] = (raw, now)
                    elif hb_enabled and now - seen[1] > heartbeat_timeout:
                        trace.append(("heartbeat_lost", rank, epoch))
                        metrics.counter("launcher.heartbeat_lost").inc()
                        LOG.warning(
                            "elastic: rank %d heartbeat stale > %.0fs; "
                            "declaring it dead", rank, heartbeat_timeout,
                        )
                        hb_seen.pop(rank, None)
                        progress_policy.forget(rank)
                        # Dump-then-kill: SIGUSR1/SIGTERM first so the
                        # declared-dead rank's flight recorder survives
                        # its own execution; SIGKILL after the grace.
                        procs.terminate_rank(rank, grace=dump_grace_secs)
                        continue
                    # Rule 2 — training-thread liveness: a live beat with
                    # a frozen progress counter in steady state is a
                    # deadlocked training thread.  Kill it now, instead
                    # of letting every peer discover it through
                    # collective timeouts.
                    reason = progress_policy.observe(rank, raw, now)
                    if reason is not None:
                        trace.append(("progress_lost", rank, epoch))
                        metrics.counter("launcher.progress_lost").inc()
                        LOG.warning(
                            "elastic: rank %d training thread declared "
                            "dead: %s", rank, reason,
                        )
                        hb_seen.pop(rank, None)
                        progress_policy.forget(rank)
                        procs.terminate_rank(rank, grace=dump_grace_secs)
            if (scaler is not None
                    and live_plane is not None
                    and not (set(finished) - released)
                    and time.monotonic() >= scale_next):
                # Deliberate resize tick.  Never while a real drain is
                # under way (a non-released rank finished), and only
                # against a stable world (every member alive: a failure
                # respawn in flight wins the epoch race).
                scale_next = time.monotonic() + 0.25
                if set(world) <= set(procs.alive_ranks()):
                    decision = scaler.tick(
                        time.monotonic(), live_plane.agg.merged(), world,
                    )
                else:
                    decision = None
                if decision is not None and decision.direction == "up":
                    want = decision.target - len(world)
                    standby = [r for r in range(capacity)
                               if r not in world][:want]
                    admitted = []
                    skipped_blacklisted = False
                    for r in standby:
                        # a grow honours the host blacklist the respawn
                        # path does
                        if not blacklist.is_admissible(host_of[r]):
                            trace.append(
                                ("scale_skip_blacklisted", r, epoch))
                            skipped_blacklisted = True
                            continue
                        # chaos point: a standby refusing admission
                        # (action=scale_fail) arms the policy's backoff
                        if maybe_fail("scale_admit",
                                      rank=r) == "scale_fail":
                            trace.append(("scale_fail", r, epoch))
                            scaler.grow_failed(time.monotonic(), r)
                            continue
                        admitted.append(r)
                    if not admitted and skipped_blacklisted:
                        # every standby is cooling down: back off like a
                        # refused admission
                        scaler.grow_failed(time.monotonic(), standby[0])
                    if admitted:
                        epoch += 1
                        for r in admitted:
                            # a released rank re-admitted: its old clean
                            # exit is not this incarnation's result
                            finished.pop(r, None)
                            released.discard(r)
                            hb_seen.pop(r, None)
                            progress_policy.forget(r)
                        world = sorted(set(world) | set(admitted))
                        mint_epoch(epoch, world)
                        for r in admitted:
                            spawn(r, host_of[r], epoch)
                        trace.append(("scale_up", epoch, tuple(admitted)))
                        LOG.warning("elastic: scale up to %d ranks at "
                                    "epoch %d (%s)", len(world), epoch,
                                    decision.reason)
                        scaler.executed(decision, epoch, len(world))
                elif decision is not None \
                        and decision.direction == "down":
                    drop = len(world) - decision.target
                    victims = sorted(world)[-drop:]
                    released.update(victims)
                    epoch += 1
                    world = [r for r in world if r not in victims]
                    mint_epoch(epoch, world)
                    # The victims see the epoch bump, find themselves
                    # outside the new world and exit 0 (RankDroppedError,
                    # a clean release); survivors replay in-flight work.
                    trace.append(("scale_down", epoch, tuple(victims)))
                    LOG.warning("elastic: scale down to %d ranks at "
                                "epoch %d (%s)", len(world), epoch,
                                decision.reason)
                    scaler.executed(decision, epoch, len(world))
            if ingest_pump is not None \
                    and not (set(finished) - released) \
                    and set(world) <= set(procs.alive_ranks()):
                # Frontend takeover -> epoch re-mint: a dead frontend's
                # shards were adopted by a survivor; re-forming the
                # serving world makes every rank replay from the durable
                # per-shard logs.  Only against a whole world, so a
                # takeover racing a failure respawn waits for its epoch.
                takeovers = ingest_pump.poll_takeover()
                if takeovers:
                    epoch += 1
                    mint_epoch(epoch, world)
                    for ev in takeovers:
                        trace.append(("frontend_takeover", ev["fid"],
                                      ev["owner"], epoch))
                    LOG.warning(
                        "elastic: %d frontend takeover(s); re-minted "
                        "epoch %d for the serving world",
                        len(takeovers), epoch,
                    )
            if all(r in finished for r in world):
                result.exit_codes = dict(finished)
                result.epoch = epoch
                # Every rank that delivered a result — not just the last
                # rendezvous world, which drops ranks that finished
                # before a late respawn/shrink re-formed it.
                result.world = sorted(finished)
                return result
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"elastic job timed out after {job_timeout}s "
                    f"(finished={sorted(finished)}, world={world})"
                )
            time.sleep(0.05)
    except BaseException:
        job_failed = True
        # terminate() SIGUSR1s and SIGTERMs the tree and waits its
        # graceful window: the survivors' flight recorders flush inside
        # it, so the post-mortem below reads complete rings.
        procs.terminate()
        raise
    finally:
        if ingest_pump is not None and owns_front_door:
            # A caller-passed front door (ServeJob) outlives this launch:
            # its owner stops it after collecting results.
            try:
                ingest_pump.stop()
            except Exception:  # pragma: no cover - defensive
                pass
        # Drain the final live round while the store is still up.
        _stop_live_plane(live_plane, None)
        if owns_server:
            kv_server.stop()
        # All-rank merges, dead incarnations included: a killed rank's
        # epoch-tagged lane is the story of why it died.
        merged = _merge_rank_timelines(base_env)
        _merge_rank_traces(base_env, np)
        _finish_black_box(
            black_box, owns_black_box, failed=job_failed, np=np,
            live_history=(
                (live_history or "live_history.jsonl")
                if live_plane is not None else None
            ),
            timeline_path=merged,
        )


def _or(value, default):
    # `x or default` would coerce an EXPLICIT 0 (zero respawns / zero
    # cooldown) back to the default.
    return default if value is None else value


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.version:
        from .. import __version__  # noqa: PLC0415

        print(__version__)
        return 0
    if args.check_build:
        print(check_build())
        return 0
    if args.discover_nics:
        try:
            for iface in discover_nics(
                hosts=args.hosts, hostfile=args.hostfile,
                ssh_port=args.ssh_port,
            ):
                print(iface)
            return 0
        except (RuntimeError, OSError, TimeoutError, ValueError) as exc:
            # ValueError covers forged/corrupt signed responses (_unpack).
            print(f"hvdrun: NIC discovery failed: {exc}", file=sys.stderr)
            return 1
    if not args.np:
        print("error: -np is required", file=sys.stderr)
        return 2
    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        if args.serve:
            # Serving mode ships its own worker; -np 2 --serve alone is
            # a complete invocation.
            command = [sys.executable, "-m", "horovod_tpu_torch.serve"]
        else:
            print("error: no command given", file=sys.stderr)
            return 2
    if args.verbose and not args.log_level:
        args.log_level = "debug"
    if args.log_level:
        os.environ[envmod.LOG_LEVEL] = args.log_level
    if getattr(args, "num_slices", None):
        # Refuse a bad partition HERE, before spawning anything — every
        # worker would otherwise discover it independently and downgrade.
        from .allocate import slice_assignment  # noqa: PLC0415

        try:
            slice_assignment(args.np, args.num_slices)
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2

    env: Dict[str, str] = {}
    config_parser.set_env_from_args(env, args)
    _arm_launcher_trace_env(env)
    summary_tmp = None
    if args.stats_summary and not (
        env.get(envmod.METRICS_DUMP) or os.environ.get(envmod.METRICS_DUMP)
    ):
        # --stats-summary without --metrics-dump: dump into a temp dir
        # that lives exactly as long as the summary needs it.
        import tempfile  # noqa: PLC0415

        summary_tmp = tempfile.mkdtemp(prefix="hvdtpu_metrics_")
        env[envmod.METRICS_DUMP] = summary_tmp
    try:
        LOG.info("launching %d processes: %s", args.np, " ".join(command))
        if args.elastic or args.serve:
            autoscale = None
            if args.serve_autoscale:
                autoscale = {
                    "scale_up_queue": args.scale_up_queue,
                    "scale_down_idle_secs": args.scale_down_idle_secs,
                }
                if args.scale_cooldown_secs is not None:
                    autoscale["up_cooldown_secs"] = args.scale_cooldown_secs
                    autoscale["down_cooldown_secs"] = \
                        args.scale_cooldown_secs
            launch_elastic_job(
                command,
                args.np,
                hosts=args.hosts,
                hostfile=args.hostfile,
                env=env,
                ssh_port=args.ssh_port,
                min_workers=args.min_workers,
                max_workers=args.max_workers,
                autoscale=autoscale,
                max_retries=_or(args.max_elastic_retries, 3),
                blacklist_cooldown=_or(args.blacklist_cooldown_secs, 10.0),
                progress_timeout=_or(args.progress_timeout_secs, 300.0),
                progress_grace=_or(args.progress_grace_secs, 0.0),
                dump_grace_secs=_or(args.dump_grace_secs, 5.0),
                output_filename=args.output_filename,
                live_stats_secs=args.live_stats_secs,
                live_history=args.live_history_file,
                serve_ingest=args.serve,
                serve_frontends=int(
                    args.serve_frontends
                    or envmod.env_int(envmod.SERVE_FRONTENDS, 1)),
            )
            return 0
        launch_job(
            command,
            args.np,
            hosts=args.hosts,
            hostfile=args.hostfile,
            env=env,
            ssh_port=args.ssh_port,
            start_timeout=args.start_timeout,
            coordinator_port=args.coordinator_port,
            output_filename=args.output_filename,
            live_stats_secs=args.live_stats_secs,
            live_port=args.live_port,
            live_history=args.live_history_file,
        )
        return 0
    except (RuntimeError, ValueError, TimeoutError, OSError) as exc:
        print(f"hvdrun: {exc}", file=sys.stderr)
        return 1
    finally:
        # Failed jobs summarize too — the metrics of a dead run are the
        # ones someone is about to go digging for.
        try:
            _print_stats_summary(args, env)
        finally:
            if summary_tmp is not None:
                import shutil  # noqa: PLC0415

                shutil.rmtree(summary_tmp, ignore_errors=True)


def _print_stats_summary(args, env: Dict[str, str]) -> None:
    """End-of-job per-rank metrics table (--stats-summary)."""
    if not getattr(args, "stats_summary", False):
        return
    raw = env.get(envmod.METRICS_DUMP) or os.environ.get(envmod.METRICS_DUMP)
    if not raw:
        return
    from ..obs import summary as obs_summary  # noqa: PLC0415

    dumps = obs_summary.collect_dumps(raw)
    if not dumps:
        for warn in getattr(dumps, "warnings", []):
            print(f"hvdrun: --stats-summary: {warn}", file=sys.stderr)
        print("hvdrun: --stats-summary: no metrics dumps found "
              f"under {raw!r}", file=sys.stderr)
        return
    print("\n== per-rank metrics summary ==")
    print(obs_summary.format_summary_table(dumps))
    straggler = obs_summary.straggler_section(dumps)
    if straggler is not None:
        print("\n== straggler attribution ==")
        print(straggler)
    fabric = obs_summary.fabric_section(dumps)
    if fabric is not None:
        print("\n== cross-fabric bytes (dcn vs ici) ==")
        print(fabric)
    ckpt = obs_summary.ckpt_section(dumps)
    if ckpt is not None:
        print("\n== checkpoint / recovery ==")
        print(ckpt)
    serve = obs_summary.serve_section(dumps)
    if serve is not None:
        print("\n== serving plane ==")
        print(serve)
    slo = obs_summary.slo_section(dumps)
    if slo is not None:
        print("\n== tenant SLO / burn rate ==")
        print(slo)
    health = obs_summary.health_section(dumps)
    if health is not None:
        print("\n== training health ==")
        print(health)
    goodput = obs_summary.goodput_section(dumps)
    if goodput is not None:
        print("\n== goodput ledger ==")
        print(goodput)
    autoscale = obs_summary.autoscale_section(dumps)
    if autoscale is not None:
        print("\n== autoscale / weight hot-swap ==")
        print(autoscale)
    perf = obs_summary.perf_section(dumps)
    if perf is not None:
        print("\n== mfu / model flops ==")
        print(perf)
    mem = obs_summary.mem_section(dumps)
    if mem is not None:
        print("\n== device memory (memory plane) ==")
        print(mem)
    trend = obs_summary.trend_section(dumps)
    if trend is not None:
        print("\n== perf trend (BENCH trajectory) ==")
        print(trend)

