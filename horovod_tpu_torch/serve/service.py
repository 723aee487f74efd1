"""The serving loop and job driver: continuous batching on the elastic
launcher (a port of ``horovod_tpu/serve/service.py``).

Topology: every rank of the serving world runs the SAME model (built
from ``spec["seed"]`` with an explicit ``torch.Generator``) over the SAME
slot pool and derives an IDENTICAL admit/evict schedule — rank 0 of the
current world (the *leader*, lowest live rank) is the only rank that
reads the ingest log and the only rank that writes result streams, and
it broadcasts each step's schedule through an epoch-scoped KV key its
peers block on.  Identical schedule + the deterministic decode math =
the same tokens on every rank, which is what makes a dead rank
REPLACEABLE: the respawned incarnation rebuilds the same state from the
durable request log and token streams, and no in-flight request is
dropped.

Elastic recovery rides the launcher unchanged (``run/runner.py``): it
detects the dead rank, mints a fresh rendezvous epoch and respawns the
rank; survivors notice the epoch bump (every KV wait is epoch-watched)
and re-rendezvous.  At each epoch start the leader republishes a
*recovery doc* — the ingest-log replay of every not-yet-finished
request, with the tokens already streamed to clients — and every rank
rebuilds its scheduler and re-prefills its slots from it.  Tokens
already delivered are never re-emitted; generation resumes mid-stream.

The weight hot-swap manager (:mod:`.hotswap`) flips the fleet to newly
published weights on a version-stamped step over the schedule-broadcast
lane, with the durable ``serve/weight_version`` record making epoch
recovery converge on exactly one version.  The leader also advances a
finished watermark that compacts ``serve/log/*`` (and, via the ingest
pump, ``serve/out/*``), so the store and the recovery replay stop
growing with total requests ever served.

``serve.*`` instruments land in the per-rank registry (``obs``), which
the live telemetry plane streams and the metrics dump keeps; sampled
requests are traced (``obs/trace.py``), and ``--health`` arms the serving
twin of the divergence sentinel (:func:`_serve_health_check`).  The
launcher's autoscale controller (``serve/autoscale.py``) grows and
shrinks the fleet through re-minted epochs; a rank it drops leaves
through :class:`RankDroppedError` with a release summary.

A width-sharded fleet (``spec["width"] > 1``) serves each group's
requests with one Megatron-sharded engine spread over the group's ranks,
one GPU each (the reference shards over each rank's local devices).  The
ranks of a group meet in a ``torch.distributed`` group formed at the
start of every epoch (:func:`_form_width_group`): the process's default
group is replaced by one over the group's ranks, rendezvousing on a TCP
store the group leader hosts for that epoch.  A peer's death fails the
group's collectives, which the loop takes as a world break: it destroys
the group (a peer blocked in one of its collectives fails at once),
re-rendezvouses, and the next epoch forms the group anew.
"""

from __future__ import annotations

import pickle
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..obs import flightrec as obs_flightrec
from ..obs import get_registry
from ..obs import goodput as obs_goodput
from ..obs import memplane
from ..obs import progress as obs_progress
from ..obs import slo as obs_slo
from ..obs import trace as obs_trace
from ..basics import DP_AXIS
from ..elastic.exceptions import HorovodShutdownError
from ..ops import flash_attention as fa
from ..testing.faults import maybe_fail
from ..utils.logging import get_logger
from .frontend import (SCOPE, FrontDoor, Rejection, ServeClient,
                       validate_request)
from .hotswap import VERSION_KEY, SwapManager
from .paged import page_reject_reason
from .scheduler import Request, SlotScheduler, TenantQoS

LOG = get_logger("serve")

__all__ = ["serve_worker", "ServeJob", "DEFAULT_SPEC", "RateWindow",
           "build_model"]

# A request's decode progress is flushed to its trace lane every this
# many tokens (plus a final remainder span at eviction): per-token
# spans would drown the bounded ring, one-span-per-request would hide
# mid-stream stalls.
_DECODE_SPAN_TOKENS = 8


class RateWindow:
    """Sliding wall-clock token-rate window.

    ``serve.tokens_per_sec`` used to be epoch-cumulative tokens over
    epoch-elapsed time — a number only the leader's whole-epoch cadence
    could explain, and one a trace report (built from per-step decode
    spans) could legitimately disagree with.  This window is fed the
    SAME timestamps the decode-compute spans record, so the digest
    gauge and the trace report are two views of one clock: recent
    tokens over a trailing ``window`` seconds (epoch-elapsed until the
    window first fills, matching the old early-epoch semantics)."""

    def __init__(self, window_secs: float = 5.0):
        self.window = float(window_secs)
        self._events: deque = deque()  # (t, ntokens)
        self._total = 0
        self._first_t: Optional[float] = None

    def observe(self, t: float, n: int) -> None:
        if n <= 0:
            return
        if self._first_t is None:
            self._first_t = t
        self._events.append((t, n))
        self._total += n
        cut = t - self.window
        while self._events and self._events[0][0] < cut:
            _, m = self._events.popleft()
            self._total -= m

    def rate(self, now: float) -> float:
        if self._first_t is None:
            return 0.0
        cut = now - self.window
        while self._events and self._events[0][0] < cut:
            _, m = self._events.popleft()
            self._total -= m
        span = min(now - self._first_t, self.window)
        return self._total / max(span, 1e-3)

# How many trailing step-schedule keys the leader keeps before deleting
# (authenticated DELETE): an unbounded schedule history would grow the
# launcher's store forever on a long-lived serving job.  The window
# must comfortably exceed the worst leader-vs-peer step lag (peers
# have no back-pressure on the leader): a peer whose next schedule key
# was already GC'd can only time out and force a world re-formation.
_SCHED_KEEP = 256

DEFAULT_SPEC: Dict[str, Any] = {
    "size": "nano",          # gpt(<size>) model family entry
    "overrides": {},         # TransformerConfig overrides
    "seed": 0,               # params init seed AND the sampling root
                             # (identical on every rank; serve/sampling.py)
    "num_slots": 4,
    "max_len": None,         # slot cache length (default cfg.max_len)
    "kv_mode": "paged",      # paged KV (block tables) | "contiguous"
    "page_size": 16,         # KV page size in token rows (paged mode)
    "kv_pages": None,        # page-pool size (default: worst case)
    "width": 0,              # 0 = replicated fleet (peers are hot
                             # standbys); >= 1 = width-sharded fleet:
                             # the world splits into size // width
                             # serving GROUPS, each serving the log
                             # partition n % groups == g.  width > 1
                             # shards the group's decode over its ranks
                             # (a Megatron shard each)
    "device": None,          # None = this rank's GPU (cuda:local_rank);
                             # "cpu" serves on the CPU (tests)
    "idle_secs": 0.01,       # leader pacing when nothing is in flight
    "stream_every": 4,       # publish token streams every N tokens
    "weights_dir": None,     # weight hot-swap source (None = off)
    "swap_poll_steps": 16,   # leader manifest-poll cadence (steps)
    "frontends": 1,          # front-door shard count F: F ingest pumps
                             # each owning the rid-hash partition
                             # crc32(rid) % F (ServeJob / the launcher
                             # publish the authoritative count in the
                             # serve/frontdoor doc — workers read THAT)
    "tenants": None,         # tenant-aware admission (TenantQoS.from_
                             # spec): {"weights": {slo: w},
                             # "budget_tokens": B, "window_steps": W};
                             # None = plain FCFS
}


def _epoch_scope(epoch: int) -> str:
    return f"serve_e{epoch}"


def _fleet_shape(world, rank, width: int):
    """The width-sharded fleet layout, a pure function of the sorted
    world and the spec: ``width == 0`` is the legacy replicated fleet
    (one group, every rank a hot standby of the leader); ``width >= 1``
    carves the world into ``size // width`` serving GROUPS of ``width``
    ranks each (contiguous by world position — DCN carries the group
    axis, ICI the width axis inside each rank's device mesh).  Each
    group independently serves the ingest-log partition ``n % groups ==
    group``; leftover ranks (world not divisible) idle as standbys and
    become capacity at the next resize.  Returns ``(groups, group,
    group_world, standby)`` with ``group=None`` for standbys."""
    size = len(world)
    idx = world.index(rank)
    if width < 1:
        return 1, 0, list(world), False
    groups = max(size // width, 1)
    if idx >= groups * width:
        return groups, None, [], True
    group = idx // width
    return groups, group, list(world[group * width:(group + 1) * width]), False


# seconds a width group's collective may wait on a peer before failing
# (a dead or departed peer turns into a world break, not a hang)
WIDTH_GROUP_TIMEOUT_SECS = 60


def _store_host() -> str:
    """The address the group leader publishes for its store."""
    import socket  # noqa: PLC0415

    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def _form_width_group(ctx, engine, epoch: int, group: int, group_world):
    """Form this epoch's width group: the process's default
    ``torch.distributed`` group is destroyed and re-initialized over the
    ranks of ``group_world`` (rank = position in it), rendezvousing on a
    TCP store the group leader starts and publishes under the epoch's KV
    scope; then the engine is bound to it.  NCCL on CUDA, gloo on the
    CPU.  The group keeps the store alive."""
    from datetime import timedelta  # noqa: PLC0415

    import torch.distributed as dist  # noqa: PLC0415

    me, n = group_world.index(ctx.rank), len(group_world)
    scope, key = _epoch_scope(epoch), f"width_store/{group}"
    timeout = timedelta(seconds=WIDTH_GROUP_TIMEOUT_SECS)
    if me == 0:
        store = dist.TCPStore("0.0.0.0", 0, n, True, timeout=timeout,
                              wait_for_workers=False)
        ctx.kv.put(scope, key, f"{_store_host()}:{store.port}".encode())
    else:
        host, port = _fetch(ctx, scope, key,
                            f"width group {group}'s store").decode() \
            .rsplit(":", 1)
        store = dist.TCPStore(host, int(port), n, False, timeout=timeout)
    if dist.is_initialized():
        dist.destroy_process_group()
    backend = "nccl" if engine.device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=store, rank=me, world_size=n,
                            timeout=timeout)
    # by name, resolved at each call: a reference held to the group would
    # keep its connections open after _leave_width_group destroys it
    engine.bind_width_axis(DP_AXIS)
    LOG.info("epoch %d: rank %d is width shard %d/%d of group %d",
             epoch, ctx.rank, me, n, group)


def _leave_width_group() -> None:
    """Destroy this rank's width group at a world break, before the
    rendezvous: a peer still blocked in one of its collectives fails at
    once (its connection closes) instead of waiting out the timeout while
    the rendezvous waits for it."""
    import torch.distributed as dist  # noqa: PLC0415

    if dist.is_initialized():
        dist.destroy_process_group()


def _width_group_failed(exc: BaseException) -> bool:
    """A failed collective of the width group (a peer died or left)."""
    import torch.distributed as dist  # noqa: PLC0415

    dist_error = getattr(dist, "DistError", None)
    if dist_error is not None and isinstance(exc, dist_error):
        return True
    text = str(exc)
    return isinstance(exc, RuntimeError) and any(
        word in text for word in ("gloo", "Gloo", "NCCL", "Connection",
                                  "closed", "Timed out", "timed out"))


def _fetch(ctx, scope: str, key: str, what: str) -> bytes:
    """Poll one serving key; a rendezvous-epoch bump mid-wait means the
    world broke — surface it as the shutdown signal the outer loop
    turns into re-rendezvous + replay."""
    deadline = time.monotonic() + ctx.timeout
    while True:
        raw = ctx.kv.get(scope, key)
        if raw is not None:
            return raw
        if ctx.current_epoch() > ctx.epoch:
            raise HorovodShutdownError(
                f"world re-formed while waiting for {what}"
            )
        if time.monotonic() > deadline:
            raise HorovodShutdownError(
                f"timed out waiting for {what} — a peer likely died "
                f"without the launcher re-forming the world yet"
            )
        time.sleep(0.005)


def _serve_health_check(ctx, scope: str, group: int, group_world,
                        step: int, sdoc_raw: bytes, paged,
                        action: str) -> None:
    """The divergence sentinel's serving twin: every rank of a width
    group digests the broadcast schedule doc it is about to obey plus
    its KV page-table state, publishes the tiny digest under
    ``healthd/``, fetches its peers' and compares.  Replicated decode
    is the serving form of bitwise replication: followers that drift from the
    leader's schedule or page tables produce silent token corruption
    the output checksums can't localize.  Every rank runs the identical
    comparison on the identical matrix, so every rank reaches the
    identical verdict (and ``halt`` stops the whole group, not one
    rank)."""
    import numpy as np  # noqa: PLC0415

    from ..obs import divergence as obs_divergence  # noqa: PLC0415

    digest = obs_divergence.serve_state_digest(sdoc_raw, paged)
    members = sorted(group_world)
    ctx.kv.put(scope, f"healthd/{group}/{step}/{ctx.rank}",
               digest.astype(np.uint32).tobytes())
    rows = []
    for r in members:
        if r == ctx.rank:
            rows.append(digest)
        else:
            raw = _fetch(ctx, scope, f"healthd/{group}/{step}/{r}",
                         f"serve health digest from rank {r}")
            rows.append(np.frombuffer(raw, dtype=np.uint32))
    mat = np.stack(rows)
    reg = get_registry()
    reg.counter("health.divergence.checks").inc()
    reg.gauge("health.divergence.last_check_step").set(step)
    # GC our own stale key (leader GC'd sched keys the same way).
    prev = step - _SCHED_KEEP
    if prev > 0:
        ctx.kv.delete(scope, f"healthd/{group}/{prev}/{ctx.rank}")
    if bool((mat == mat[0]).all()):
        reg.gauge("health.divergence.alert").set(0)
        return
    minority_idx, _ = obs_divergence._partition(mat)
    minority = [members[i] for i in minority_idx]
    component = ("page_table"
                 if bool((mat[:, :obs_divergence.DIGEST_WIDTH]
                          == mat[0, :obs_divergence.DIGEST_WIDTH]).all())
                 else "sched_doc")
    detail = (f"step={step} "
              f"minority={','.join(str(r) for r in minority)} "
              f"component={component} group={group}")
    reg.counter("health.divergence.detected", component=component).inc()
    reg.gauge("health.divergence.alert").set(1)
    obs_flightrec.record("health.divergence", name=component,
                         cycle=step, detail=detail)
    LOG.error("serving-state divergence: %s", detail)
    if action == "halt":
        raise obs_divergence.DivergenceHalt(
            f"serving divergence sentinel: rank(s) {minority} diverged "
            f"from the group at step {step} in {component} "
            f"(--divergence-action halt)"
        )
    if action == "dump":
        try:
            obs_flightrec.dump_flight_recorder(
                trigger="health.divergence")
        except Exception:  # pragma: no cover - defensive
            pass


def _frontdoor_shape(kv) -> int:
    """The front-door shard count ``F`` from the ownership doc the
    launcher published (``serve/frontdoor``): the interleave constant
    every consumer derives the total order from.  Fixed for the job's
    lifetime (only shard OWNERSHIP moves on frontend takeover), so one
    read at epoch start is safe.  Absent doc = a single pump = 1."""
    raw = kv.get(SCOPE, "frontdoor")
    if raw is None:
        return 1
    try:
        return max(int(pickle.loads(raw).get("frontends", 1)), 1)
    except Exception:
        return 1


def _build_recovery(kv, group: int = 0, groups: int = 1,
                    frontends: int = 1) -> dict:
    """Replay the durable request record: every front-door shard's
    ingest log from that shard's finished watermark up, joined with
    each request's streamed tokens and merged in ``gkey`` order
    (``gkey = n * F + shard`` — the same interleave every rank
    derives).  Only the (group) leader runs this — peers adopt its
    published doc, so a log entry racing in mid-scan can never split
    the world's view.  In a width-sharded fleet each group's doc
    carries only ITS log partition (``gkey % groups == group``);
    ``others`` maps the remaining in-flight ``(shard, n)`` slots to
    their rids so group 0's leader (the global leader) can advance the
    compaction watermarks across groups.

    The per-shard watermark (``serve/log_watermark/<s>``) is the
    compaction floor the leader advances as requests finish: every
    entry below it is done and its log key deleted, so neither this
    replay nor the ingest store grows with total requests ever served —
    only with what is actually in flight.
    ``weight_version`` is the durable flip record the whole fleet
    converges on (hotswap.py's single-version argument rests on every
    rank adopting THIS value at epoch start)."""
    frontends = max(int(frontends), 1)
    watermark: Dict[int, int] = {}
    log_next: Dict[int, int] = {}
    docs = []
    for shard in range(frontends):
        raw = kv.get(SCOPE, f"log_watermark/{shard}")
        wm = int(raw.decode()) if raw is not None else 0
        watermark[shard] = wm
        n = wm
        while True:
            raw = kv.get(SCOPE, f"log/{shard}/{n}")
            if raw is None:
                break
            doc = pickle.loads(raw)
            doc.setdefault("shard", shard)
            doc.setdefault("n", n)
            doc.setdefault("gkey", n * frontends + shard)
            docs.append(doc)
            n += 1
        log_next[shard] = n
    # Replay order is the gkey interleave — per-shard sequence fanned
    # over F — NOT necessarily the live arrival order: live enqueue
    # interleaves arrivals across probe steps, so a quiet shard's
    # low-n entry can sort ahead of busy-shard entries that were
    # enqueued before it live.  What recovery requires is only that
    # every rank derives the SAME order (all ranks adopt the leader's
    # doc, and per-rid token streams are order-independent); the
    # fairness skew is bounded by one in-flight backlog.
    docs.sort(key=lambda d: d["gkey"])
    inflight = []
    done_slots: List[Tuple[int, int]] = []
    others: Dict[Tuple[int, int], str] = {}
    for doc in docs:
        slot = (int(doc["shard"]), int(doc["n"]))
        out_raw = kv.get(SCOPE, f"out/{doc['rid']}")
        emitted: List[int] = []
        if out_raw is not None:
            out = pickle.loads(out_raw)
            if out.get("done"):
                # Finished (or rejected) before the break: only its
                # compaction bookkeeping survives into the new epoch.
                done_slots.append(slot)
                continue
            emitted = list(out.get("tokens", []))
        if int(doc["gkey"]) % groups != group:
            # Another group's request: irrelevant to this group's
            # schedule, but the global leader tracks it for compaction.
            others[slot] = doc["rid"]
            continue
        entry = dict(doc)
        entry["emitted"] = emitted
        inflight.append(entry)
    raw = kv.get(SCOPE, VERSION_KEY)
    version = int(raw.decode()) if raw is not None else 0
    return {"log_next": log_next, "inflight": inflight,
            "watermark": watermark, "done_slots": done_slots,
            "others": others, "weight_version": version,
            "frontends": frontends}


def _publish_out(kv, rid: str, *, tokens, done: bool, epoch: int,
                 admitted_step: int, error: Optional[str] = None,
                 finished_step: Optional[int] = None,
                 reason: Optional[str] = None,
                 n: Optional[int] = None,
                 shard: Optional[int] = None,
                 t_done: Optional[float] = None) -> None:
    doc = {
        "rid": rid,
        "tokens": list(tokens),
        "done": done,
        "epoch": epoch,
        "admitted_step": admitted_step,
    }
    if isinstance(error, Rejection):
        # Machine-readable reject code rides the doc next to the human
        # message; ServeClient.result re-raises it as RequestRejected.
        doc["error_code"] = error.code
    if t_done is not None:
        # Leader-clock completion stamp: lets a measuring client
        # compute throughput from server-side stamps instead of its
        # own polling cadence (bench.py --serve; poll-granularity
        # error was larger than the effects being measured).
        doc["t_done"] = float(t_done)
    if error is not None:
        doc["error"] = error
    if finished_step is not None:
        doc["finished_step"] = finished_step
    if reason is not None:
        doc["reason"] = reason
    if n is not None:
        # Log slot (shard, per-shard index): the ingest pump's
        # finished-output GC keys its per-shard watermark comparison on
        # these (frontend._gc_finished_outputs).
        doc["n"] = int(n)
    if shard is not None:
        doc["shard"] = int(shard)
    kv.put(SCOPE, f"out/{rid}", pickle.dumps(doc))


def _serve_epoch(ctx, engine, spec: dict, totals: Dict[str, Any],
                 profiler=None, swap: Optional[SwapManager] = None,
                 slo_plane: Optional[obs_slo.SLOPlane] = None,
                 tok_goodput: Optional[obs_goodput.TokenGoodput] = None):
    """One rendezvous epoch of the serving loop.  Returns the per-rank
    summary dict on a clean drain (``serve/stop``), raises
    HorovodShutdownError on a world break (the caller re-enters).

    Tracing (obs/trace.py, armed by ``HVDTPU_TRACE``): every sampled
    request's life through this loop lands as spans on its rid lane —
    the ttft components tile the [arrival, first-token] interval
    exactly (queue_wait + schedule_broadcast + admit_wait + prefill =
    the histogram's sample, same timestamps), and busy steps land
    step-lane spans (schedule_broadcast / prefill / decode_compute /
    stream_publish / whole-step; prefill twinned on the step lane
    unsampled, so the residual subtraction never depends on the sample
    rate) the tpot decomposition derives from.  Spans carry THIS epoch,
    not the env's spawn epoch: a survivor's single dump holds every
    epoch it lived through.  All on the host clock: no span waits for
    the device.  ``sched_ms`` in the returned summary are the host-clock
    ms of each busy step's schedule broadcast (the leader's put, a
    follower's fetch)."""
    reg = get_registry()
    epoch = ctx.rendezvous()
    width = int(spec.get("width") or 0)
    groups, group, group_world, standby = _fleet_shape(
        ctx.world, ctx.rank, width
    )
    reg.gauge("serve.world_size").set(ctx.size)
    reg.gauge("serve.groups").set(groups)
    if group is not None:
        # This rank's serving group: the digest sums tokens/sec ACROSS
        # groups (independent capacity) but takes the max WITHIN one
        # (replicated peers report the same stream).
        reg.gauge("serve.group").set(group)
    if standby:
        # World not divisible by the width: this rank is a hot standby
        # until the next resize makes it part of a group.  It still
        # heartbeats, ticks progress, and drains cleanly on stop.
        LOG.info("epoch %d: rank %d standing by (world %d, width %d)",
                 epoch, ctx.rank, ctx.size, width)
        while True:
            if ctx.world_changed():
                raise HorovodShutdownError(
                    f"epoch advanced past {epoch}; re-forming"
                )
            if ctx.kv.get(SCOPE, "stop") is not None:
                return {"rank": ctx.rank, "epoch": epoch, "steps": 0,
                        "standby": True,
                        "completed": totals["completed"],
                        "tokens": totals["tokens"]}
            obs_progress.tick()
            # A standby has nothing latency-sensitive to wake for:
            # pace its stop/world probes gently so a parked rank does
            # not tax the store the serving groups are using.
            time.sleep(max(float(spec.get("idle_secs", 0.01)), 0.05))
    if width > 1:
        _form_width_group(ctx, engine, epoch, group, group_world)
    leader = group_world[0]
    is_leader = ctx.rank == leader
    # The GLOBAL leader (lowest live rank) owns the compaction
    # watermark — the one piece of bookkeeping that must see every
    # group's completions.
    is_global = ctx.rank == ctx.world[0]
    scope = _epoch_scope(epoch)
    tracing = obs_trace.enabled()
    t_rate = obs_trace.sample_rate()

    # Epoch-start recovery broadcast: the group leader's replay of the
    # durable request record IS the schedule seed — every rank of the
    # group (survivor or fresh respawn) rebuilds the identical
    # scheduler state from it.  Groups recover independently; the log
    # partition (n % groups) makes their replays disjoint.
    t_rec0 = time.time()
    if is_leader:
        rec = _build_recovery(ctx.kv, group, groups,
                              _frontdoor_shape(ctx.kv))
        ctx.kv.put(scope, f"recovery/{group}", pickle.dumps(rec))
    else:
        rec = pickle.loads(_fetch(ctx, scope, f"recovery/{group}",
                                  f"recovery doc for epoch {epoch}"))
    # The interleave constant travels in the recovery doc: every rank
    # of the group derives the shard merge from the LEADER's read of
    # the front-door doc, not its own racy one.
    frontends = max(int(rec.get("frontends", 1)), 1)
    reg.gauge("serve.frontends").set(frontends)
    # Every rank converges on the durable weight version BEFORE any
    # replay prefill — a replayed request's rebuilt cache must be
    # computed under the version the new epoch serves.
    if swap is not None:
        swap.reset_epoch()
        swap.ensure_version(engine, rec.get("weight_version", 0))
    # Tenant-aware admission (spec["tenants"], TenantQoS.from_spec):
    # the policy object is a pure function of the spec, so every rank
    # of every group builds the identical one — the determinism
    # contract extends from the scheduler through its policy.
    sched = SlotScheduler(spec["num_slots"],
                          qos=TenantQoS.from_spec(spec.get("tenants")))
    engine.reset()
    log_next: Dict[int, int] = {int(s): int(n) for s, n in
                                rec["log_next"].items()}
    # Request-log compaction (global-leader-only writes, like every
    # other durable-record write): the (shard, n) log slot of every
    # in-flight request, the done set above the per-shard watermarks,
    # and the watermarks themselves.  ``other_rids`` maps the OTHER
    # groups' in-flight slots to rids — the global leader cannot see
    # their evictions directly, so it advances past them by polling
    # their published done docs (one O(1) KV get per head-of-watermark
    # candidate per shard per step).
    n_of: Dict[str, Tuple[int, int]] = {}
    done_slots = {(int(s), int(n))
                  for s, n in rec.get("done_slots", [])}
    other_rids: Dict[Tuple[int, int], str] = {
        (int(k[0]), int(k[1])): v
        for k, v in rec.get("others", {}).items()
    }
    watermark: Dict[int, int] = {int(s): int(w) for s, w in
                                 rec.get("watermark", {}).items()}

    def _advance_watermark() -> None:
        """Global-leader bookkeeping, now per front-door shard: fold
        finished log slots into each shard's watermark, push the new
        floor durably, THEN delete the compacted log keys (a crash
        between the two leaves orphan entries below the floor —
        harmless, the pump's GC sweeps them — never a floor above
        surviving entries).  Slots owned by other groups advance when
        their done doc is visible."""
        for shard in sorted(watermark):
            old = watermark[shard]
            mark = old
            while True:
                slot = (shard, mark)
                if slot in done_slots:
                    done_slots.discard(slot)
                    other_rids.pop(slot, None)
                    mark += 1
                    continue
                rid = other_rids.get(slot)
                if rid is not None:
                    raw = ctx.kv.get(SCOPE, f"out/{rid}")
                    if raw is not None and \
                            pickle.loads(raw).get("done"):
                        other_rids.pop(slot)
                        mark += 1
                        continue
                break
            if mark > old:
                watermark[shard] = mark
                ctx.kv.put(SCOPE, f"log_watermark/{shard}",
                           str(mark).encode())
                for i in range(old, mark):
                    ctx.kv.delete(SCOPE, f"log/{shard}/{i}")
        # One compaction gauge across shards: total retired entries.
        reg.gauge("serve.log_watermark").set(sum(watermark.values()))

    def _mark_done(rid: str) -> None:
        slot = n_of.pop(rid, None)
        if slot is not None:
            done_slots.add(slot)
        if is_global:
            _advance_watermark()

    def _reject_reason(entry) -> Optional[str]:
        """Full per-entry verdict: the frontend validation (including
        the tenant-budget feasibility check — a cost that exceeds the
        whole per-window budget would be throttled forever, bricking
        its tenant and freezing the shard's compaction watermark) plus
        the page-feasibility check (a request whose worst case exceeds
        the WHOLE page pool can never be admitted — rejecting it
        loudly beats a permanently head-blocked FCFS queue).  Pure —
        the qos policy is built from the spec every rank shares — so
        every rank and every group reaches the same verdict."""
        reason = validate_request(
            entry, engine.serve_len, engine.cfg.vocab_size,
            budget_tokens=(None if sched.qos is None
                           else sched.qos.budget_tokens),
        )
        if reason is None and engine.paged is not None:
            reason = page_reject_reason(
                len(entry["prompt"]), entry["max_new_tokens"],
                engine.page_size, engine.num_pages,
            )
        return reason

    def _entry_request(entry) -> Request:
        return Request(
            rid=entry["rid"], prompt=tuple(entry["prompt"]),
            max_new_tokens=entry["max_new_tokens"],
            eos_id=entry.get("eos_id"),
            arrival=entry.get("arrival", 0.0),
            temperature=float(entry.get("temperature") or 0.0),
            top_k=int(entry.get("top_k") or 0),
            tenant=str(entry.get("tenant") or "default"),
            slo=str(entry.get("slo") or "standard"),
        )

    def _entry_slot(entry) -> Optional[Tuple[int, int]]:
        """The entry's durable log slot ``(shard, n)`` — the compaction
        bookkeeping key (legacy docs without a shard stamp are shard
        0's, the only shard a pre-16 store ever had)."""
        if entry.get("n") is None:
            return None
        return (int(entry.get("shard") or 0), int(entry["n"]))

    # Admission capacity in FREE PAGES (paged mode): each round's gate
    # accumulates its own acceptances, so two same-round admissions are
    # never judged against the same free pool.  A deterministic
    # function of the schedule so far — the identical-schedule invariant extends
    # through this gate.

    replayed = 0
    for entry in rec["inflight"]:
        reason = _reject_reason(entry)
        if reason is not None:
            # Same accounting as the live path: a reject during replay
            # must show in serve.rejected too, or the runbook's
            # "rejected climbing" check misses exactly the rejects that
            # coincide with world breaks.
            reg.counter("serve.rejected").inc()
            if is_leader:
                _publish_out(ctx.kv, entry["rid"], tokens=(), done=True,
                             epoch=epoch, admitted_step=0, error=reason,
                             n=entry.get("n"),
                             shard=entry.get("shard"))
                if _entry_slot(entry) is not None:
                    n_of[entry["rid"]] = _entry_slot(entry)
                    _mark_done(entry["rid"])
            continue
        if is_leader and _entry_slot(entry) is not None:
            n_of[entry["rid"]] = _entry_slot(entry)
        sched.enqueue(_entry_request(entry),
                      resume=entry.get("emitted", ()))
        if entry.get("emitted"):
            replayed += 1
    if replayed:
        reg.counter("serve.replayed").inc(replayed)
        obs_flightrec.record(
            "init", name="serve_replay", cycle=epoch,
            detail=f"{replayed} in-flight requests replayed",
        )
        LOG.info("epoch %d: replaying %d in-flight requests", epoch,
                 replayed)
    if tracing:
        # The recovery span is the left edge of every replayed
        # request's second incarnation: the waterfall's gap between a
        # request's epoch-N spans and this span IS the recovery cost.
        obs_trace.add_span("serve.steps", "recovery", t_rec0,
                           time.time(), epoch=epoch, replayed=replayed)

    step = 0
    # the newest busy steps' schedule-broadcast ms (bounded: a serving
    # job runs for days)
    sched_ms: deque = deque(maxlen=_SCHED_KEEP * 16)
    rate_win = RateWindow()
    # Registry counters persist across epochs while sched state does
    # not: these epoch-local cursors turn the scheduler's cumulative
    # per-tenant numbers into counter increments exactly once.
    tenant_prev_throttled: Dict[str, int] = {}
    tenant_prev_admitted: Dict[str, int] = {}
    # slot-keyed decode-window starts for the per-N-token decode spans:
    # (wall t, tokens emitted at window start).
    dspan: Dict[int, Tuple[float, int]] = {}
    idle_secs = float(spec.get("idle_secs", 0.01))
    stream_every = max(int(spec.get("stream_every", 4)), 1)
    # A single-rank group has no peers to broadcast to: publishing the
    # step schedule would cost a signed KV roundtrip per step that
    # nobody reads (recovery never replays sched keys — it rebuilds
    # from log + out).  At ~2ms per roundtrip that is a large slice of
    # a CPU decode step, and it is exactly the fleet shape the width-1
    # scaling bench runs, so skip it.
    solo = len(group_world) == 1
    # Serving twin of the divergence sentinel (obs/divergence.py):
    # armed by --health, cadence --health-check-steps.  Solo groups
    # have no replica to diverge from, so they skip it entirely.
    from ..obs.health import HealthConfig  # noqa: PLC0415

    health_cfg = HealthConfig.from_env()
    health_every = (health_cfg.check_steps
                    if health_cfg.enabled and not solo else 0)
    # The drain sentinel is write-once; probing it every busy step is
    # another roundtrip per step.  Probe on idle steps and every 8th
    # busy step (drain latency <= 8 steps), and latch the first hit.
    stop_latched = False
    was_busy = False
    idle_streak = 0
    while True:
        step += 1
        t_step0 = time.time()
        # Deterministic chaos: the serving analog of the elastic
        # collective's step-boundary injection point — same spec
        # grammar, same epoch-0 default that keeps respawns convergent.
        maybe_fail("worker_exit", step=step, rank=ctx.rank)
        # Epoch-bump probe: one KV get.  Busy steps only probe every
        # 4th (detection lag <= 3 steps; peers blocked in _fetch watch
        # the epoch continuously, and heartbeat/progress monitoring is
        # out-of-band) — at CPU decode speeds an every-step probe was
        # a measurable slice of the serving loop.
        if (not was_busy or step % 4 == 0) and ctx.world_changed():
            raise HorovodShutdownError(
                f"epoch advanced past {epoch} (a peer died); "
                f"re-forming the serving world"
            )

        # -- schedule broadcast (the group leader reads the log and
        # keeps its partition n % groups == group; its peers follow) --
        if is_leader:
            new_entries = []
            # Log probe: one KV get per shard per step minimum.  When
            # the local queue already holds waiting work, new arrivals
            # cannot change THIS step's admissions (they join behind
            # the queue), so probe every 4th step; total order is the
            # gkey interleave's either way.  An empty queue probes
            # every step: that is the latency-sensitive case.
            probe = sched.queue_depth == 0 or step % 4 == 0
            for shard in (sorted(log_next) if probe else ()):
                while True:
                    cursor = log_next[shard]
                    raw = ctx.kv.get(SCOPE, f"log/{shard}/{cursor}")
                    if raw is None:
                        if groups > 1 and not is_global:
                            # The GLOBAL leader compacts log keys the
                            # moment a shard's contiguous prefix is
                            # done — keys THIS group's lagging cursor
                            # may not have scanned yet.  A gap at the
                            # cursor therefore means either "end of
                            # shard log" or "compacted under me":
                            # re-read the shard's watermark and jump
                            # over the deleted range, or this group's
                            # cursor polls a deleted key forever and
                            # its partition starves.
                            raw_wm = ctx.kv.get(
                                SCOPE, f"log_watermark/{shard}")
                            wm = (int(raw_wm.decode())
                                  if raw_wm is not None else 0)
                            if wm > cursor:
                                log_next[shard] = wm
                                continue
                        break
                    doc = pickle.loads(raw)
                    doc.setdefault("shard", shard)
                    doc.setdefault("n", cursor)
                    doc.setdefault("gkey",
                                   cursor * frontends + shard)
                    if int(doc["gkey"]) % groups == group:
                        new_entries.append(doc)
                    elif is_global:
                        # Another group's request: remember its rid so
                        # the compaction watermark can advance past it
                        # once its done doc lands.
                        other_rids[(shard, cursor)] = doc["rid"]
                    log_next[shard] = cursor + 1
            # Shard scans are sequential; the schedule's enqueue order
            # is the gkey interleave, identical on every rank and
            # every replay.
            new_entries.sort(key=lambda d: d["gkey"])
            if not stop_latched and (not was_busy or step % 8 == 0):
                stop_latched = ctx.kv.get(SCOPE, "stop") is not None
            sdoc = {"new": new_entries, "stop": stop_latched}
            if swap is not None:
                # The poll-and-flip decision travels the SAME broadcast
                # lane as admissions: derived from shared data (the
                # committed manifest + the ranks' prefetch votes) by
                # the group leader alone, obeyed by its group — the
                # serving form of "all ranks agree to deviate".
                sw = swap.leader_step(ctx.kv, scope, group_world, step)
                if sw is not None:
                    sdoc["swap"] = sw
            sdoc_raw = pickle.dumps(sdoc) if not solo else b""
            if not solo:
                ctx.kv.put(scope, f"sched/{group}/{step}", sdoc_raw)
                if step > _SCHED_KEEP:
                    ctx.kv.delete(scope,
                                  f"sched/{group}/{step - _SCHED_KEEP}")
        else:
            sdoc_raw = _fetch(
                ctx, scope, f"sched/{group}/{step}",
                f"schedule for group {group} step {step}")
            sdoc = pickle.loads(sdoc_raw)
        t_sched = time.time()
        if not solo:
            # The reference's "schedule_broadcast" span, host clock: the
            # leader's log probe and put, or a follower's wait for them.
            sched_ms.append((t_sched - t_step0) * 1000.0)

        # -- serving divergence sentinel: digest the schedule doc this
        # rank is about to obey + its page-table state, compare across
        # the width group (every rank, identical verdict) ----------------
        if health_every and step % health_every == 0:
            _serve_health_check(ctx, scope, group, group_world, step,
                                sdoc_raw, getattr(engine, "paged", None),
                                health_cfg.divergence_action)

        # -- weight hot-swap transitions (between decode steps, before
        # this step's admissions: a flip is version-stamped to exactly
        # this step on every rank) --------------------------------------
        if swap is not None and sdoc.get("swap"):
            swap.apply(sdoc["swap"], engine, ctx.kv, scope, ctx.rank,
                       epoch, step)

        for entry in sdoc["new"]:
            reason = _reject_reason(entry)
            if reason is not None:
                reg.counter("serve.rejected").inc()
                if is_leader:
                    _publish_out(ctx.kv, entry["rid"], tokens=(),
                                 done=True, epoch=epoch,
                                 admitted_step=0, error=reason,
                                 n=entry.get("n"),
                                 shard=entry.get("shard"))
                    if _entry_slot(entry) is not None:
                        n_of[entry["rid"]] = _entry_slot(entry)
                        _mark_done(entry["rid"])
                continue
            if is_leader and _entry_slot(entry) is not None:
                n_of[entry["rid"]] = _entry_slot(entry)
            sched.enqueue(_entry_request(entry))

        # -- admissions: queued -> free slots (and, in paged mode,
        # free PAGES for the head request's worst case), prefill each
        busy_before = sched.active_slots
        admissions = sched.admit(step, can_admit=engine.admission_gate())
        for adm in admissions:
            t_a0 = time.time()
            # Deterministic OOM chaos on the prefill-allocation path:
            # admission is where a real fleet usually dies (a long
            # prompt's prefill is the allocation spike).
            memplane.alloc_guard("assign_slot", rank=ctx.rank)
            tok = engine.admit(
                adm.slot, adm.req.prompt, adm.resume,
                total_len=len(adm.req.prompt) + adm.req.max_new_tokens,
                temperature=adm.req.temperature, top_k=adm.req.top_k,
                rid=adm.req.rid,
            )
            t_a1 = time.time()
            # A recycled slot must never inherit the previous tenant's
            # decode-window mark.
            dspan.pop(adm.slot, None)
            req_traced = tracing and obs_trace.sampled(adm.req.rid,
                                                       t_rate)
            if tracing:
                # Step-lane twin of the request-lane prefill span,
                # ungated on per-request sampling: the tpot report
                # subtracts named phases from the whole-step span.
                obs_trace.add_span("serve.steps", "prefill", t_a0, t_a1,
                                   epoch=epoch, step=step,
                                   slot=adm.slot)
            if tok is None:
                # Replay rebuild; its tokens already streamed.  The
                # replay_prefill span marks the second incarnation's
                # restart point on the request's lane.
                if req_traced:
                    obs_trace.add_span(
                        adm.req.rid, "replay_prefill", t_a0, t_a1,
                        epoch=epoch, step=step, slot=adm.slot,
                        resumed=len(adm.resume),
                    )
                    dspan[adm.slot] = (t_a1, len(adm.resume))
                continue
            sched.record(adm.slot, tok)
            rate_win.observe(t_a1, 1)
            if req_traced:
                dspan[adm.slot] = (t_a1, 1)
            # Dedup by rid, like evictions: a request admitted just
            # before a world break whose first out doc never landed is
            # re-admitted as fresh on replay, and survivors' counters
            # persist across epochs — without the set, admitted/ttft
            # would over-count exactly the break-coincident requests.
            if adm.req.rid in totals["admitted_rids"]:
                continue
            totals["admitted_rids"].add(adm.req.rid)
            reg.counter("serve.admitted").inc()
            if busy_before > 0:
                # The continuous-batching moment: this request entered
                # while other slots were mid-decode.
                reg.counter("serve.admitted_while_busy").inc()
            ttft_ms = None
            if adm.req.arrival:
                # Measured at t_a1 — the same instant that closes the
                # prefill span, so the trace report's component sum and
                # this histogram's sample agree by construction.
                ttft_ms = max(t_a1 - adm.req.arrival, 0.0) * 1000.0
                reg.histogram("serve.ttft_ms").observe(ttft_ms)
                if slo_plane is not None:
                    # The SLO accountant sees the SAME sample with its
                    # tenant tag: objectives are judged per
                    # (tenant, class), never on the fleet aggregate.
                    slo_plane.observe_ttft(adm.req.tenant, adm.req.slo,
                                           ttft_ms, t_a1)
            if req_traced:
                # The four spans tile [arrival, first token] exactly:
                # queue_wait ends where this step began, the broadcast
                # span covers the schedule fetch, admit_wait absorbs
                # validation plus same-step earlier prefills, and
                # prefill is the engine.admit call whose result IS the
                # first token.  The ingest pump appends concurrently
                # with this loop, so an arrival can land inside
                # (t_step0, t_sched]: schedule_broadcast then starts at
                # the arrival, or the components would over-tile.
                t_q1 = t_step0
                if adm.req.arrival:
                    t_q1 = min(max(adm.req.arrival, t_step0), t_sched)
                    obs_trace.add_span(
                        adm.req.rid, "queue_wait",
                        min(adm.req.arrival, t_q1), t_q1,
                        epoch=epoch, step=step,
                    )
                obs_trace.add_span(adm.req.rid, "schedule_broadcast",
                                   t_q1, t_sched, epoch=epoch,
                                   step=step)
                obs_trace.add_span(adm.req.rid, "admit_wait", t_sched,
                                   t_a0, epoch=epoch, step=step)
                obs_trace.add_span(
                    adm.req.rid, "prefill", t_a0, t_a1, epoch=epoch,
                    step=step, slot=adm.slot,
                    prompt_len=len(adm.req.prompt),
                    ttft_ms=(round(ttft_ms, 3)
                             if ttft_ms is not None else None),
                )
        evictions = sched.evict_finished()
        for ev in evictions:
            # Paged mode: an eviction returns the slot's pages to the
            # free list immediately — the very next admissions (this
            # step's were already decided) can reuse them.
            engine.release_slot(ev.slot)

        # -- one decode iteration over the live slots ----------------
        active = sorted(sched.active)
        if active:
            t_d0 = time.time()
            memplane.alloc_guard("decode_step", rank=ctx.rank)
            toks = engine.step(active)
            t_d1 = time.time()
            step_ms = (t_d1 - t_d0) * 1000.0
            for slot in active:
                sched.record(slot, toks[slot])
                reg.histogram("serve.tpot_ms").observe(step_ms)
                if slo_plane is not None:
                    req = sched.active[slot].req
                    slo_plane.observe_tpot(req.tenant, req.slo,
                                           step_ms, t_d1)
            rate_win.observe(t_d1, len(active))
            if profiler is not None:
                profiler.observe(t_d1 - t_d0)
            if tracing:
                obs_trace.add_span("serve.steps", "decode_compute",
                                   t_d0, t_d1, epoch=epoch, step=step,
                                   slots=len(active))
                # Per-request decode windows: flush a span to the rid
                # lane every _DECODE_SPAN_TOKENS tokens.
                for slot in active:
                    mark = dspan.get(slot)
                    if mark is None:
                        continue
                    n = len(sched.active[slot].emitted)
                    if n - mark[1] >= _DECODE_SPAN_TOKENS:
                        obs_trace.add_span(
                            sched.active[slot].req.rid, "decode",
                            mark[0], t_d1, epoch=epoch, step=step,
                            tokens=n - mark[1],
                        )
                        dspan[slot] = (t_d1, n)
            post = sched.evict_finished()
            for ev in post:
                engine.release_slot(ev.slot)
            evictions += post

        # -- stream results (leader only writes; peers computed the
        # identical tokens and discard them) -------------------------
        t_p0 = time.time()
        if is_leader:
            for slot in sorted(sched.active):
                act = sched.active[slot]
                n = len(act.emitted)
                # Batched streaming: republishing the full token list
                # every step is O(T^2) signed bytes per request.  The
                # first token goes out immediately (ttft is real), then
                # every stream_every-th; eviction publishes the rest.
                # A world break between publishes costs at most
                # stream_every tokens of deterministic recompute.
                if n <= 1 or n % stream_every == 0:
                    _publish_out(ctx.kv, act.req.rid,
                                 tokens=act.emitted, done=False,
                                 epoch=epoch,
                                 admitted_step=act.admitted_step)
        for ev in evictions:
            if is_leader:
                slot_ref = n_of.get(ev.rid)
                _publish_out(ctx.kv, ev.rid, tokens=ev.tokens,
                             done=True, epoch=epoch,
                             admitted_step=ev.admitted_step,
                             finished_step=step, reason=ev.reason,
                             n=None if slot_ref is None else slot_ref[1],
                             shard=(None if slot_ref is None
                                    else slot_ref[0]),
                             t_done=time.time())
                # Done doc durably published -> this log index can
                # leave the replay set; the watermark advances and the
                # compacted log keys are deleted.
                _mark_done(ev.rid)
            # Dedup by rid: a request a peer finished just before a
            # world break (its done doc never published) is replayed
            # and finished AGAIN on that peer — without the set, its
            # completed/evicted accounting would diverge from the
            # other ranks'.
            if ev.rid not in totals["done_rids"]:
                totals["done_rids"].add(ev.rid)
                reg.counter("serve.evicted").inc()
                totals["completed"] += 1
            mark = dspan.pop(ev.slot, None)
            if tracing and obs_trace.sampled(ev.rid, t_rate):
                t_fin = time.time()
                if mark is not None and len(ev.tokens) > mark[1]:
                    obs_trace.add_span(ev.rid, "decode", mark[0], t_fin,
                                       epoch=epoch, step=step,
                                       tokens=len(ev.tokens) - mark[1])
                obs_trace.add_span(ev.rid, "finish", t_fin, t_fin,
                                   epoch=epoch, step=step,
                                   reason=ev.reason,
                                   tokens=len(ev.tokens),
                                   resumed=ev.resumed)

        # -- gauges + progress beat ----------------------------------
        t_step1 = time.time()
        busy = bool(active or admissions or sdoc["new"] or evictions)
        if not busy and sched_ms:
            sched_ms.pop()  # only busy steps' broadcasts are timed
        was_busy = busy
        if tracing and busy:
            if is_leader:
                obs_trace.add_span("serve.steps", "stream_publish",
                                   t_p0, t_step1, epoch=epoch,
                                   step=step)
            obs_trace.add_span("serve.steps", "schedule_broadcast",
                               t_step0, t_sched, epoch=epoch, step=step)
            obs_trace.add_span("serve.steps", "step", t_step0, t_step1,
                               epoch=epoch, step=step,
                               active=len(active))
        reg.gauge("serve.queue_depth").set(sched.queue_depth)
        reg.gauge("serve.active_slots").set(sched.active_slots)
        if sched.qos is not None and busy:
            # Per-tenant plane (tagged series): queue depth now, plus
            # throttle/admission counters advanced by the scheduler's
            # cumulative state (epoch-local) — deltas land in both the
            # registry (for /metrics + --stats-summary) and totals
            # (for the drain summary, which must span epochs).
            for tenant, depth in sched.tenant_depths().items():
                reg.gauge("serve.tenant.queued",
                          tenant=tenant).set(depth)
            for tenant in sorted(sched.throttled):
                delta = sched.throttled[tenant] \
                    - tenant_prev_throttled.get(tenant, 0)
                if delta:
                    tenant_prev_throttled[tenant] = \
                        sched.throttled[tenant]
                    reg.counter("serve.tenant.throttled",
                                tenant=tenant).inc(delta)
                    totals["tenant_throttled"][tenant] = \
                        totals["tenant_throttled"].get(tenant, 0) \
                        + delta
            for tenant in sorted(sched.admitted_tokens):
                delta = sched.admitted_tokens[tenant] \
                    - tenant_prev_admitted.get(tenant, 0)
                if delta:
                    tenant_prev_admitted[tenant] = \
                        sched.admitted_tokens[tenant]
                    reg.counter("serve.tenant.admitted_tokens",
                                tenant=tenant).inc(delta)
                    totals["tenant_admitted_tokens"][tenant] = \
                        totals["tenant_admitted_tokens"].get(
                            tenant, 0) + delta
        # KV occupancy: what the pool reserves for the busy slots vs
        # the positions they actually wrote.
        kv = engine.kv_stats(sched.active)
        reg.gauge("serve.kv.allocated_bytes").set(kv["allocated_bytes"])
        reg.gauge("serve.kv.live_bytes").set(kv["live_bytes"])
        reg.gauge("serve.kv.waste_ratio").set(kv["waste_ratio"])
        if "page_size" in kv:
            # Page-granular pool gauges (paged mode): what admission
            # capacity is actually judged in.
            reg.gauge("serve.kv.page_size").set(kv["page_size"])
            reg.gauge("serve.kv.page_free").set(kv["pages_free"])
            reg.gauge("serve.kv.page_used").set(kv["pages_used"])
        if kv["allocated_bytes"] > 0:
            # Busy-step waste aggregate for the drain summary (the
            # gauges only show the LAST step, which at drain is an
            # idle pool).
            totals["kv_busy_steps"] += 1
            totals["kv_waste_sum"] += kv["waste_ratio"]
            totals["kv_alloc_peak"] = max(totals["kv_alloc_peak"],
                                          kv["allocated_bytes"])
            contig = kv.get("contiguous_equiv_bytes", 0)
            if contig > 0:
                # The same step judged by the contiguous design's
                # worst-case reservation on this very traffic.
                totals["kv_contig_waste_sum"] += (
                    1.0 - kv["live_bytes"] / contig
                )
        if is_global:
            # Pick up OTHER groups' completions (their done docs) so
            # the compaction floor keeps moving even when this group
            # is idle.
            _advance_watermark()
        # Sliding wall-clock window, fed the SAME timestamps the
        # decode-compute spans carry: the digest and the trace report
        # cannot disagree about throughput.
        reg.gauge("serve.tokens_per_sec").set(rate_win.rate(t_step1))
        reg.counter("serve.steps").inc()
        step_tokens = len(active) + sum(
            1 for a in admissions if not a.resume
        )
        totals["tokens"] += step_tokens
        if tok_goodput is not None:
            # Token goodput: tokens actually decoded over slot-step
            # capacity — idle steps count zero tokens on a full pool,
            # which is exactly the wasted capacity the fraction must
            # show.  Published beside the KV-occupancy gauges above.
            tok_goodput.observe_step(step_tokens)
            tok_goodput.publish(reg, t_step1)
        if slo_plane is not None:
            # Burn-rate accounting every step: the two-window alerts
            # land in serve.slo.* (live stream + digest + summary) the
            # same step they start firing.
            slo_plane.publish(reg, t_step1)
        obs_progress.tick()

        if sdoc["stop"] and sched.idle():
            LOG.info("serving drained at epoch %d step %d", epoch, step)
            out = {
                "rank": ctx.rank,
                "epoch": epoch,
                "steps": step,
                "completed": totals["completed"],
                "tokens": totals["tokens"],
                "admitted_while_busy": int(
                    reg.counter("serve.admitted_while_busy").value
                ),
                "frontends": frontends,
                "sched_ms": list(sched_ms),
                # this process's launches of the repo's kernels: the
                # serving path runs none (decode and prefill attend with
                # their own einsums, as the reference's)
                "kernel_launches": {n: c for n, c in fa.LAUNCHES.items()
                                    if c},
            }
            if sched.qos is not None:
                # Per-tenant accounting across every epoch this rank
                # lived through: what the noisy-tenant gate asserts
                # the flooder was throttled by.
                tenants = sorted(
                    set(totals["tenant_throttled"])
                    | set(totals["tenant_admitted_tokens"])
                )
                out["tenants"] = {
                    t: {
                        "throttled":
                            totals["tenant_throttled"].get(t, 0),
                        "admitted_tokens":
                            totals["tenant_admitted_tokens"].get(t, 0),
                    }
                    for t in tenants
                }
            if slo_plane is not None and slo_plane.observed:
                # The SLO verdict travels with the drain summary: what
                # bench records and --stats-summary judge the latency
                # objectives by.
                out["slo"] = slo_plane.summary(time.time())
            if tok_goodput is not None:
                t_now = time.time()
                out["goodput"] = {
                    "token_fraction": round(tok_goodput.fraction(), 6),
                    "tokens_per_slot_sec": round(
                        tok_goodput.per_slot_second(t_now), 4),
                }
                ledger = obs_goodput.get_ledger()
                if ledger is not None:
                    # The wall-clock ledger's story for this rank:
                    # fractions per class + the per-epoch lost-time
                    # attribution.
                    out["goodput"]["wall"] = ledger.summary(t_now)
            if swap is not None:
                # Every rank reports the version it drained on — the
                # single-version chaos gate asserts these agree.
                out["weight_version"] = swap.version
                out["weight_flips"] = [list(f) for f in swap.flips]
            if profiler is not None:
                out["perf"] = profiler.summary()
            # The rank's memory story rides the drain summary: the
            # census (owners, device totals) and the KV pool's bytes.
            mem = memplane.memory_record()
            mem["kv_pool_bytes"] = engine.kv_stats(())["pool_bytes"]
            out["memory"] = mem
            # KV-occupancy verdict over the whole run (busy steps
            # only — the drained pool is trivially empty), beside what
            # the contiguous design would have reserved.
            out["kv"] = {
                "mode": engine.kv_mode,
                "waste_ratio_mean": (
                    totals["kv_waste_sum"]
                    / max(totals["kv_busy_steps"], 1)
                ),
                "contiguous_equiv_waste_mean": (
                    totals["kv_contig_waste_sum"]
                    / max(totals["kv_busy_steps"], 1)
                ),
                "allocated_peak_bytes": totals["kv_alloc_peak"],
                "pool_bytes": mem["kv_pool_bytes"],
            }
            if engine.paged is not None:
                out["kv"]["page_size"] = engine.page_size
                out["kv"]["num_pages"] = engine.num_pages
            if width:
                out["kv"]["width"] = width
                out["group"] = group
            return out
        if not active and not admissions and not sdoc["new"] and is_leader:
            # Idle pacing: peers are paced by the schedule fetch; the
            # leader throttles itself so an empty queue costs a few KV
            # gets per idle_secs, not a busy loop.  The pace BACKS OFF
            # exponentially (cap 16x) — a drained group polling at
            # full rate measurably slows the groups still serving
            # through the shared store; the cost is bounded extra
            # admission latency on an idle fleet.
            idle_streak += 1
            time.sleep(min(idle_secs * (1 << min(idle_streak, 4)),
                           idle_secs * 16))
        else:
            idle_streak = 0


def build_model(spec: dict):
    """The served model: ``gpt(spec["size"], **spec["overrides"])`` with
    its weights drawn from ``torch.Generator().manual_seed(spec["seed"])``
    (the same on every rank), on ``spec["device"]`` — this rank's GPU
    when None (``cuda:local_rank``; raises with no GPU visible)."""
    import torch  # noqa: PLC0415

    from ..basics import _resolve_device  # noqa: PLC0415
    from ..models.transformer import gpt  # noqa: PLC0415

    device = _resolve_device(spec.get("device"), 0)
    gen = torch.Generator().manual_seed(int(spec["seed"]))
    return gpt(spec["size"], device=device, generator=gen,
               **spec.get("overrides", {}))


def serve_worker(spec: Optional[dict] = None):
    """The per-rank serving entry: run continuous-batching inference
    until the drain sentinel, surviving world re-formations.

    Launch with :class:`ServeJob` (python API), ``hvdrun --elastic
    --serve`` (CLI), or any elastic launcher wiring that serves this
    function.  Requires the elastic context (the request plane IS the
    launcher's KV store)."""
    import torch  # noqa: PLC0415

    from .. import elastic  # noqa: PLC0415
    from .engine import SlotEngine  # noqa: PLC0415

    merged = dict(DEFAULT_SPEC)
    merged.update(spec or {})
    spec = merged
    ctx = elastic.context()
    if not hasattr(ctx, "kv"):
        raise RuntimeError(
            "serve_worker needs the elastic launcher (the request log "
            "and result streams live in its KV store); run it via "
            "ServeJob or `hvdrun --elastic --serve`"
        )

    obs_progress.set_phase("compile")
    width = int(spec.get("width") or 0)
    model = build_model(spec)
    # a width-sharded engine is bound to its group each epoch
    engine = SlotEngine(
        model, spec["num_slots"], spec.get("max_len"),
        kv_mode=spec.get("kv_mode") or "paged",
        page_size=int(spec.get("page_size") or 16),
        num_pages=spec.get("kv_pages"),
        width=max(width, 1), width_axis=None,
        sample_seed=int(spec.get("seed") or 0),
    )
    # The serving MFU accountant: decode-step FLOPs counted from the
    # shapes over the measured step time, published live as perf.*
    # gauges (estimate-flagged on a device without a peak).
    from ..obs.profile import MFUProfiler  # noqa: PLC0415

    flops = engine.step_flops()
    dev = engine.device
    profiler = MFUProfiler(
        flops, torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu", source="shapes")
    # Memory plane: the engine registered its owner tags (kv_cache,
    # params) at construction; arming the census collector here makes
    # every live-stream snapshot carry mem.* gauges.
    memplane.install_census()
    # Weight hot-swap rider (spec["weights_dir"]): versions survive
    # epoch re-formation on this object; version 0 is the seed-derived
    # init weights every rank built identically above.
    swap = None
    if spec.get("weights_dir"):
        swap = SwapManager(
            spec["weights_dir"],
            {k: v.detach().cpu().clone()
             for k, v in model.state_dict().items()},
            poll_steps=int(spec.get("swap_poll_steps") or 16),
        )
        get_registry().gauge("serve.weight_version").set(0)
    totals = {"completed": 0, "tokens": 0,
              "kv_busy_steps": 0, "kv_waste_sum": 0.0,
              "kv_contig_waste_sum": 0.0,
              "kv_alloc_peak": 0, "done_rids": set(),
              "admitted_rids": set(),
              "tenant_throttled": {}, "tenant_admitted_tokens": {}}
    # Goodput + SLO planes, built ONCE per process so their sliding
    # windows and lost-time books span world re-formations: the
    # wall-clock ledger (fed by the flight-recorder tap), the
    # token-goodput accountant over the slot pool, and the per-tenant
    # burn-rate plane from the spec's objectives.
    obs_goodput.install()
    tok_goodput = obs_goodput.TokenGoodput(spec["num_slots"],
                                           time.time())
    slo_plane = obs_slo.SLOPlane(obs_slo.targets_from_spec(spec))
    from ..exceptions import RankDroppedError  # noqa: PLC0415

    while True:
        try:
            return _serve_epoch(ctx, engine, spec, totals, profiler,
                                swap, slo_plane, tok_goodput)
        except RankDroppedError:
            # The launcher re-minted a world without us (a shrink past
            # this rank, or autoscale dropping it deliberately).  That is a clean release, not a failure —
            # exit 0 with a summary.  (RankDroppedError subclasses
            # HorovodShutdownError, so this arm must come first.)
            LOG.info("rank %d released from the serving world; exiting "
                     "cleanly", ctx.rank)
            get_registry().counter("serve.released").inc()
            return {
                "rank": ctx.rank,
                "released": True,
                "completed": totals["completed"],
                "tokens": totals["tokens"],
            }
        except (HorovodShutdownError, RuntimeError) as exc:
            if not isinstance(exc, HorovodShutdownError) and not (
                    width > 1 and _width_group_failed(exc)):
                raise
            LOG.warning("serving world broke (%s); re-forming", exc)
            if width > 1:
                _leave_width_group()
            ctx.notify_world_broken()
            reg = get_registry()
            reg.counter("serve.world_breaks").inc()
            continue


class ServeJob:
    """Python-API driver: one object that owns the launcher side of a
    serving job — KV store, front door, elastic worker fleet — and hands
    back a :class:`ServeClient` for submitting and streaming.

    ::

        job = ServeJob({"size": "nano", "num_slots": 4, "device": "cpu"},
                       np=2)
        job.start()
        rid = job.client.submit([5, 17, 3], max_new_tokens=8)
        tokens = job.client.result(rid)["tokens"]
        job.stop()

    The elastic fleet runs ``serve_worker`` through the standard
    ``elastic.worker`` entry, so rank death -> blacklist -> respawn ->
    replay all behave exactly as a training job's would.
    """

    def __init__(self, spec: Optional[dict] = None, np: int = 1, *,
                 env: Optional[Dict[str, str]] = None,
                 max_retries: int = 3,
                 min_workers: Optional[int] = None,
                 max_workers: Optional[int] = None,
                 autoscale: Optional[dict] = None,
                 heartbeat_timeout: float = 60.0,
                 progress_timeout: float = 300.0,
                 blacklist_cooldown: float = 0.5,
                 live_stats_secs: Optional[float] = None,
                 live_history: Optional[str] = None,
                 timeout: Optional[float] = None):
        """``spec["weights_dir"]`` arms weight hot-swap on every rank.
        ``live_stats_secs`` / ``live_history``: the live telemetry plane
        (per-rank snapshots into this job's store, the console digest,
        ``live_history.jsonl`` and ``GET /metrics`` on :attr:`port`).
        ``autoscale``: a dict of :class:`~.autoscale.AutoscaleConfig`
        overrides (``scale_up_queue``, ``scale_down_idle_secs``, ...)
        turning on load-driven grow/shrink between ``min_workers`` and
        ``max_workers`` (default np); it needs live stats, so a missing
        ``live_stats_secs`` defaults to 0.5 when autoscale is on."""
        from ..run.rendezvous import KVStoreServer  # noqa: PLC0415

        self.spec = dict(DEFAULT_SPEC)
        self.spec.update(spec or {})
        self.np = np
        self._env = dict(env or {})
        if autoscale is not None and live_stats_secs is None:
            live_stats_secs = 0.5
        self._launch_kw = dict(
            max_retries=max_retries, min_workers=min_workers,
            max_workers=max_workers, autoscale=autoscale,
            heartbeat_timeout=heartbeat_timeout,
            progress_timeout=progress_timeout,
            blacklist_cooldown=blacklist_cooldown,
            live_stats_secs=live_stats_secs, live_history=live_history,
            job_timeout=timeout,
        )
        self._server = KVStoreServer()
        self._server.start()
        # The sharded front door: F ingest pumps (spec["frontends"])
        # plus the heartbeat supervisor that survives any one pump's
        # death by handing its shards to the lowest survivor.
        self._pump = FrontDoor(
            self._server,
            frontends=int(self.spec.get("frontends") or 1),
        )
        self.addr = f"127.0.0.1:{self._server.port}"
        self.client = ServeClient(self.addr, self._server.secret)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._results: Optional[Dict[int, Any]] = None
        self._job = None

    @property
    def front_door(self) -> FrontDoor:
        """The sharded ingest plane (chaos hooks ``kill(fid)`` /
        ``poll_takeover()`` and the per-shard ``stats()`` live here)."""
        return self._pump

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def secret(self) -> str:
        return self._server.secret

    def start(self) -> "ServeJob":
        from ..run.api import _pickle_func  # noqa: PLC0415
        from ..run.rendezvous import KVStoreClient  # noqa: PLC0415
        from ..run.runner import launch_elastic_job  # noqa: PLC0415

        kv = KVStoreClient(self.addr, self._server.secret)
        kv.put("elastic", "func",
               _pickle_func(serve_worker, (self.spec,), {}))
        self._pump.start()

        def _run():
            try:
                job = launch_elastic_job(
                    [sys.executable, "-m",
                     "horovod_tpu_torch.elastic.worker"],
                    self.np, kv_server=self._server, env=self._env,
                    front_door=self._pump,
                    **self._launch_kw,
                )
                results: Dict[int, Any] = {}
                for rank in job.world:
                    blob = kv.wait("elastic", f"result_{rank}",
                                   timeout=30)
                    ok, value = pickle.loads(blob)
                    if not ok:  # pragma: no cover - monitor aborts first
                        raise RuntimeError(f"rank {rank} raised:\n{value}")
                    results[rank] = value
                self._results = results
                self._job = job
            except BaseException as exc:  # surfaced by stop()/wait()
                self._error = exc

        self._thread = threading.Thread(
            target=_run, name="hvdtpu_serve_job", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 180.0) -> Tuple[Dict[int, Any], Any]:
        """Drain and tear down: raise the stop sentinel, wait for the
        fleet to finish, return ``(per_rank_results, ElasticJobResult)``.
        """
        self.client.stop()
        return self.wait(timeout)

    def wait(self, timeout: float = 180.0) -> Tuple[Dict[int, Any], Any]:
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"serving fleet did not drain within {timeout}s"
                )
            self._thread = None
        try:
            if self._error is not None:
                raise self._error
            return self._results or {}, self._job
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        """Release launcher-side resources (idempotent).  Under
        ``HVDTPU_TRACE`` (this process's env or the job's ``env``) also
        dump the launcher's own spans and merge every rank's into the
        per-request waterfall and latency-decomposition report: the
        python-API twin of the ``hvdrun --trace`` end-of-job merge."""
        try:
            self._pump.stop()
        except Exception:  # pragma: no cover - defensive
            pass
        try:
            self._server.stop()
        except Exception:  # pragma: no cover - defensive
            pass
        try:
            import os  # noqa: PLC0415

            from ..utils import env as envmod  # noqa: PLC0415

            raw = self._env.get(envmod.TRACE) \
                or os.environ.get(envmod.TRACE)
            if raw:
                # Explicit path: the dump target may be armed only in
                # the workers' env dict, not this process's os.environ.
                obs_trace.flush(obs_trace.resolve_dump_path(raw))
                from ..obs import trace_merge  # noqa: PLC0415

                out = trace_merge.merge_glob(raw,
                                             expected_ranks=self.np)
                if out is not None:
                    LOG.info("merged trace -> %s (report %s)",
                             out["waterfall"], out["report"])
        except Exception:  # pragma: no cover - defensive
            pass

    def __enter__(self) -> "ServeJob":
        return self.start()

    def __exit__(self, *exc) -> None:
        try:
            if exc[0] is None:
                self.stop()
        finally:
            self.shutdown()
