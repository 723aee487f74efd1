"""The eager-path background engine (counterpart of
``horovod_tpu/runtime/engine.py``, on torch tensors).

Reference architecture (horovod/common/operations.cc): one background
thread per process owns all communication; framework threads enqueue
named TensorTableEntries and get async handles; the thread runs a cycle
of [negotiate -> execute fused responses -> fire callbacks] (RunLoopOnce,
operations.cc:550; PerformOperation, operations.cc:232).

The structure, names, negotiation and replay logic are the JAX engine's;
what changes is the transport under them:

* **Single-process worlds skip the thread entirely** — collectives over a
  world of one are identities (with the scales applied); the future
  resolves at enqueue, and a tensor comes back as itself.
* **Negotiation transport** (``_exchange``): two ``all_gather`` calls of
  uint8 CPU tensors (a fixed-size control vector, then the padded
  serialized RequestLists only when some rank has one) on the gloo group
  the engine owns (``basics.EngineGroups.control``).
* **Data transport** (``runtime/device_plane.py``): each fused response
  is one collective over a group the engine owns: NCCL when every rank's
  payload is a CUDA tensor (``Request.device``, ANDed over ranks by the
  controller), the gloo group otherwise.  CUDA payloads never leave the
  card: every op, Adasum included, has a device path, and
  ``stats["host_data_ops"]`` counts only host payloads.
* **Stream order** (the reference's ReadyEvent, torch/ready_event.cc):
  ``enqueue`` snapshots a CUDA payload on the caller's current stream and
  records an event after the copy; the engine's own stream waits on that
  event (the host never does) before packing the payload into the
  persistent fusion buffer of its (device, dtype); the NCCL collective
  runs after the packing in stream order; each result is copied out of
  the buffer on the engine's stream and a completion event is recorded,
  which ``ops.eager.synchronize`` makes the caller's stream wait on.
* Shutdown is coordinated through the negotiation itself (any rank's flag
  ends the job for everyone, reference controller.cc:256-259,309): cycles
  are collective, so a rank that stopped cycling unilaterally would
  deadlock its peers — the flag makes every loop exit on the same cycle.
  ``basics.shutdown`` stops the engine before it destroys the groups.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..basics import global_topology
from ..exceptions import HorovodShutdownError
from ..obs import flightrec as obs_flightrec
from ..obs import get_registry
from ..obs import progress as obs_progress
from ..obs import trace as obs_trace
from ..ops.collectives import ReduceOp, _all_gather_single
from ..testing.faults import maybe_fail
from ..utils import env as envmod
from . import response_cache as rcache
from . import timeline as timeline_mod
from .autotune import ParameterManager, TunedParams, build_categories
from .controller import ControllerState, _fuse, compute_responses
from .device_plane import DCN_WIRES, DataPlane
from .messages import Request, RequestList, RequestType, Response, ResponseType

LOG = logging.getLogger(__name__)

# Reference defaults: fusion 64 MB (operations.cc:419), cycle 5 ms
# (operations.cc:427); the python control plane pays ~1 ms per control
# allgather, so the multi-process default cycle is a touch longer.
DEFAULT_FUSION_BYTES = envmod.DEFAULT_FUSION_BYTES
DEFAULT_CYCLE_MS_SINGLE = 1.0
DEFAULT_CYCLE_MS_MULTI = 10.0

SHUT_DOWN_ERROR = (
    "horovod_tpu_torch has been shut down. This was caused by an exception "
    "on one of the ranks or an asymmetric shutdown; check the logs of other "
    "ranks.  (reference: common.h:154-159)"
)
DUPLICATE_NAME_ERROR = (
    "Requested to {op} a tensor with the same name as another tensor that is "
    "currently being processed.  (reference: common.h:161-164)"
)

# Host payloads the gloo plane reduces in place (the reference's staged
# set); 64-bit dtypes and bool take the exact raw-bytes gather, as there.
_STAGEABLE_DTYPES = frozenset(
    {"float32", "float16", "bfloat16", "int32", "int8", "uint8"}
)


def dtype_name(dtype: torch.dtype) -> str:
    """The negotiated dtype string: numpy's name for the dtype
    (``float32``, ``bfloat16``, ``int64``, ``bool``)."""
    return str(dtype).removeprefix("torch.")


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def _numel(shape) -> int:
    return int(np.prod(shape)) if shape else 1


def _response_bytes(resp: Response) -> int:
    """Payload size of one (possibly fused) response, for autotune scoring
    (reference scores bytes/sec per sample, parameter_manager.h:178-220)."""
    shapes = getattr(resp, "_shapes", [])
    itemsize = _torch_dtype(getattr(resp, "_dtype", "float32")).itemsize
    return sum(_numel(s) for s in shapes) * itemsize


def _replay_plan_ok(plan: List[Response], world: int) -> bool:
    """Whether a memorized schedule can carry the replay epoch-check
    lane.  The flag rides the FIRST fused buffer as one extra scalar, so
    that buffer's reduction must preserve "any rank set a nonzero flag"
    as a nonzero output: SUM/AVERAGE over a non-bool dtype with nonzero
    pre/post scales (int AVERAGE floor-divides and could round a lone
    flag to zero).  Every field tested is negotiated — identical on all
    ranks — so the qualification decision is too."""
    if not plan:
        return False
    first = plan[0]
    if first.response_type != ResponseType.ALLREDUCE:
        return False
    meta = getattr(first, "_fuse_meta", None)
    if meta is None:
        return False
    name, reduce_op, pre, post = meta
    if reduce_op not in (int(ReduceOp.SUM), int(ReduceOp.AVERAGE)):
        return False
    if pre == 0.0 or post == 0.0:
        return False
    try:
        wire = _torch_dtype(name)
    except ValueError:
        return False
    if wire == torch.bool:
        return False
    if not wire.is_floating_point and reduce_op == int(ReduceOp.AVERAGE):
        return False
    # float16's narrow exponent range can underflow a flag scaled by tiny
    # pre/post factors (min subnormal ~6e-8), and AVERAGE divides by the
    # world on top; bf16/f32 have f32-sized exponents.
    if name == "float16":
        scale = abs(pre * post)
        if reduce_op == int(ReduceOp.AVERAGE):
            scale /= max(world, 1)
        if scale < 1e-6:
            return False
    return True


@dataclass
class TensorTableEntry:
    """reference common.h:233-250.  ``tensor`` is the engine's snapshot of
    the caller's payload (the caller's own tensor in a world of one);
    ``ready`` the event recorded on the caller's stream after the
    snapshot's copy (CUDA payloads only)."""

    request: Request
    tensor: Optional[torch.Tensor]
    future: concurrent.futures.Future = field(
        default_factory=concurrent.futures.Future
    )
    ready: Optional[torch.cuda.Event] = None


class EagerEngine:
    """Owns the background thread, tensor table, controller state."""

    def __init__(self):
        topo = global_topology()
        self.rank = topo.process_rank
        self.world = topo.process_count
        self.fusion_bytes = envmod.env_int(
            envmod.FUSION_THRESHOLD, DEFAULT_FUSION_BYTES
        )
        default_cycle = (
            DEFAULT_CYCLE_MS_SINGLE if self.world == 1 else DEFAULT_CYCLE_MS_MULTI
        )
        self.cycle_s = (
            envmod.env_float(envmod.CYCLE_TIME, default_cycle) / 1000.0
        )
        self.stall_warn = envmod.env_float(envmod.STALL_CHECK_TIME, 60.0)
        self.stall_shutdown = envmod.env_float(envmod.STALL_SHUTDOWN_TIME, 0.0)
        if envmod.env_bool(envmod.STALL_CHECK_DISABLE):
            self.stall_warn = float("inf")
        self.timeline = timeline_mod.from_env(self.rank)

        self._lock = threading.Lock()
        self._table: Dict[str, TensorTableEntry] = {}
        self._pending: List[Request] = []
        self._joined = False
        self._join_future: Optional[concurrent.futures.Future] = None
        self._shutdown_requested = False
        self._done = False
        self._controller = ControllerState(world_size=self.world)
        self._thread: Optional[threading.Thread] = None
        self._barrier_seq = 0

        # Response cache + steady-state fast path (reference
        # response_cache.cc / CacheCoordinator).
        self._cache = rcache.ResponseCache(
            envmod.env_int(envmod.CACHE_CAPACITY, 1024)
        )
        self.cache_enabled = True
        self._armed: Dict[int, Request] = {}
        self._armed_since: Dict[int, float] = {}
        self._last_armed_stall_check = time.monotonic()
        self.stats = {
            "cycles": 0,
            "fast_cycles": 0,  # cycles with no payload exchange anywhere
            "negotiated_cycles": 0,  # cycles that ran a control exchange
            "replay_cycles": 0,  # zero-control-plane replay executions
            "replay_idle_cycles": 0,  # replay cycles with nothing enqueued
            "replay_epochs": 0,  # times the engine entered replay
            "replay_breaks": 0,  # times a deviation broke an epoch
            "payload_cycles": 0,
            "control_bytes": 0,
            "payload_bytes": 0,
            "cache_hits": 0,
            "cache_misses": 0,
            "cached_responses": 0,  # ops executed straight from cache votes
            "negotiated_responses": 0,  # ops through full negotiation
            "fused_responses": 0,  # executed responses of >1 tensor
            "host_data_ops": 0,  # responses executed by the raw host gather
            "host_wire_bytes": 0,  # local payload bytes shipped per gather
            "host_recv_bytes": 0,  # bytes received by the host paths
            "host_staged_ops": 0,  # host payloads reduced on the gloo plane
            "device_data_ops": 0,  # responses executed as NCCL collectives
            "device_payload_bytes": 0,  # bytes that stayed on the card
            "hierarchical_ops": 0,  # allreduces run as the two-level schedule
        }

        metrics = get_registry()
        self._metrics = metrics
        self._m_cycle_ms = metrics.histogram("engine.cycle_time_ms")
        self._m_negotiate_ms = metrics.histogram("engine.negotiation_ms")
        self._m_fusion_bytes = metrics.histogram("engine.fusion_bytes")
        self._m_queue_depth = metrics.gauge("engine.tensor_queue_depth")
        self._m_completed = metrics.counter("engine.collectives_completed")
        self._m_cached_stalls = metrics.counter(
            "engine.cached_stall_warnings"
        )
        import weakref  # noqa: PLC0415

        _wm = weakref.WeakMethod(self._publish_stats)

        def _collect(reg, _wm=_wm):
            publish = _wm()
            if publish is None:
                from ..obs import CollectorRetired  # noqa: PLC0415

                raise CollectorRetired
            publish(reg)

        metrics.register_collector(_collect)

        # Data planes (runtime/device_plane.py) over the engine's own
        # groups: the device plane carries CUDA payloads (a CUDA payload on
        # every rank always takes it), the host plane CPU ones.
        self._device_plane: Optional[DataPlane] = None
        self._host_plane: Optional[DataPlane] = None
        self._stream: Optional[torch.cuda.Stream] = None
        groups = topo.engine_groups
        if self.world > 1:
            if groups is None:
                raise RuntimeError("init() built no engine groups")
            self._host_plane = DataPlane(groups.control, torch.device("cpu"),
                                         self.world)
            if groups.data is not None and topo.device.type == "cuda":
                hier = ((groups.local, groups.cross)
                        if groups.local is not None else None)
                self._device_plane = DataPlane(groups.data, topo.device,
                                               self.world, hier)
                self._stream = torch.cuda.Stream(topo.device)
        # one persistent fusion buffer per (device, dtype), grown on demand
        # (reference fusion_buffer_manager.cc)
        self._fusion_buffers: Dict[tuple, torch.Tensor] = {}

        # Two-level data path: SUM/AVERAGE fused allreduces of CUDA
        # payloads run parallel/hierarchical.py's schedule on the engine's
        # local and cross groups when the topology has them, selected from
        # the tuner's hierarchical_allreduce param or pinned by
        # HVDTPU_HIERARCHICAL_ALLREDUCE (launcher-uniform).
        self._hier_capable = bool(
            self._device_plane is not None
            and self._device_plane.hierarchical_ok
        )
        self.hierarchical = False
        hier_req = envmod.env_bool(envmod.HIERARCHICAL_ALLREDUCE)
        self._hier_pinned = bool(hier_req and self._hier_capable)
        if hier_req:
            if self._hier_capable:
                self.hierarchical = True
            else:
                LOG.warning(
                    "hierarchical allreduce requested but the engine has no "
                    "two-level device plane (CPU payloads, or no local and "
                    "cross groups: %d ranks, local size %d); downgrading to "
                    "flat allreduce", self.world, topo.local_size,
                )
        dcn_choice = (
            os.environ.get(envmod.DCN_COMPRESSION) or "none"
        ).strip().lower()
        if dcn_choice not in DCN_WIRES:
            LOG.warning(
                "unknown %s=%r (choices: %s); the cross leg stays "
                "uncompressed", envmod.DCN_COMPRESSION, dcn_choice,
                "/".join(sorted(DCN_WIRES)),
            )
            dcn_choice = "none"
        self._dcn_wire = DCN_WIRES[dcn_choice]

        # Stable-schedule replay fast path: after `replay_after` consecutive
        # cycles whose executed schedule is bitwise-identical on every rank,
        # the engine stops exchanging control vectors and replays the
        # memorized fused schedule, re-validated per cycle by a one-scalar
        # epoch-check lane on the first fused buffer.
        self.replay_enabled = (
            self.world > 1
            and envmod.env_bool(envmod.SCHEDULE_REPLAY, default=True)
        )
        self.replay_after = max(
            2,
            envmod.env_int(
                envmod.SCHEDULE_REPLAY_CYCLES, envmod.DEFAULT_REPLAY_CYCLES
            ),
        )
        self._replaying = False
        self._replay_plan: Optional[List[Response]] = None
        self._replay_names: frozenset = frozenset()
        self._replay_idle_since: Optional[float] = None
        self._stable_cycles = 0
        self._last_sched_key: Optional[tuple] = None
        self._replay_flag_lane: Optional[float] = None
        self._replay_flag_total = 0.0

        # Autotuner (reference parameter_manager.cc, a continuous
        # controller): rank 0 scores bytes per second of busy cycle time
        # and proposes params; peers apply what rides rank 0's RequestList.
        self._pm: Optional[ParameterManager] = None
        self._pending_params: Optional[tuple] = None
        if self.rank == 0 and envmod.env_bool(envmod.AUTOTUNE):
            categories = build_categories(
                multislice=self._hier_capable,
                replay_enabled=self.replay_enabled,
            )
            if self._hier_pinned:
                seen: set = set()
                pinned = []
                for c in categories:
                    c = {**c, "hierarchical_allreduce": True}
                    k = tuple(sorted(c.items()))
                    if k not in seen:
                        seen.add(k)
                        pinned.append(c)
                categories = pinned
            self._pm = ParameterManager(
                enabled=True,
                initial=TunedParams(
                    fusion_bytes=self.fusion_bytes, cycle_s=self.cycle_s,
                    hierarchical_allreduce=self.hierarchical,
                ),
                log_path=os.environ.get(envmod.AUTOTUNE_LOG) or None,
                categories=categories,
                metrics_source=(
                    lambda fb=self._m_fusion_bytes, cy=self._m_cycle_ms:
                    (fb.sum, cy.sum / 1e3)
                ),
            )

    # ------------------------------------------------------------------ API

    @classmethod
    def start(cls) -> "EagerEngine":
        eng = cls()
        if eng.world > 1:
            eng._thread = threading.Thread(
                target=eng._loop, name="hvdtpu_background", daemon=True
            )
            eng._thread.start()
            atexit.register(eng.shutdown)
        return eng

    def enqueue(
        self,
        op: RequestType,
        name: str,
        tensor: Optional[torch.Tensor],
        *,
        reduce_op: int = 0,
        root_rank: int = -1,
        prescale: float = 1.0,
        postscale: float = 1.0,
    ) -> concurrent.futures.Future:
        """reference EnqueueTensorAllreduce/... operations.cc:803-954."""
        maybe_fail("enqueue", name=name)
        obs_flightrec.record(
            "enqueue", name=name, cycle=self.stats["cycles"],
            detail=op.name,
        )
        shape = tuple(tensor.shape) if tensor is not None else ()
        dtype = dtype_name(tensor.dtype) if tensor is not None else "float32"
        req = Request(
            request_rank=self.rank,
            request_type=op,
            tensor_name=name,
            dtype=dtype,
            shape=shape,
            reduce_op=reduce_op,
            root_rank=root_rank,
            prescale_factor=prescale,
            postscale_factor=postscale,
            device=bool(self._device_plane is not None and tensor is not None
                        and tensor.is_cuda),
        )
        if self.world == 1:
            entry = TensorTableEntry(request=req, tensor=tensor)
            self._execute_local(entry)
            return entry.future
        copy, ready = self._snapshot(tensor)
        entry = TensorTableEntry(request=req, tensor=copy, ready=ready)
        with self._lock:
            if self._done:
                entry.future.set_exception(
                    HorovodShutdownError(SHUT_DOWN_ERROR)
                )
                return entry.future
            if name in self._table:
                entry.future.set_exception(
                    ValueError(DUPLICATE_NAME_ERROR.format(op=op.name.lower()))
                )
                return entry.future
            self._table[name] = entry
            self._pending.append(req)
        return entry.future

    @staticmethod
    def _snapshot(tensor: Optional[torch.Tensor]):
        """``(copy, ready)``: the engine's own copy of a payload and, on
        CUDA, the event recorded after the copy.  The reference's enqueue
        memcpys into its own buffer (fusion_buffer_manager.cc), so a caller
        that frees or reuses the tensor (``p.grad`` between steps) cannot
        race the background cycle.  On CUDA the copy runs on the caller's
        current stream, after whatever wrote the tensor there, and the
        engine's stream waits on the event, never the host."""
        if tensor is None:
            return None, None
        copy = tensor.detach().clone(memory_format=torch.contiguous_format)
        if not copy.is_cuda:
            return copy, None
        ready = torch.cuda.Event()
        ready.record()
        return copy, ready

    def join(self) -> concurrent.futures.Future:
        """reference EnqueueJoin (operations.cc:930) + §3.5 semantics:
        mark this rank joined; pending peers' collectives proceed with this
        rank contributing zeros; resolves when every rank has joined."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        if self.world == 1:
            fut.set_result(0)
            return fut
        with self._lock:
            if self._done:
                fut.set_exception(HorovodShutdownError(SHUT_DOWN_ERROR))
                return fut
            self._joined = True
            self._join_future = fut
        return fut

    def barrier(self) -> concurrent.futures.Future:
        # Sequence-numbered so overlapping barriers queue instead of
        # colliding with DUPLICATE_NAME; the Nth barrier call on every
        # rank pairs up (same convention as unnamed-tensor sequence names).
        with self._lock:
            self._barrier_seq += 1
            seq = self._barrier_seq
        return self.enqueue(RequestType.BARRIER, f"hvdtpu.barrier.{seq}", None)

    def shutdown(self) -> None:
        """Coordinated shutdown, reference semantics: ANY rank's shutdown
        flag propagates through the negotiation and tears the whole job
        down; peers' outstanding entries fail with SHUT_DOWN_ERROR
        (reference controller.cc:256-259,309 + operations.cc:526-532).
        The flag rides the next cycle so every rank exits its loop in the
        same cycle — no rank stops cycling unilaterally."""
        if self.world == 1:
            self._done = True
            return
        with self._lock:
            if self._done:
                return
            self._shutdown_requested = True
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=30)
        self.timeline.shutdown()

    def _publish_stats(self, metrics) -> None:
        """Snapshot-time collector: publish the stats dict (and derived
        rates) as gauges."""
        for key, value in self.stats.items():
            metrics.gauge(f"engine.stats.{key}").set(value)
        lookups = self.stats["cache_hits"] + self.stats["cache_misses"]
        if lookups:
            metrics.gauge("engine.cache_hit_rate").set(
                self.stats["cache_hits"] / lookups
            )
        metrics.gauge("engine.fusion_threshold_bytes").set(self.fusion_bytes)
        if self.stats["cycles"]:
            metrics.gauge("engine.negotiation_skip_rate").set(
                1.0 - self.stats["negotiated_cycles"] / self.stats["cycles"]
            )
        metrics.gauge("engine.replay_active").set(
            1.0 if self._replaying else 0.0
        )

    # ------------------------------------------------------ background loop

    def _loop(self) -> None:
        if self._stream is not None:
            # every kernel and collective of the thread runs on the
            # engine's stream, behind the payloads' ready events
            torch.cuda.set_device(self._stream.device)
            with torch.cuda.stream(self._stream):
                self._cycle_loop()
        else:
            self._cycle_loop()

    def _cycle_loop(self) -> None:
        while True:
            start = time.monotonic()
            try:
                again = self._run_loop_once()
            except Exception as exc:  # transport/controller failure
                LOG.error("background loop error: %s", exc)
                obs_flightrec.record_exception(exc, where="engine.loop")
                self._fail_all(exc)
                return
            elapsed = time.monotonic() - start
            self._m_cycle_ms.observe(elapsed * 1e3)
            if not again:
                break
            if elapsed < self.cycle_s:
                time.sleep(self.cycle_s - elapsed)
        self._fail_all(HorovodShutdownError(SHUT_DOWN_ERROR))
        self._done = True

    def _run_loop_once(self) -> bool:
        """One cycle: the replay fast path when an epoch is open, the
        negotiated path otherwise."""
        if self._replaying:
            return self._run_replay_once()
        return self._run_negotiated_once()

    def _run_negotiated_once(self) -> bool:
        """One negotiated cycle (reference RunLoopOnce, operations.cc:550).

        Steady-state fast path, tier 1 (reference ComputeResponseList
        controller.cc:174-202 + CacheCoordinator::sync): requests that hit
        the response cache only arm a slot bit; the cycle exchanges ONE
        fixed-size control vector, and full serialized RequestLists ride a
        second exchange only when some rank actually has uncached work.

        Tier 2 — schedule replay — is armed HERE: every cycle's stability
        is judged from the gathered control data (identical on all
        ranks), and `replay_after` consecutive identical schedules flip
        every rank into `_run_replay_once` on the same cycle."""
        self.timeline.mark_cycle()
        with self._lock:
            requests = list(self._pending)
            self._pending.clear()
            shutdown = self._shutdown_requested
            joined = self._joined
            params = self._pending_params
            self._pending_params = None

        now = time.monotonic()
        misses: List[Request] = []
        for req in requests:
            status, slot = (
                self._cache.lookup(req)
                if self.cache_enabled
                else (rcache.MISS, -1)
            )
            if (
                status == rcache.HIT
                and req.key() in self._controller.message_table
            ):
                # Divergence repair, part 1: a peer already negotiated this
                # name through the slow path; arming would deadlock.
                status = rcache.MISS
            if status == rcache.HIT:
                self._armed[slot] = req
                self._armed_since[slot] = now
                self.stats["cache_hits"] += 1
            else:
                misses.append(req)
                self.stats["cache_misses"] += 1

        payload = b""
        if misses or params is not None:
            payload = RequestList(
                requests=misses, tuned_params=params
            ).serialize()

        trace_on = obs_trace.enabled()
        t_negw = time.time() if trace_on else 0.0
        t_neg = time.monotonic()
        shutdown_ranks, joined_ranks, bits, all_lists = self._exchange(
            payload, shutdown, joined
        )
        self._m_negotiate_ms.observe((time.monotonic() - t_neg) * 1e3)
        self._m_queue_depth.set(len(self._table))
        self.stats["cycles"] += 1
        self.stats["negotiated_cycles"] += 1
        if trace_on:
            obs_trace.add_span("engine", "negotiate", t_negw,
                               time.time(), step=self.stats["cycles"])

        state = self._controller
        state.shutdown_ranks.update(shutdown_ranks)
        state.joined_ranks.update(joined_ranks)

        # Cache votes: a slot executes when every non-joined rank armed it
        # (bitvector AND ≙ response_cache.h:133-137 status bits), computed
        # from the GLOBAL bit matrix: a joined rank armed nothing but must
        # still participate (with zeros) in its peers' cached collectives.
        voted: set = set()
        union = np.bitwise_or.reduce(bits, axis=0) if len(bits) else bits
        for byte_i, byte in enumerate(union):
            b = int(byte)
            while b:
                bit = b & -b
                voted.add(byte_i * 8 + bit.bit_length() - 1)
                b ^= bit
        ready: List[int] = []
        for slot in sorted(voted):
            if all(
                ((bits[r, slot >> 3] >> (slot & 7)) & 1)
                or (r in state.joined_ranks)
                for r in range(self.world)
            ):
                ready.append(slot)
        cached_responses: List[Response] = []
        for slot in ready:
            self._cache.touch(slot)  # LRU in deterministic slot order
            cached_responses.append(self._cache.response_for(slot))
            self._armed.pop(slot, None)
            self._armed_since.pop(slot, None)
        cached_responses = _fuse(cached_responses, state, self.fusion_bytes)
        self.stats["cached_responses"] += len(ready)
        self._check_armed_stalls(now)
        # Slots any rank is voting on this cycle must survive LRU eviction
        # during this cycle's insertions (identical union everywhere).
        protected = voted

        fast = all_lists is None
        if all_lists is None:
            self.stats["fast_cycles"] += 1
            all_lists = [RequestList() for _ in range(self.world)]
        else:
            self.stats["payload_cycles"] += 1
            # Conflict resolution: a re-submission under a cached name with
            # different params invalidates the cache entry on EVERY rank.
            for rlist in all_lists:
                for req in rlist.requests:
                    st, slot = self._cache.lookup(req)
                    if st == rcache.CONFLICT:
                        stale = self._armed.pop(slot, None)
                        self._armed_since.pop(slot, None)
                        self._cache.evict_name(req.tensor_name)
                        if stale is not None:
                            with self._lock:
                                self._pending.append(stale)
                    elif st == rcache.HIT and slot in self._armed:
                        # Divergence repair, part 2: a peer negotiated this
                        # name slow-path while we hold it armed; move ours
                        # back through negotiation.
                        stale = self._armed.pop(slot)
                        self._armed_since.pop(slot, None)
                        with self._lock:
                            self._pending.append(stale)
            if all_lists[0].tuned_params is not None:
                self._apply_params(
                    TunedParams.from_wire(all_lists[0].tuned_params)
                )

        self._cache.protected = protected
        responses, should_shutdown = compute_responses(
            state,
            all_lists,
            fusion_threshold_bytes=self.fusion_bytes,
            stall_warning_secs=self.stall_warn,
            stall_shutdown_secs=self.stall_shutdown,
            timeline=self.timeline,
            cache=self._cache,
        )
        self._cache.protected = frozenset()
        self.stats["negotiated_responses"] += sum(
            len(r.tensor_names)
            for r in responses
            if r.response_type != ResponseType.JOIN
        )
        # Cached responses execute first, then freshly negotiated ones —
        # the same deterministic order on every rank.
        t_execw = time.time() if trace_on else 0.0
        for resp in cached_responses:
            self._perform_operation(resp)
        for resp in responses:
            self._perform_operation(resp)
        if trace_on and (cached_responses or responses):
            obs_trace.add_span(
                "engine", "execute", t_execw, time.time(),
                step=self.stats["cycles"],
                responses=len(cached_responses) + len(responses),
            )
        if self._pm is not None:
            for resp in cached_responses + responses:
                self._pm.record_bytes(_response_bytes(resp))
            proposal = self._pm.cycle()
            if proposal is not None:
                with self._lock:
                    self._pending_params = proposal.as_wire()

        # ---- replay arming: judge this cycle's stability from shared
        # data only, so every rank enters the epoch on the same cycle.
        key = None
        neutral = False
        if (
            self.replay_enabled
            and self.cache_enabled
            and fast                      # no payload exchanged anywhere
            and not state.shutdown_ranks
            and not state.joined_ranks
            and not state.message_table   # no negotiation mid-flight
        ):
            if ready and set(ready) == voted:  # every armed slot completed
                key = self._cache.schedule_key(ready)
            elif not ready:
                # Nothing executed this cycle: evidence of neither
                # stability nor change (judged from the gathered bits).
                neutral = True
        if not neutral:
            if key is not None and key == self._last_sched_key:
                self._stable_cycles += 1
            else:
                self._stable_cycles = 1 if key is not None else 0
            self._last_sched_key = key
        if (
            key is not None
            and self._stable_cycles >= self.replay_after
            and _replay_plan_ok(cached_responses, self.world)
        ):
            self._enter_replay(cached_responses)
        return not should_shutdown

    # ------------------------------------------------------ schedule replay

    def _enter_replay(self, plan: List[Response]) -> None:
        """Open a replay epoch: memorize the fused schedule every rank
        just executed identically `replay_after` times."""
        self._replaying = True
        self._replay_plan = list(plan)
        self._replay_names = frozenset(
            n for resp in plan for n in resp.tensor_names
        )
        self._replay_idle_since = None
        self.stats["replay_epochs"] += 1
        obs_flightrec.record(
            "replay_enter", name=",".join(sorted(self._replay_names)),
            cycle=self.stats["cycles"],
            detail=f"{len(plan)} fused responses",
        )
        LOG.info(
            "entering schedule-replay epoch after %d stable cycles "
            "(%d fused responses, %d tensors)",
            self._stable_cycles, len(plan), len(self._replay_names),
        )

    def _exit_replay(self, reason: str) -> None:
        self._replaying = False
        self._replay_plan = None
        self._replay_names = frozenset()
        self._replay_idle_since = None
        self._stable_cycles = 0
        self._last_sched_key = None
        self.stats["replay_breaks"] += 1
        self._metrics.counter("engine.replay_break", reason=reason).inc()
        obs_flightrec.record(
            "replay_break", name="", cycle=self.stats["cycles"],
            detail=reason,
        )
        LOG.info("schedule-replay epoch broken: %s", reason)

    def _run_replay_once(self) -> bool:
        """One replay cycle: zero control-plane exchange.

        Every rank entered the epoch on the same cycle from shared data and
        executes the same memorized fused collectives in the same order.
        Re-validation rides the FIRST fused buffer: one extra scalar lane
        carries this rank's deviation flag; a nonzero sum means every rank
        discards the cycle's data (a deviating rank contributed zeros),
        restores its entries and falls back to full negotiation."""
        self.timeline.mark_cycle()
        now = time.monotonic()
        plan = self._replay_plan
        with self._lock:
            requests = list(self._pending)
            self._pending.clear()
            shutdown = self._shutdown_requested
            joined = self._joined
            params_pending = self._pending_params is not None

        deviation = None
        leftovers: List[Request] = []
        for req in requests:
            status, _slot = (
                self._cache.lookup(req)
                if self.cache_enabled
                else (rcache.MISS, -1)
            )
            if status == rcache.HIT and req.tensor_name in self._replay_names:
                continue  # steady-state re-arm; its entry is in the table
            leftovers.append(req)
            deviation = "conflict" if status == rcache.CONFLICT else "miss"
        if leftovers:
            with self._lock:
                self._pending[:0] = leftovers
        if params_pending:
            deviation = "tuner-move"
        if joined:
            deviation = "join"
        if shutdown:
            deviation = "shutdown"

        if deviation is None:
            with self._lock:
                is_ready = all(
                    n in self._table for n in self._replay_names
                )
            if not is_ready:
                # Peers that are ready wait inside the first fused
                # collective; sustained idleness past the stall budget
                # (bounded even with stall warnings off: it is replay's
                # only liveness escape) breaks the epoch instead.
                if self._replay_idle_since is None:
                    self._replay_idle_since = now
                if now - self._replay_idle_since > min(self.stall_warn, 60.0):
                    deviation = "stall"
                    LOG.warning(
                        "replay epoch stalled for %.0f s waiting for "
                        "local enqueues; breaking back to negotiation",
                        now - self._replay_idle_since,
                    )
                else:
                    self.stats["replay_idle_cycles"] += 1
                    return True
        self._replay_idle_since = None

        first = plan[0]
        my_flag = 1.0 if deviation else 0.0
        if deviation:
            entries1: List[Optional[TensorTableEntry]] = (
                [None] * len(first.tensor_names)
            )
        else:
            with self._lock:
                entries1 = [
                    self._table.pop(n, None) for n in first.tensor_names
                ]
        self._replay_flag_lane = my_flag
        self._replay_flag_total = 0.0
        try:
            try:
                self._execute_allreduce(first, entries1)
            finally:
                self._replay_flag_lane = None
        except BaseException:
            with self._lock:
                for e in entries1:
                    if e is not None:
                        self._table[e.request.tensor_name] = e
            raise

        self.stats["cycles"] += 1
        if my_flag != 0.0 or self._replay_flag_total != 0.0:
            # Epoch broken (locally or by a peer): the flag sum is the same
            # for every participant, so every rank takes this branch.
            with self._lock:
                for e in entries1:
                    if e is not None:
                        self._table[e.request.tensor_name] = e
                pending_names = {r.tensor_name for r in self._pending}
                for name in sorted(self._replay_names):
                    e = self._table.get(name)
                    if e is not None and name not in pending_names:
                        self._pending.append(e.request)
            self._exit_replay(deviation or "peer-flag")
            return True

        self.stats["replay_cycles"] += 1
        obs_flightrec.record(
            "replay", name=",".join(first.tensor_names),
            cycle=self.stats["cycles"], detail=first.response_type.name,
        )
        done = len(first.tensor_names)
        self.stats["cached_responses"] += done
        self._m_completed.inc(done)
        self._m_fusion_bytes.observe(_response_bytes(first))
        obs_progress.tick(done)
        t_execw = time.time()
        for resp in plan[1:]:
            self._perform_operation(resp)
            self.stats["cached_responses"] += len(resp.tensor_names)
        if obs_trace.enabled():
            obs_trace.add_span("engine", "replay_execute", t_execw,
                               time.time(), step=self.stats["cycles"],
                               responses=len(plan))
        if self._pm is not None:
            for resp in plan:
                self._pm.record_bytes(_response_bytes(resp))
            proposal = self._pm.cycle()
            if proposal is not None:
                with self._lock:
                    self._pending_params = proposal.as_wire()
        return True

    def _check_armed_stalls(self, now: float) -> None:
        """Armed-but-unready slots live outside the controller's message
        table, so the stall inspector can't see them; warn here (reference
        stall_inspector.cc InvalidateStalledCachedTensors)."""
        if now - self._last_armed_stall_check < min(self.stall_warn, 10.0):
            return
        self._last_armed_stall_check = now
        for slot, since in self._armed_since.items():
            age = now - since
            if age > self.stall_warn:
                self._m_cached_stalls.inc()
                LOG.warning(
                    "Cached tensor %s has been waiting on peer ranks for "
                    "%.0f s", self._cache.name_for(slot), age,
                )
                if self.stall_shutdown > 0 and age > self.stall_shutdown:
                    raise RuntimeError(
                        f"Stalled cached tensor {self._cache.name_for(slot)} "
                        f"exceeded shutdown threshold ({self.stall_shutdown}s)"
                    )

    def _apply_params(self, p: TunedParams) -> None:
        """Apply rank-0-tuned params (reference SynchronizeParameters,
        controller.cc:33-47), on the same cycle boundary on every rank."""
        self.fusion_bytes = p.fusion_bytes
        self.cycle_s = p.cycle_s
        self.cache_enabled = p.cache_enabled
        self.hierarchical = (
            bool(p.hierarchical_allreduce) or self._hier_pinned
        ) and self._hier_capable

    # ---------------------------------------------------------- negotiation

    def _control_allgather(self, vec: np.ndarray) -> np.ndarray:
        """``(world, len(vec))`` uint8: every rank's ``vec`` (the same
        length everywhere), over the engine's gloo group."""
        local = torch.from_numpy(np.ascontiguousarray(vec, np.uint8))
        out = torch.empty(self.world * local.numel(), dtype=torch.uint8)
        _all_gather_single(out, local, group=self._host_plane.group)
        return out.view(self.world, -1).numpy()

    def _exchange(self, payload: bytes, shutdown: bool, joined: bool):
        """One negotiation round: allgather a fixed-size control vector
        [flags | payload length | armed cache bits]; gather the serialized
        RequestList payloads in a second round ONLY if some rank has one
        (the reference's slow path, mpi_controller.cc:107-199 Gatherv +
        Bcast; the fast path is the control vector alone, ≙ the bitvector
        AND/OR allreduce of controller.cc:174-202).

        Returns (shutdown_ranks, joined_ranks, bits, all_lists) where bits
        is a (world, num_bits) uint8 matrix of armed votes and all_lists is
        None on a fast (control-only) cycle."""
        nbits = self._cache.num_bits
        vec = np.zeros(5 + nbits, np.uint8)
        vec[0] = (
            (1 if shutdown else 0)
            | (2 if joined else 0)
            | (4 if payload else 0)
        )
        vec[1:5] = np.frombuffer(
            np.uint32(len(payload)).tobytes(), np.uint8
        )
        for slot in self._armed:
            vec[5 + (slot >> 3)] |= 1 << (slot & 7)
        gathered = self._control_allgather(vec)
        self.stats["control_bytes"] += int(vec.size) * self.world

        flags = gathered[:, 0]
        shutdown_ranks = {r for r in range(self.world) if flags[r] & 1}
        joined_ranks = {r for r in range(self.world) if flags[r] & 2}
        bits = gathered[:, 5:]
        if not bool((flags & 4).any()):
            return shutdown_ranks, joined_ranks, bits, None

        lengths = gathered[:, 1:5].copy().view(np.uint32).reshape(-1)
        max_len = int(lengths.max())
        buf = np.zeros(max_len, np.uint8)
        buf[: len(payload)] = np.frombuffer(payload, np.uint8)
        pg = self._control_allgather(buf)
        self.stats["payload_bytes"] += max_len * self.world
        all_lists = [
            RequestList.deserialize(pg[r, : int(lengths[r])].tobytes())
            if lengths[r]
            else RequestList()
            for r in range(self.world)
        ]
        return shutdown_ranks, joined_ranks, bits, all_lists

    # ------------------------------------------------------------ execution

    def _perform_operation(self, resp: Response) -> None:
        """reference PerformOperation (operations.cc:232-309)."""
        if resp.response_type == ResponseType.JOIN:
            with self._lock:
                fut, self._join_future = self._join_future, None
                self._joined = False
            if fut is not None:
                fut.set_result(self.world - 1)
            return

        entries: List[Optional[TensorTableEntry]] = []
        with self._lock:
            for name in resp.tensor_names:
                entries.append(self._table.pop(name, None))

        if resp.response_type == ResponseType.ERROR:
            obs_flightrec.record(
                "error", name=",".join(resp.tensor_names),
                cycle=self._controller.cycle_index,
                detail=(resp.error_message or "")[:200],
            )
            for e in entries:
                if e is not None:
                    e.future.set_exception(RuntimeError(resp.error_message))
            return

        try:
            names = ",".join(resp.tensor_names)
            obs_flightrec.record(
                "execute", name=names,
                cycle=self._controller.cycle_index,
                detail=resp.response_type.name,
            )
            self.timeline.start(names, resp.response_type.name)
            if len(resp.tensor_names) > 1:
                self.stats["fused_responses"] += 1
            if resp.response_type in (
                ResponseType.ALLREDUCE,
                ResponseType.ADASUM,
            ):
                self._execute_allreduce(resp, entries)
            elif resp.response_type == ResponseType.ALLGATHER:
                self._execute_allgather(resp, entries)
            elif resp.response_type == ResponseType.BROADCAST:
                self._execute_broadcast(resp, entries)
            elif resp.response_type == ResponseType.ALLTOALL:
                self._execute_alltoall(resp, entries)
            elif resp.response_type == ResponseType.REDUCESCATTER:
                self._execute_reducescatter(resp, entries)
            elif resp.response_type == ResponseType.BARRIER:
                e = entries[0]
                if e is not None:
                    e.future.set_result(None)
            self.timeline.end(names, resp.response_type.name)
            obs_flightrec.record(
                "complete", name=names,
                cycle=self._controller.cycle_index,
                detail=resp.response_type.name,
            )
            done = len(resp.tensor_names)
            self._m_completed.inc(done)
            self._m_fusion_bytes.observe(_response_bytes(resp))
            obs_progress.tick(done)
        except Exception as exc:
            for e in entries:
                if e is not None and not e.future.done():
                    e.future.set_exception(exc)

    # A joined rank has no entry for a tensor its peers are reducing: it
    # participates with zeros of the negotiated shape (reference
    # tensor_queue.h:39-41 zero-tensor substitution).

    # ------------------------------------------------------------ data planes

    @staticmethod
    def _use_device(resp: Response) -> bool:
        """Negotiated plane for this response — identical on all ranks:
        the controller sets _device = AND of every rank's Request.device."""
        return bool(getattr(resp, "_device", False))

    def _staged_ok(self) -> bool:
        """Whether host payloads reduce on the gloo plane.  Every rank of a
        world of more than one has it; an engine without one (a world of
        one promoted by hand, as the replay tables drive it) reduces host
        payloads through the raw gather."""
        return self._host_plane is not None

    def _payload(self, e: TensorTableEntry,
                 device: torch.device) -> torch.Tensor:
        """The entry's snapshot, readable on the current stream of this
        thread and on ``device``: on CUDA the stream waits for the
        snapshot's ready event (the host does not)."""
        t = e.tensor
        if e.ready is not None:
            stream = torch.cuda.current_stream(t.device)
            stream.wait_event(e.ready)
            t.record_stream(stream)
            e.ready = None
        return t if t.device == device else t.to(device)

    def _fusion_buffer(self, device: torch.device, dtype: torch.dtype,
                       n: int) -> torch.Tensor:
        """The first ``n`` elements of the persistent fusion buffer of
        (``device``, ``dtype``): ``fusion_bytes`` long, grown when one
        response needs more (a tensor is never split)."""
        key = (device, dtype)
        buf = self._fusion_buffers.get(key)
        if buf is None or buf.numel() < n:
            size = max(n, self.fusion_bytes // dtype.itemsize)
            buf = torch.empty(size, dtype=dtype, device=device)
            self._fusion_buffers[key] = buf
        return buf[:n]

    def _pack(self, entries, shapes, wire: torch.dtype,
              device: torch.device, flag_lane) -> torch.Tensor:
        """Copy the entries into the fusion buffer, in order (zeros for a
        joined rank's missing entries), with the replay flag lane last
        (MemcpyInFusionBuffer, collective_operations.cc:159-210)."""
        n = sum(_numel(s) for s in shapes) + (flag_lane is not None)
        buf = self._fusion_buffer(device, wire, n)
        offset = 0
        for e, shape in zip(entries, shapes):
            k = _numel(shape)
            dst = buf[offset:offset + k]
            if e is not None and e.tensor is not None:
                dst.copy_(self._payload(e, device).reshape(-1))
            else:
                dst.zero_()
            offset += k
        if flag_lane is not None:
            buf[offset:].fill_(flag_lane)
        return buf

    def _deliver(self, e: TensorTableEntry, out: torch.Tensor) -> None:
        """Resolve ``e``'s future with a fresh copy of ``out`` on the
        payload's device and in its dtype.  A CUDA result carries the event
        recorded after its copy, which ``synchronize`` makes the caller's
        stream wait on."""
        out = out.to(device=e.tensor.device, dtype=e.tensor.dtype,
                     copy=True)
        if out.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(out.device))
            e.future._hvd_done = done
        e.future.set_result(out)

    def _scatter_results(self, entries, shapes, total) -> None:
        """Slice the reduced fused buffer back to per-entry futures
        (MemcpyOutFusionBuffer analog)."""
        offset = 0
        for e, shape in zip(entries, shapes):
            n = _numel(shape)
            if e is not None:
                self._deliver(e, total[offset:offset + n].reshape(shape))
            offset += n

    def _data_allgather(self, local: torch.Tensor) -> torch.Tensor:
        """Host raw gather over the engine's gloo group ->
        ``(world, *local.shape)`` on the CPU; raw bytes, exact for every
        dtype (the reference's coordination-service gather)."""
        self.stats["host_data_ops"] += 1
        local = local.detach().cpu().contiguous()
        nbytes = local.numel() * local.element_size()
        self.stats["host_wire_bytes"] += nbytes
        self.stats["host_recv_bytes"] += nbytes * self.world
        raw = local.reshape(-1).view(torch.uint8)
        out = torch.empty(self.world * raw.numel(), dtype=torch.uint8)
        _all_gather_single(out, raw, group=self._host_plane.group)
        return out.view(local.dtype).reshape((self.world,) + tuple(local.shape))

    def _plane_allreduce(self, plane: DataPlane, buf, reduce_op, pre, post,
                         acc, exact_int_avg, is_int):
        """One plane reduce of a fused buffer: the two-level schedule when
        the tuned ``hierarchical`` flag is up, the plane has the engine's
        local and cross groups and the op is SUM/AVERAGE (every input
        shared, so all ranks issue the same collectives)."""
        if (
            self.hierarchical
            and plane.hierarchical_ok
            and reduce_op in (int(ReduceOp.SUM), int(ReduceOp.AVERAGE))
        ):
            # integer payloads always cross exact
            self.stats["hierarchical_ops"] += 1
            return plane.allreduce_hier(
                buf, reduce_op, pre, post, acc, exact_int_avg,
                None if is_int else self._dcn_wire)
        return plane.allreduce(buf, reduce_op, pre, post, acc, exact_int_avg)

    def _device_adasum(self, buf: torch.Tensor) -> torch.Tensor:
        """Adasum of a CUDA buffer, on the card: every rank's row gathered
        over NCCL, then the reference's recursive tree in fp64."""
        from ..ops.adasum import adasum_rows  # noqa: PLC0415

        rows = self._device_plane.allgather(buf)
        return adasum_rows(rows.to(torch.float64)).to(buf.dtype)

    def _execute_allreduce(self, resp: Response, entries) -> None:
        # Replay epoch-check lane: when set (first fused buffer of a
        # replay cycle only), ONE extra scalar rides the buffer; after
        # the reduction the flag sum is published to _replay_flag_total
        # and a nonzero sum suppresses the scatter.
        flag_lane = self._replay_flag_lane
        meta = getattr(resp, "_fuse_meta", None)
        shapes = getattr(resp, "_shapes", [()] * len(resp.tensor_names))
        name, reduce_op, pre, post = (
            meta if meta else ("float32", 1, 1.0, 1.0)
        )
        # Dtype-native wire: the buffer travels in the NEGOTIATED dtype;
        # 16-bit floats (and bool) accumulate in f32, like the reference's
        # vectorized half kernels accumulate wide.
        wire = _torch_dtype(name)
        is_int = not wire.is_floating_point and wire != torch.bool
        acc = wire if wire.is_floating_point or is_int else torch.float32
        if name in ("bfloat16", "float16"):
            acc = torch.float32
        scaled = pre != 1.0 or post != 1.0
        if scaled and is_int:
            # pre/post scaling of integers computes in f64 (the
            # reference's PrescaleFactor path goes through double)
            acc = torch.float64
        exact_int_avg = bool(is_int and not scaled
                             and reduce_op == int(ReduceOp.AVERAGE))

        if self._use_device(resp):
            # CUDA payloads on every rank: one NCCL collective on the
            # engine's stream; nothing leaves the card, Adasum included.
            plane = self._device_plane
            buf = self._pack(entries, shapes, wire, plane.device, flag_lane)
            if reduce_op == int(ReduceOp.ADASUM):
                total = self._device_adasum(buf)
            else:
                total = self._plane_allreduce(
                    plane, buf, reduce_op, pre, post, acc, exact_int_avg,
                    is_int)
            self.stats["device_data_ops"] += 1
            self.stats["device_payload_bytes"] += total.numel() * wire.itemsize
            if flag_lane is not None:
                self._replay_flag_total = abs(float(total[-1]))
                if self._replay_flag_total != 0.0:
                    return  # epoch broken: discard
            self._scatter_results(entries, shapes, total)
            return
        cpu = torch.device("cpu")
        # Host payloads of the stageable dtypes reduce on the gloo plane:
        # O(bytes) instead of the gather-everything fallback (reference's
        # GlooAllreduce ring, gloo_operations.cc:107-142).
        if (reduce_op != int(ReduceOp.ADASUM) and not (scaled and is_int)
                and name in _STAGEABLE_DTYPES and self._staged_ok()):
            buf = self._pack(entries, shapes, wire, cpu, flag_lane)
            nbytes = buf.numel() * wire.itemsize
            total = self._plane_allreduce(
                self._host_plane, buf, reduce_op, pre, post, acc,
                exact_int_avg, is_int)
            self.stats["host_staged_ops"] += 1
            self.stats["host_wire_bytes"] += nbytes
            self.stats["host_recv_bytes"] += nbytes
            if flag_lane is not None:
                self._replay_flag_total = abs(float(total[-1]))
                if self._replay_flag_total != 0.0:
                    return  # epoch broken: discard
            self._scatter_results(entries, shapes, total)
            return
        buf = self._pack(entries, shapes, wire, cpu, None)
        if pre != 1.0:
            buf = (buf.to(acc) * pre).to(wire)
        if flag_lane is not None:
            # appended AFTER the manual prescale: an int wire with a
            # fractional pre would otherwise truncate a lone flag to 0
            buf = torch.cat([buf, torch.full((1,), flag_lane, dtype=wire)])
        gathered = self._data_allgather(buf)
        if flag_lane is not None:
            # the raw gather delivers every rank's row: read every flag
            # exactly, then strip the lane before reducing
            self._replay_flag_total = float(
                gathered[:, -1].to(torch.float64).abs().sum())
            gathered = gathered[:, :-1]
            if self._replay_flag_total != 0.0:
                return  # epoch broken: discard
        if reduce_op == int(ReduceOp.ADASUM):
            from ..ops.adasum import adasum_rows  # noqa: PLC0415

            total = adasum_rows(gathered.to(torch.float64)).to(wire)
        elif reduce_op == int(ReduceOp.MIN):
            total = gathered.to(acc).amin(0)
        elif reduce_op == int(ReduceOp.MAX):
            total = gathered.to(acc).amax(0)
        else:
            total = gathered.to(acc).sum(0)
            if reduce_op == int(ReduceOp.AVERAGE):
                total = (total // self.world if is_int and not scaled
                         else total / self.world)
        if post != 1.0:
            total = total.to(acc) * post
        self._scatter_results(entries, shapes, total)

    def _local_or_zeros(self, e, shape, dtype, device) -> torch.Tensor:
        if e is None or e.tensor is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        return self._payload(e, device)

    def _execute_allgather(self, resp: Response, entries) -> None:
        e = entries[0]
        sizes = resp.tensor_sizes
        max_d0 = max(sizes) if sizes else 0
        tail = tuple(getattr(resp, "_shapes", [(0,)])[0][1:])
        wire = _torch_dtype(getattr(resp, "_dtype", "float32"))
        on_device = self._use_device(resp)
        device = self._device_plane.device if on_device else torch.device("cpu")
        # a joined rank: an all-pad buffer (its size was negotiated as 0)
        local = self._local_or_zeros(e, (0,) + tail, wire, device)
        # ragged: pad dim 0 to the negotiated max (reference negotiates
        # per-rank sizes, Response::tensor_sizes, controller.cc:453-518)
        pad = max_d0 - local.shape[0]
        if pad:
            local = torch.cat(
                [local, local.new_zeros((pad,) + tuple(local.shape[1:]))])
        if on_device:
            gathered = self._device_plane.allgather(local)
            self.stats["device_data_ops"] += 1
            self.stats["device_payload_bytes"] += (
                gathered.numel() * gathered.element_size())
        else:
            gathered = self._data_allgather(local)
        if e is None:
            return
        self._deliver(e, torch.cat(
            [gathered[r, :sizes[r]] for r in range(self.world)]))

    def _execute_broadcast(self, resp: Response, entries) -> None:
        e = entries[0]
        shape = tuple(getattr(resp, "_shapes", [()])[0])
        name = getattr(resp, "_dtype", "float32")
        wire = _torch_dtype(name)
        root = (e.request.root_rank if e is not None
                else getattr(resp, "_root_rank", 0))
        if self._use_device(resp):
            plane = self._device_plane
            out = plane.broadcast(
                self._local_or_zeros(e, shape, wire, plane.device), int(root))
            self.stats["device_data_ops"] += 1
            self.stats["device_payload_bytes"] += out.numel() * wire.itemsize
        elif name in _STAGEABLE_DTYPES and self._staged_ok():
            local = self._local_or_zeros(e, shape, wire, torch.device("cpu"))
            out = self._host_plane.broadcast(local, int(root))
            nbytes = local.numel() * wire.itemsize
            self.stats["host_staged_ops"] += 1
            self.stats["host_wire_bytes"] += nbytes
            self.stats["host_recv_bytes"] += nbytes
        else:
            local = self._local_or_zeros(e, shape, wire, torch.device("cpu"))
            out = self._data_allgather(local)[int(root)]
        if e is not None:
            self._deliver(e, out)

    def _execute_alltoall(self, resp: Response, entries) -> None:
        e = entries[0]
        shape = tuple(getattr(resp, "_shapes", [()])[0])
        wire = _torch_dtype(getattr(resp, "_dtype", "float32"))
        # the shape is negotiated-identical, so every rank raises alike
        if not shape or shape[0] % self.world:
            raise ValueError(
                f"alltoall dim0 ({shape[0] if shape else 0}) must divide "
                f"world size ({self.world})"
            )
        if self._use_device(resp):
            plane = self._device_plane
            out = plane.alltoall(
                self._local_or_zeros(e, shape, wire, plane.device))
            self.stats["device_data_ops"] += 1
            self.stats["device_payload_bytes"] += out.numel() * wire.itemsize
            if e is not None:
                self._deliver(e, out)
            return
        local = self._local_or_zeros(e, shape, wire, torch.device("cpu"))
        gathered = self._data_allgather(local)
        if e is None:
            return
        k = shape[0] // self.world
        self._deliver(e, torch.cat(
            [gathered[r, self.rank * k:(self.rank + 1) * k]
             for r in range(self.world)]))

    def _execute_reducescatter(self, resp: Response, entries) -> None:
        """Sum across ranks, keep this rank's dim-0 rows; uneven dim0 gives
        the first (dim0 % world) ranks one extra row (the convention later
        Horovod versions adopted for hvd.reducescatter)."""
        e = entries[0]
        meta = getattr(resp, "_fuse_meta", None)
        name, reduce_op, pre, post = (
            meta if meta else ("float32", 1, 1.0, 1.0)
        )
        wire = _torch_dtype(name)
        shape = tuple(getattr(resp, "_shapes", [(0,)])[0])
        average = reduce_op == int(ReduceOp.AVERAGE)
        is_float = wire.is_floating_point
        acc = torch.float32 if name in ("bfloat16", "float16") else (
            wire if is_float else torch.int64)
        dim0 = shape[0]
        base, rem = divmod(dim0, self.world)
        start = self.rank * base + min(self.rank, rem)
        rows = base + (1 if self.rank < rem else 0)
        if self._use_device(resp):
            plane = self._device_plane
            local = self._local_or_zeros(e, shape, wire, plane.device)
            self.stats["device_data_ops"] += 1
            self.stats["device_payload_bytes"] += (
                local.numel() * wire.itemsize)
            if dim0 % self.world == 0 and is_float:
                out = plane.reducescatter(local, average, pre, post, acc)
            else:
                # uneven rows or integers: the whole sum on the card, then
                # this rank's rows (the host path's arithmetic)
                total = plane._prescaled(local, pre, acc).contiguous()
                torch.distributed.all_reduce(total, group=plane.group)
                if average:
                    total = total / self.world
                if post != 1.0:
                    total = total * post
                out = total[start:start + rows]
            if e is not None:
                self._deliver(e, out)
            return
        local = self._local_or_zeros(e, shape, wire, torch.device("cpu"))
        if pre != 1.0:
            local = (local.to(acc) * pre).to(wire)
        total = self._data_allgather(local).to(acc).sum(0)
        if average:
            total = total / self.world
        if post != 1.0:
            total = total * post
        if e is not None:
            self._deliver(e, total[start:start + rows])

    # -------------------------------------------------------- single process

    def _execute_local(self, entry: TensorTableEntry) -> None:
        """world==1: collectives are identities (with scaling applied); the
        caller's tensor comes back as itself."""
        req = entry.request
        t = entry.tensor
        if req.request_type in (RequestType.ALLREDUCE, RequestType.ADASUM):
            scale = req.prescale_factor * req.postscale_factor
            entry.future.set_result(t if scale == 1.0
                                    else (t * scale).to(t.dtype))
        elif req.request_type in (
            RequestType.ALLGATHER,
            RequestType.ALLTOALL,
            RequestType.REDUCESCATTER,
        ):
            entry.future.set_result(t)
        elif req.request_type == RequestType.BROADCAST:
            if req.root_rank not in (0, -1):
                entry.future.set_exception(
                    ValueError(
                        f"broadcast root_rank {req.root_rank} out of range "
                        f"for world size 1"
                    )
                )
            else:
                entry.future.set_result(t)
        else:
            entry.future.set_result(None)
        if entry.future.exception() is None:
            obs_flightrec.record(
                "complete", name=req.tensor_name,
                detail=req.request_type.name,
            )
            self._m_completed.inc()
            obs_progress.tick()

    def _fail_all(self, exc: Exception) -> None:
        with self._lock:
            entries = list(self._table.values())
            self._table.clear()
            self._armed.clear()
            self._armed_since.clear()
            self._done = True
            jf, self._join_future = self._join_future, None
        for e in entries:
            if not e.future.done():
                e.future.set_exception(exc)
        if jf is not None and not jf.done():
            jf.set_exception(exc)
