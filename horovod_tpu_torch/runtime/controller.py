"""Negotiation logic for the eager path (a copy of
``horovod_tpu/runtime/controller.py``: ``compute_responses`` and ``_fuse``
make the reference's decisions, decision for decision; its observability
hooks feed the port's ``obs`` planes).

Reference: horovod/common/controller.cc — the rank-0 coordinator receives
every rank's ready-tensor Requests, counts per-name readiness
(IncrementTensorCount, controller.cc:789-812), validates consistency and
builds Responses (ConstructResponse, controller.cc:378-611), fuses them
(FuseResponses, controller.cc:640-761), and broadcasts the ResponseList.

TPU redesign: the transport is a symmetric allgather (every rank sees every
rank's RequestList), so **every rank runs the identical, deterministic
controller function** below and arrives at the same ResponseList without a
coordinator broadcast leg.  This halves the control-plane round-trips
(gather+bcast -> one allgather) and removes the rank-0 special case; the
reference already relies on response construction being deterministic, we
just exploit it symmetrically.

The controller state (message table, joined set) persists across cycles in
ControllerState; readiness spans cycles exactly as in the reference (a
tensor submitted by rank 0 in cycle k and rank 1 in cycle k+3 completes in
cycle k+3).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

import logging

from ..obs import flightrec as obs_flightrec
from .messages import Request, RequestList, RequestType, Response, ResponseType

LOG = logging.getLogger(__name__)


@dataclass
class _TableEntry:
    """Per-name readiness record (reference MessageTable, controller.h:33)."""

    requests: Dict[int, Request] = field(default_factory=dict)
    first_seen: float = field(default_factory=time.monotonic)
    arrival_order: int = 0
    # rank -> (negotiation cycle index, monotonic time) of its FIRST
    # request for this entry — the raw data straggler attribution reads.
    arrivals: Dict[int, Tuple[int, float]] = field(default_factory=dict)


@dataclass
class ControllerState:
    world_size: int
    message_table: Dict[Tuple, _TableEntry] = field(default_factory=dict)
    joined_ranks: Set[int] = field(default_factory=set)
    shutdown_ranks: Set[int] = field(default_factory=set)
    arrival_counter: int = 0
    # Monotonic negotiation-cycle counter: arrival skew is attributed in
    # cycles (identical on every rank — wall clocks are not), and only
    # ops spanning >1 cycle blame anyone.
    cycle_index: int = 0
    # stall bookkeeping (reference stall_inspector.cc)
    last_stall_check: float = field(default_factory=time.monotonic)


_counter_cache: Optional[Tuple] = None


def _negotiation_counters() -> Tuple:
    """Cached (negotiation_cycles, requests_absorbed) counter handles.
    Re-resolved when the process-global registry is swapped (tests call
    reset_registry); otherwise one dict hit per process lifetime."""
    global _counter_cache
    from ..obs import get_registry  # noqa: PLC0415

    reg = get_registry()
    if _counter_cache is None or _counter_cache[0] is not reg:
        _counter_cache = (
            reg,
            reg.counter("controller.negotiation_cycles"),
            reg.counter("controller.requests_absorbed"),
        )
    return _counter_cache[1], _counter_cache[2]


def _validate(requests: Dict[int, Request]) -> Optional[str]:
    """Consistency checks the reference performs in ConstructResponse
    (controller.cc:378-611): matching dtype, op params, shapes (allreduce:
    identical; allgather: identical all-but-dim0; broadcast: identical +
    same root)."""
    reqs = list(requests.values())
    first = reqs[0]
    if first.request_type == RequestType.ALLGATHER and len(first.shape) == 0:
        return (
            f"Allgather of {first.tensor_name} requires at least a "
            f"1-dimensional tensor (got a scalar)."
        )
    if (first.request_type == RequestType.REDUCESCATTER
            and len(first.shape) == 0):
        return (
            f"Reducescatter of {first.tensor_name} requires at least a "
            f"1-dimensional tensor (got a scalar)."
        )
    for r in reqs[1:]:
        if r.dtype != first.dtype:
            return (
                f"Mismatched data types for {first.tensor_name}: "
                f"rank {first.request_rank} sent {first.dtype}, "
                f"rank {r.request_rank} sent {r.dtype}."
            )
        if r.request_type != first.request_type:
            return (
                f"Mismatched collective operations for {first.tensor_name}."
            )
        if (
            r.reduce_op != first.reduce_op
            or r.prescale_factor != first.prescale_factor
            or r.postscale_factor != first.postscale_factor
        ):
            return f"Mismatched reduce options for {first.tensor_name}."
        if first.request_type in (RequestType.ALLREDUCE, RequestType.ADASUM,
                                  RequestType.BROADCAST, RequestType.ALLTOALL,
                                  RequestType.REDUCESCATTER):
            if tuple(r.shape) != tuple(first.shape):
                return (
                    f"Mismatched shapes for {first.tensor_name}: "
                    f"{tuple(first.shape)} vs {tuple(r.shape)}."
                )
        elif first.request_type == RequestType.ALLGATHER:
            if len(r.shape) == 0:
                return (
                    f"Allgather of {first.tensor_name} requires at least a "
                    f"1-dimensional tensor (got a scalar)."
                )
            if tuple(r.shape[1:]) != tuple(first.shape[1:]):
                return (
                    f"Mismatched allgather shapes beyond dim 0 for "
                    f"{first.tensor_name}."
                )
        if first.request_type == RequestType.BROADCAST:
            if r.root_rank != first.root_rank:
                return (
                    f"Mismatched root ranks for broadcast {first.tensor_name}:"
                    f" {first.root_rank} vs {r.root_rank}."
                )
    return None


def compute_responses(
    state: ControllerState,
    all_lists: List[RequestList],
    *,
    fusion_threshold_bytes: int,
    stall_warning_secs: float = 60.0,
    stall_shutdown_secs: float = 0.0,
    alert_skew_ms: float = 0.0,
    timeline=None,
    cache=None,
) -> Tuple[List[Response], bool]:
    """One negotiation cycle: merge every rank's RequestList into the
    message table, emit ready Responses (fused), handle join/shutdown.

    Returns (responses, should_shutdown).  Deterministic: all ranks call
    with identical inputs and must produce identical outputs — this is the
    invariant the whole eager path rests on (the reference gets it by
    construction from the rank-0 broadcast; we get it from determinism).
    """
    state.cycle_index += 1
    cycle_now = time.monotonic()
    # Launcher-visible negotiation counters: the per-rank metrics dump
    # (and the live /metrics plane) carries how many cycles actually ran
    # the deterministic controller and how many requests it absorbed —
    # the denominator half of the replay fast path's skip-rate story
    # (engine.stats.negotiated_cycles is the engine-side mirror; this
    # one survives even when the engine object is torn down early).
    # Handles resolved once (engine.py's "resolved once, updates are
    # lock-free" convention): this runs on every negotiated cycle.
    m_cycles, m_absorbed = _negotiation_counters()
    m_cycles.inc()
    absorbed = sum(len(rlist.requests) for rlist in all_lists)
    if absorbed:
        m_absorbed.inc(absorbed)
    # Absorb joins & shutdowns first (reference controller.cc:219-221,256-259).
    for rank, rlist in enumerate(all_lists):
        if rlist.shutdown:
            state.shutdown_ranks.add(rank)
        if rlist.joined:
            state.joined_ranks.add(rank)

    for rlist in all_lists:
        for req in rlist.requests:
            if req.request_type == RequestType.JOIN:
                continue  # join is carried by the flag; request is a marker
            entry = state.message_table.get(req.key())
            if entry is None:
                entry = _TableEntry(arrival_order=state.arrival_counter)
                state.arrival_counter += 1
                state.message_table[req.key()] = entry
                if timeline is not None:
                    timeline.negotiate_start(
                        req.tensor_name, req.request_type.name
                    )
            if timeline is not None:
                timeline.negotiate_rank_ready(req.tensor_name, req.request_rank)
            entry.arrivals.setdefault(
                req.request_rank, (state.cycle_index, cycle_now)
            )
            entry.requests[req.request_rank] = req

    needed = state.world_size - len(state.joined_ranks)
    ready: List[Tuple[Tuple, _TableEntry]] = [
        (key, e)
        for key, e in state.message_table.items()
        if len(e.requests) >= needed
    ]
    # Deterministic order: completion order isn't globally defined, so order
    # by first-arrival counter (identical on all ranks since inputs are).
    ready.sort(key=lambda kv: kv[1].arrival_order)

    responses: List[Response] = []
    for key, entry in ready:
        del state.message_table[key]
        name, rtype = key
        # Flight recorder: negotiation completed for this op on this
        # cycle — (cycle, op) is the alignment key the cross-rank
        # post-mortem uses (deterministic controller: identical streams
        # on every rank up to the failure point).
        obs_flightrec.record(
            "negotiate", name=name, cycle=state.cycle_index,
            detail=rtype.name,
        )
        _attribute_straggler(entry, name, alert_skew_ms, timeline)
        err = _validate(entry.requests)
        if timeline is not None:
            timeline.negotiate_end(name, rtype.name)
        if err is not None:
            if cache is not None:
                # a failed renegotiation must not leave a stale entry
                cache.evict_name(name)
            responses.append(
                Response(ResponseType.ERROR, [name], error_message=err)
            )
            continue
        first = next(iter(entry.requests.values()))
        # Device-plane vote (reference Request::device): the response runs
        # as a device (NCCL) collective only when EVERY participating rank's
        # payload is device-resident — any host buffer demotes the op.
        # Deterministic (a pure function of the gathered requests), so all
        # ranks pick the same plane, which is what keeps the collectives
        # matched.
        on_device = all(r.device for r in entry.requests.values())
        if rtype == RequestType.ALLGATHER:
            sizes = [
                entry.requests[r].shape[0] if r in entry.requests else 0
                for r in range(state.world_size)
            ]
            resp = Response(ResponseType.ALLGATHER, [name], tensor_sizes=sizes)
            resp._shapes = [tuple(first.shape)]  # type: ignore[attr-defined]
            resp._dtype = first.dtype  # type: ignore[attr-defined]
            resp._device = on_device  # type: ignore[attr-defined]
            responses.append(resp)
        else:
            resp = Response(ResponseType(int(rtype)), [name])
            # Negotiated shape/dtype so joined ranks can contribute zeros
            # of the right geometry (reference tensor_queue.h:39-41).
            resp._shapes = [tuple(first.shape)]  # type: ignore[attr-defined]
            resp._dtype = first.dtype  # type: ignore[attr-defined]
            resp._root_rank = first.root_rank  # type: ignore[attr-defined]
            resp._device = on_device  # type: ignore[attr-defined]
            if rtype in (RequestType.ALLREDUCE, RequestType.ADASUM,
                         RequestType.REDUCESCATTER):
                # Fusion identity + byte size (reference keeps dtype
                # homogeneous per fusion, controller.cc:676-689).  The
                # execute path also reads this meta for wire dtype/op.
                # Note ADASUM responses still never FUSE — both engines'
                # fuse loops gate on ResponseType.ALLREDUCE — which is
                # deliberate: the reference's fused Adasum computes
                # per-tensor projection coefficients (adasum.h
                # tensor_counts, one "layer" per tensor); a whole-buffer
                # projection over concatenated tensors would change the
                # math, so each Adasum tensor keeps its own exchange here.
                resp._fuse_meta = (  # type: ignore[attr-defined]
                    first.dtype,
                    first.reduce_op,
                    first.prescale_factor,
                    first.postscale_factor,
                )
                try:
                    itemsize = np.dtype(first.dtype).itemsize
                except TypeError:
                    itemsize = 4  # bfloat16 etc. — not a numpy dtype name
                resp._nbytes = (  # type: ignore[attr-defined]
                    int(np.prod(first.shape)) * itemsize if first.shape else itemsize
                )
            if cache is not None:
                # Insert pre-fusion, in construction order — the identical
                # order on every rank is what keeps slot indices coherent
                # (reference response_cache.cc put() from ComputeResponseList).
                cache.insert(first, resp)
            responses.append(resp)

    responses = _fuse(responses, state, fusion_threshold_bytes)

    # Join completion: every rank joined -> JOIN response resets the state
    # (reference controller.cc:300-307).
    if len(state.joined_ranks) == state.world_size and state.world_size > 0:
        responses.append(Response(ResponseType.JOIN, ["join"]))
        state.joined_ranks.clear()

    _check_stalls(state, stall_warning_secs, stall_shutdown_secs)

    should_shutdown = len(state.shutdown_ranks) > 0
    return responses, should_shutdown


def _attribute_straggler(
    entry: _TableEntry, name: str, alert_skew_ms: float, timeline
) -> None:
    """Straggler attribution for one completed negotiation: the rank
    whose request arrived LAST, and the first-to-last arrival skew.

    Attribution fires only when the arrivals spanned more than one
    negotiation cycle — within a single cycle, "last" is an artifact of
    request-list ordering and every op would smear blame randomly.  The
    inputs (cycle indices, absorption order) are identical on every
    rank, so all ranks accumulate the identical attribution — the
    ``--stats-summary`` straggler section and the live digest agree no
    matter whose snapshot they read.  Wall-clock skew is this rank's
    local measurement of the same cycles (sub-cycle noise, cross-rank
    consistent to within a cycle time)."""
    if len(entry.arrivals) < 2:
        return
    items = sorted(
        enumerate(entry.arrivals.items()),
        key=lambda pair: (pair[1][1][0], pair[0]),
    )
    _, (first_rank, (first_cycle, first_t)) = items[0]
    _, (last_rank, (last_cycle, last_t)) = items[-1]
    if last_cycle <= first_cycle:
        return  # same-cycle completion: nobody kept anybody waiting
    from ..obs import straggler as obs_straggler  # noqa: PLC0415

    obs_straggler.record(
        last_rank,
        (last_t - first_t) * 1e3,
        tensor=name,
        timeline=timeline,
        alert_ms=alert_skew_ms,
    )


def _fuse(
    responses: List[Response],
    state: ControllerState,
    threshold: int,
) -> List[Response]:
    """Fuse adjacent same-type ALLREDUCE responses (reference FuseResponses,
    controller.cc:640-761, incl. the same-dtype constraint :676-689).
    Fusion metadata (dtype/size) rides on the per-rank entries at execution
    time, so here we only group names; the engine concats buffers."""
    del state
    fused: List[Response] = []
    pending: Optional[Response] = None
    pending_meta: Optional[Tuple] = None
    pending_bytes = 0

    def flush():
        nonlocal pending, pending_bytes, pending_meta
        if pending is not None:
            fused.append(pending)
        pending, pending_bytes, pending_meta = None, 0, None

    for resp in responses:
        if resp.response_type != ResponseType.ALLREDUCE:
            flush()
            fused.append(resp)
            continue
        # Fusion identity includes the data plane: a device-resident fused
        # buffer can't absorb a host-plane response (and vice versa).
        meta = (
            getattr(resp, "_fuse_meta", None),
            getattr(resp, "_device", False),
        )
        nbytes = getattr(resp, "_nbytes", 0)
        if (
            pending is None
            or pending_meta != meta
            or pending_bytes + nbytes > threshold
        ):
            flush()
            pending = resp
            pending_meta = meta
            pending_bytes = nbytes
        else:
            pending.tensor_names.extend(resp.tensor_names)
            pending._shapes.extend(  # type: ignore[attr-defined]
                resp._shapes  # type: ignore[attr-defined]
            )
            pending_bytes += nbytes
    flush()
    return fused


def _check_stalls(
    state: ControllerState, warn_secs: float, shutdown_secs: float
) -> None:
    """Reference stall_inspector.cc: warn when some ranks have submitted a
    tensor and others haven't for > warn_secs; optionally escalate."""
    now = time.monotonic()
    if now - state.last_stall_check < min(warn_secs, 10.0):
        return
    state.last_stall_check = now
    for (name, _), entry in state.message_table.items():
        age = now - entry.first_seen
        if age > warn_secs:
            missing = sorted(
                set(range(state.world_size))
                - set(entry.requests)
                - state.joined_ranks
            )
            # Aggregatable counterpart of the log line (the reference's
            # stall inspector only logs): the per-tensor counter and the
            # lagging-rank list survive the job via the metrics dump, so
            # "which rank kept everyone waiting" is answerable after the
            # fact instead of by grepping np log streams.
            from ..obs import get_registry  # noqa: PLC0415

            metrics = get_registry()
            metrics.counter("controller.stall_warnings",
                            tensor=name).inc()
            metrics.gauge("controller.stall_lagging_ranks",
                          tensor=name).set(len(missing))
            LOG.warning(
                "One or more tensors were submitted to be reduced/gathered "
                "but some ranks have not yet done so after %.0f s: tensor "
                "%s is waiting on ranks %s",
                age,
                name,
                missing,
            )
            if shutdown_secs > 0 and age > shutdown_secs:
                raise RuntimeError(
                    f"Stalled tensor {name} exceeded shutdown threshold "
                    f"({shutdown_secs}s); aborting (reference "
                    f"HOROVOD_STALL_SHUTDOWN_TIME_SECONDS behavior)."
                )
