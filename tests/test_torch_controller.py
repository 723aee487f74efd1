"""The port's negotiation protocol against the JAX package's.

``horovod_tpu_torch/runtime/{messages,response_cache,controller}.py`` are
copies of the JAX package's jax-free modules.  The decision tables of
``tests/test_controller.py`` and ``tests/test_response_cache.py`` rerun on
the port's copies, and a differential test feeds one seeded stream of
RequestLists (mixed names, dtypes, shapes, reduce ops, ragged allgathers,
dtype conflicts, joins, and a shutdown) through both controllers, each
with its own response cache: every cycle's responses, fusion groups and
metadata, the controller state and the cache's slots and schedule keys
must be identical (exact: the inputs are the same and the functions are
deterministic; no tolerance).
"""

import logging

import numpy as np
import pytest

from horovod_tpu.runtime import controller as jctl
from horovod_tpu.runtime import messages as jmsg
from horovod_tpu.runtime import response_cache as jrc
from horovod_tpu_torch.runtime import messages as pmsg
from horovod_tpu_torch.runtime import response_cache as rc
from horovod_tpu_torch.runtime.controller import (
    ControllerState,
    compute_responses,
)
from horovod_tpu_torch.runtime.messages import (
    Request,
    RequestList,
    RequestType,
    Response,
    ResponseType,
)

FUSION = 64 * 1024 * 1024


def req(rank, name, rtype=RequestType.ALLREDUCE, shape=(4,), dtype="float32",
        **kw):
    return Request(request_rank=rank, request_type=rtype, tensor_name=name,
                   dtype=dtype, shape=shape, **kw)


def cycle(state, lists):
    return compute_responses(state, lists, fusion_threshold_bytes=FUSION)


# ------------------------------------------- tests/test_controller.py's table


def test_tensor_ready_only_when_all_ranks_submitted():
    state = ControllerState(world_size=2)
    out, _ = cycle(state, [RequestList([req(0, "t")]), RequestList([])])
    assert out == []
    out, _ = cycle(state, [RequestList([]), RequestList([req(1, "t")])])
    assert len(out) == 1
    assert out[0].response_type == ResponseType.ALLREDUCE
    assert out[0].tensor_names == ["t"]


def test_request_list_roundtrip():
    rl = RequestList(
        [req(1, "x", RequestType.BROADCAST, (2, 3), "int32", root_rank=1)],
        shutdown=True, joined=False)
    back = RequestList.deserialize(rl.serialize())
    assert back.shutdown and not back.joined
    assert back.requests[0].tensor_name == "x"
    assert back.requests[0].request_type == RequestType.BROADCAST
    assert back.requests[0].shape == (2, 3)
    assert back.requests[0].root_rank == 1


def test_wire_format_is_the_references():
    """Both packages read each other's serialized RequestLists."""
    rl = RequestList([req(2, "w", RequestType.ALLGATHER, (3, 5), "bfloat16",
                          device=True)], joined=True, tuned_params=(1, 2.0))
    back = jmsg.RequestList.deserialize(rl.serialize())
    assert back.serialize() == rl.serialize()
    assert RequestList.deserialize(back.serialize()) == rl


@pytest.mark.parametrize("field,value,message", [
    ("dtype", "int32", "Mismatched data types"),
    ("shape", (5,), "Mismatched shapes"),
])
def test_mismatch_produces_error_response(field, value, message):
    state = ControllerState(world_size=2)
    out, _ = cycle(state, [RequestList([req(0, "t")]),
                           RequestList([req(1, "t", **{field: value})])])
    assert out[0].response_type == ResponseType.ERROR
    assert message in out[0].error_message


def test_allgather_ragged_sizes_negotiated():
    state = ControllerState(world_size=3)
    out, _ = cycle(state, [
        RequestList([req(0, "g", RequestType.ALLGATHER, (2, 7))]),
        RequestList([req(1, "g", RequestType.ALLGATHER, (5, 7))]),
        RequestList([req(2, "g", RequestType.ALLGATHER, (1, 7))]),
    ])
    assert out[0].response_type == ResponseType.ALLGATHER
    assert out[0].tensor_sizes == [2, 5, 1]


@pytest.mark.parametrize("shapes,message", [
    (((), ()), "1-dimensional"),
    (((2, 7), (5, 8)), "beyond dim 0"),
])
def test_allgather_bad_shapes_are_errors(shapes, message):
    """A 0-d allgather or one whose trailing dims differ is an ERROR
    response, not an exception that kills the engine loop."""
    state = ControllerState(world_size=2)
    out, _ = cycle(state, [
        RequestList([req(r, "g", RequestType.ALLGATHER, s)])
        for r, s in enumerate(shapes)])
    assert out[0].response_type == ResponseType.ERROR
    assert message in out[0].error_message


def test_broadcast_root_mismatch_is_error():
    state = ControllerState(world_size=2)
    out, _ = cycle(state, [
        RequestList([req(0, "b", RequestType.BROADCAST, root_rank=0)]),
        RequestList([req(1, "b", RequestType.BROADCAST, root_rank=1)]),
    ])
    assert out[0].response_type == ResponseType.ERROR
    assert "root rank" in out[0].error_message.lower()


def test_fusion_groups_same_dtype_adjacent_allreduces():
    state = ControllerState(world_size=1)
    out, _ = cycle(state, [RequestList([
        req(0, "a"), req(0, "b"), req(0, "c", dtype="int32"), req(0, "d")])])
    # a+b fuse; c breaks the run (dtype); d starts a new group
    assert [r.tensor_names for r in out] == [["a", "b"], ["c"], ["d"]]


def test_fusion_respects_threshold():
    state = ControllerState(world_size=1)
    big = (1024 * 1024,)  # 4 MB each at fp32
    lists = [RequestList([req(0, f"t{i}", shape=big) for i in range(4)])]
    out, _ = compute_responses(state, lists,
                               fusion_threshold_bytes=8 * 1024 * 1024)
    assert [r.tensor_names for r in out] == [["t0", "t1"], ["t2", "t3"]]


def test_mixed_reduce_ops_do_not_fuse():
    state = ControllerState(world_size=1)
    out, _ = cycle(state, [RequestList([req(0, "a", reduce_op=1),
                                        req(0, "b", reduce_op=2)])])
    assert [r.tensor_names for r in out] == [["a"], ["b"]]


def test_join_lowers_required_count_and_completes():
    """reference controller.cc:219-221,263-307: joined ranks are excluded
    from readiness counting; all-joined emits a JOIN response."""
    state = ControllerState(world_size=2)
    out, _ = cycle(state, [RequestList([req(0, "t")]),
                           RequestList([], joined=True)])
    assert any(r.response_type == ResponseType.ALLREDUCE
               and r.tensor_names == ["t"] for r in out)
    assert not any(r.response_type == ResponseType.JOIN for r in out)
    out2, _ = cycle(state, [RequestList([], joined=True),
                            RequestList([], joined=True)])
    assert any(r.response_type == ResponseType.JOIN for r in out2)
    assert state.joined_ranks == set()


def test_shutdown_propagates():
    state = ControllerState(world_size=2)
    _, stop = cycle(state, [RequestList([], shutdown=True), RequestList([])])
    assert stop


def test_deterministic_order_across_cycles():
    """Responses come out in first-arrival order — identical on every rank
    because inputs are identical (the invariant replacing rank-0 bcast)."""
    state = ControllerState(world_size=2)
    cycle(state, [RequestList([req(0, "z"), req(0, "a")]), RequestList([])])
    out, _ = cycle(state, [RequestList([]),
                           RequestList([req(1, "a"), req(1, "z")])])
    assert [n for r in out for n in r.tensor_names] == ["z", "a"]


def test_stall_warning_logged(caplog):
    state = ControllerState(world_size=2)
    cycle(state, [RequestList([req(0, "stuck")]), RequestList([])])
    state.message_table[("stuck", RequestType.ALLREDUCE)].first_seen -= 100.0
    state.last_stall_check -= 100.0
    with caplog.at_level(logging.WARNING,
                         logger="horovod_tpu_torch.runtime.controller"):
        compute_responses(state, [RequestList([]), RequestList([])],
                          fusion_threshold_bytes=FUSION,
                          stall_warning_secs=60.0)
    assert any("waiting on ranks [1]" in r.getMessage()
               for r in caplog.records)


# --------------------------------------- tests/test_response_cache.py's table


def _creq(name, shape=(2,), dtype="float32", rtype=RequestType.ALLREDUCE,
          reduce_op=1):
    return Request(request_rank=0, request_type=rtype, tensor_name=name,
                   dtype=dtype, shape=shape, reduce_op=reduce_op)


def _cresp(name, rtype=ResponseType.ALLREDUCE):
    r = Response(rtype, [name])
    r._shapes = [(2,)]
    r._dtype = "float32"
    r._fuse_meta = ("float32", 1, 1.0, 1.0)
    r._nbytes = 8
    return r


def test_cache_miss_then_hit():
    c = rc.ResponseCache(8)
    assert c.lookup(_creq("a")) == (rc.MISS, -1)
    c.insert(_creq("a"), _cresp("a"))
    status, slot = c.lookup(_creq("a"))
    assert status == rc.HIT
    out = c.response_for(slot)
    assert out.tensor_names == ["a"]
    assert out._fuse_meta == ("float32", 1, 1.0, 1.0)


def test_cache_changed_params_conflict():
    c = rc.ResponseCache(8)
    c.insert(_creq("a"), _cresp("a"))
    assert c.lookup(_creq("a", shape=(3,)))[0] == rc.CONFLICT
    assert c.lookup(_creq("a", dtype="int64"))[0] == rc.CONFLICT
    c.evict_name("a")
    assert c.lookup(_creq("a")) == (rc.MISS, -1)


def test_cache_slot_allocation_is_lowest_free():
    c = rc.ResponseCache(8)
    for name in ("a", "b", "c"):
        c.insert(_creq(name), _cresp(name))
    assert [c.lookup(_creq(n))[1] for n in ("a", "b", "c")] == [0, 1, 2]
    c.evict_name("b")
    c.insert(_creq("d"), _cresp("d"))
    assert c.lookup(_creq("d"))[1] == 1


def test_cache_lru_eviction_at_capacity():
    c = rc.ResponseCache(2)
    c.insert(_creq("a"), _cresp("a"))
    c.insert(_creq("b"), _cresp("b"))
    c.touch(c.lookup(_creq("a"))[1])
    c.insert(_creq("c"), _cresp("c"))  # evicts b (least recent)
    assert [c.lookup(_creq(n))[0] for n in "abc"] == [rc.HIT, rc.MISS, rc.HIT]


def test_cache_allgather_and_barrier_not_cacheable():
    c = rc.ResponseCache(8)
    ag = _creq("g", rtype=RequestType.ALLGATHER)
    c.insert(ag, _cresp("g", ResponseType.ALLGATHER))
    assert c.lookup(ag) == (rc.MISS, -1)
    assert not rc.cacheable(RequestType.BARRIER)
    assert not rc.cacheable(RequestType.JOIN)
    assert rc.cacheable(RequestType.ADASUM)


def test_cache_capacity_zero_disables():
    c = rc.ResponseCache(0)
    c.insert(_creq("a"), _cresp("a"))
    assert c.lookup(_creq("a")) == (rc.MISS, -1)
    assert c.num_bits == 0


# ------------------------------------------------------------ differential

WORLD = 3
CYCLES = 40
_KINDS = [
    (RequestType.ALLREDUCE, 1), (RequestType.ALLREDUCE, 2),
    (RequestType.ALLREDUCE, 4), (RequestType.ADASUM, 3),
    (RequestType.ALLGATHER, 0), (RequestType.BROADCAST, 0),
    (RequestType.ALLTOALL, 0), (RequestType.REDUCESCATTER, 2),
]
_DTYPES = ["float32", "bfloat16", "int32", "float16"]


def _stream(seed: int):
    """Per cycle, each rank's list of (name, type, dtype, shape, op, root,
    pre): a pool of names, each submitted by every rank at a random cycle
    (ragged dim 0 for allgathers, an occasional dtype conflict), a run of
    small allreduces that fuse, names resubmitted (some with another
    shape), rank 2 joining at cycle 25, every rank at 34, a shutdown at the
    last cycle."""
    rng = np.random.RandomState(seed)
    pool = []
    for i in range(36):
        rtype, op = _KINDS[rng.randint(len(_KINDS))]
        shape = tuple(int(d) for d in rng.randint(1, 5, rng.randint(1, 3)))
        dtype = _DTYPES[rng.randint(4)] if rng.rand() < 0.4 else "float32"
        pool.append((f"t{i}", rtype, dtype, shape, op,
                     int(rng.randint(WORLD)),
                     float(rng.choice([1.0, 1.0, 1.0, 0.5]))))
    cycles = [[[] for _ in range(WORLD)] for _ in range(CYCLES)]
    for name, rtype, dtype, shape, op, root, pre in pool:
        for r in range(WORLD):
            c = int(rng.randint(0, 22))
            d = dtype if rng.rand() > 0.05 else "int64"  # a conflict
            s = ((int(rng.randint(1, 6)),) + shape[1:]
                 if rtype == RequestType.ALLGATHER else shape)
            cycles[c][r].append((name, rtype, d, s, op, root, pre))
    # a run of small same-kind allreduces every rank submits in one cycle,
    # in one order: they fuse up to the threshold
    for r in range(WORLD):
        cycles[5][r].extend((f"fuse{i}", RequestType.ALLREDUCE, "float32",
                             (8,), 1, -1, 1.0) for i in range(20))
    # names cached in the first half come back in the second, the same or
    # with another shape
    for i, (name, rtype, dtype, shape, op, root, pre) in enumerate(pool[:12]):
        s = shape if i % 3 else shape + (2,)
        for r in range(WORLD):
            cycles[24 + i % 8][r].append((name, rtype, dtype, s, op, root,
                                          pre))
    return cycles


def _lists(mod, cycle_reqs, k):
    out = []
    for r, reqs in enumerate(cycle_reqs):
        out.append(mod.RequestList(
            requests=[mod.Request(
                request_rank=r, request_type=mod.RequestType(int(t)),
                tensor_name=n, dtype=d, shape=s, reduce_op=op,
                root_rank=root if t == RequestType.BROADCAST else -1,
                prescale_factor=pre, device=r != 1 or len(n) % 2 == 0)
                for n, t, d, s, op, root, pre in reqs],
            joined=(r == 2 and k >= 25) or k >= 34,
            shutdown=k == CYCLES - 1))
    return out


def _resp_view(resp) -> tuple:
    return (int(resp.response_type), list(resp.tensor_names),
            resp.error_message, list(resp.tensor_sizes),
            [tuple(s) for s in getattr(resp, "_shapes", [])],
            getattr(resp, "_dtype", None), getattr(resp, "_root_rank", None),
            getattr(resp, "_device", None), getattr(resp, "_fuse_meta", None),
            getattr(resp, "_nbytes", None))


def _cache_view(cache) -> tuple:
    slots = {i: (s.signature, int(s.response_type), s.tensor_name, s.shape,
                 s.dtype, s.root_rank, s.fuse_meta, s.nbytes, s.device,
                 s.lru_tick) for i, s in cache._slots.items()}
    return slots, dict(cache._by_name), cache.schedule_key(sorted(slots))


@pytest.mark.parametrize("seed", [0, 1])
def test_port_controller_decides_as_the_reference(seed):
    cycles = _stream(seed)
    jstate = jctl.ControllerState(world_size=WORLD)
    pstate = ControllerState(world_size=WORLD)
    jcache, pcache = jrc.ResponseCache(16), rc.ResponseCache(16)
    seen = {"responses": 0, "fused": 0, "errors": 0, "join": 0,
            "allgather": 0}
    for k, cycle_reqs in enumerate(cycles):
        jout, jstop = jctl.compute_responses(
            jstate, _lists(jmsg, cycle_reqs, k),
            fusion_threshold_bytes=256, cache=jcache)
        pout, pstop = compute_responses(
            pstate, _lists(pmsg, cycle_reqs, k),
            fusion_threshold_bytes=256, cache=pcache)
        assert [_resp_view(r) for r in pout] == \
            [_resp_view(r) for r in jout], k
        assert pstop == jstop
        assert sorted(pstate.message_table) == sorted(jstate.message_table)
        assert pstate.joined_ranks == jstate.joined_ranks
        assert _cache_view(pcache) == _cache_view(jcache), k
        seen["responses"] += len(pout)
        seen["fused"] += sum(len(r.tensor_names) > 1 for r in pout)
        seen["errors"] += sum(r.response_type == ResponseType.ERROR
                              for r in pout)
        seen["join"] += sum(r.response_type == ResponseType.JOIN
                            for r in pout)
        seen["allgather"] += sum(r.response_type == ResponseType.ALLGATHER
                                 for r in pout)
    # the stream reached every decision it was built to reach
    assert pstop
    assert all(v > 0 for v in seen.values()), seen
    assert len(pcache) > 0
