"""The port's front door (horovod_tpu_torch.serve.frontend) against the
reference's (horovod_tpu.serve.frontend), on the CPU.

The pure pieces decide exactly as the reference's, case for case: the
rid hash, the rejection codes of ``validate_request`` (the table of
tests/test_frontdoor.py), the pickled ``Rejection``; ``_build_recovery``
gives the same replay document over the same store contents in both
packages; and the pumps and the supervisor, which carry no model code,
ingest, fence and take over on a real KV store as the reference's do,
each package's pump writing the log the other's reader replays.
Tolerance: exact (no arithmetic).
"""

from __future__ import annotations

import pickle
import time
import zlib

import numpy as np
import pytest

import horovod_tpu.serve.frontend as jfront
import horovod_tpu.serve.service as jservice
from horovod_tpu_torch.run.rendezvous import KVStoreClient, KVStoreServer
from horovod_tpu_torch.serve import frontend, service
from horovod_tpu_torch.serve.frontend import (
    SCOPE, FrontDoor, IngestPump, Rejection, RequestRejected, ServeClient,
    _ShardFence, shard_of, validate_request,
)

# tests/test_frontdoor.py's rejection table, and more
REJECTION_CASES = [
    ({"prompt": [], "max_new_tokens": 4}, "bad_prompt"),
    ({"prompt": "abc", "max_new_tokens": 4}, "bad_prompt"),
    ({"prompt": [1, -2], "max_new_tokens": 4}, "bad_token"),
    ({"prompt": [1, 2.0], "max_new_tokens": 4}, "bad_token"),
    ({"prompt": [1, 99], "max_new_tokens": 4}, "oob_token"),
    ({"prompt": [1, 64], "max_new_tokens": 4}, "oob_token"),
    ({"prompt": [1], "max_new_tokens": 0}, "bad_budget"),
    ({"prompt": [1], "max_new_tokens": 2.0}, "bad_budget"),
    ({"prompt": [1] * 14, "max_new_tokens": 8}, "ctx_exceeded"),
    ({"prompt": [1] * 8, "max_new_tokens": 8}, None),
    ({"prompt": [1], "max_new_tokens": 2, "temperature": -1.0},
     "bad_temperature"),
    ({"prompt": [1], "max_new_tokens": 2, "temperature": "hot"},
     "bad_temperature"),
    ({"prompt": [1], "max_new_tokens": 2, "top_k": -1}, "bad_top_k"),
    ({"prompt": [1], "max_new_tokens": 2, "tenant": ""}, "bad_tenant"),
    ({"prompt": [1], "max_new_tokens": 2, "tenant": "a/b"}, "bad_tenant"),
    ({"prompt": [1], "max_new_tokens": 2, "tenant": "x" * 65},
     "bad_tenant"),
    ({"prompt": [1], "max_new_tokens": 2, "slo": "gold"}, "bad_slo"),
    ({"prompt": [1, 2], "max_new_tokens": 4, "tenant": "acme",
      "slo": "interactive"}, None),
    ({"prompt": [1, 2, 3], "max_new_tokens": 8}, "budget_exceeded"),
]


@pytest.mark.parametrize("doc,code", REJECTION_CASES)
def test_validate_request_decides_as_the_reference(doc, code):
    budget = 10 if code == "budget_exceeded" else None
    got = validate_request(doc, serve_len=16, vocab_size=64,
                           budget_tokens=budget)
    want = jfront.validate_request(doc, serve_len=16, vocab_size=64,
                                   budget_tokens=budget)
    assert (got is None) == (want is None) == (code is None)
    if code is not None:
        assert isinstance(got, Rejection) and isinstance(got, str)
        assert got.code == want.code == code
        assert str(got) == str(want)


def test_shard_of_is_the_references_crc32():
    rids = [f"rid{i}" for i in range(200)] + ["", "a", "f" * 16]
    for f in (0, 1, 2, 3, 4, 7):
        got = [shard_of(r, f) for r in rids]
        assert got == [jfront.shard_of(r, f) for r in rids]
        if f > 1:
            assert got == [zlib.crc32(r.encode()) % f for r in rids]


def test_rejection_pickles_across_packages():
    """A verdict crosses the KV wire inside a pickled result doc: the
    port's unpickles as the port's, with its code."""
    r = Rejection("ctx_exceeded", "prompt too long")
    r2 = pickle.loads(pickle.dumps(r))
    assert r2 == r and r2.code == "ctx_exceeded" and r2.message == r
    assert type(r2) is Rejection


@pytest.fixture
def kv_server():
    server = KVStoreServer()
    server.start()
    try:
        yield server
    finally:
        server.stop()


def _kv(server):
    return KVStoreClient(f"127.0.0.1:{server.port}", server.secret)


def _store_contents(kv, rng):
    """A seeded durable record: two shards with watermarks, mid-stream and
    finished requests, and a committed weight version."""
    f = 2
    kv.put(SCOPE, "log_watermark/0", b"1")
    kv.put(SCOPE, "weight_version", b"3")
    rids = []
    for shard, ns in ((0, range(1, 5)), (1, range(0, 4))):
        for n in ns:
            rid = f"s{shard}n{n}"
            rids.append(rid)
            kv.put(SCOPE, f"log/{shard}/{n}", pickle.dumps({
                "rid": rid, "shard": shard, "n": n, "gkey": n * f + shard,
                "prompt": rng.randint(0, 64, rng.randint(2, 6)).tolist(),
                "max_new_tokens": int(rng.randint(2, 9))}))
    for rid in rng.permutation(rids)[:5]:
        done = bool(rng.randint(2))
        kv.put(SCOPE, f"out/{rid}", pickle.dumps({
            "rid": rid, "done": done,
            "tokens": rng.randint(0, 64, rng.randint(1, 4)).tolist()}))
    return f


@pytest.mark.parametrize("group,groups", [(0, 1), (0, 2), (1, 2)])
def test_build_recovery_gives_the_references_replay(kv_server, group,
                                                    groups):
    kv = _kv(kv_server)
    assert service._frontdoor_shape(kv) == 1 == jservice._frontdoor_shape(kv)
    f = _store_contents(kv, np.random.RandomState(13))
    got = service._build_recovery(kv, group, groups, f)
    want = jservice._build_recovery(kv, group, groups, f)
    assert got == want
    assert got["weight_version"] == 3 and got["frontends"] == 2
    assert [e["gkey"] for e in got["inflight"]] == sorted(
        e["gkey"] for e in got["inflight"])


def test_build_recovery_merges_shards_in_gkey_order(kv_server):
    """tests/test_frontdoor.py's hand-built case, through the port."""
    kv = _kv(kv_server)

    def entry(rid, shard, n):
        return pickle.dumps({"rid": rid, "prompt": [1, 2],
                             "max_new_tokens": 2, "shard": shard,
                             "n": n, "gkey": n * 2 + shard})

    kv.put(SCOPE, "log_watermark/0", b"1")
    kv.put(SCOPE, "log/0/1", entry("a", 0, 1))
    kv.put(SCOPE, "log/0/2", entry("b", 0, 2))
    kv.put(SCOPE, "log/1/0", entry("c", 1, 0))
    kv.put(SCOPE, "log/1/1", entry("d", 1, 1))
    kv.put(SCOPE, "out/c", pickle.dumps(
        {"rid": "c", "done": True, "tokens": [9], "shard": 1, "n": 0}))
    kv.put(SCOPE, "out/a", pickle.dumps(
        {"rid": "a", "done": False, "tokens": [5], "shard": 0, "n": 1}))
    rec = service._build_recovery(kv, frontends=2)
    assert rec["log_next"] == {0: 3, 1: 2}
    assert rec["watermark"] == {0: 1, 1: 0}
    assert rec["done_slots"] == [(1, 0)]
    assert [(e["rid"], e["gkey"]) for e in rec["inflight"]] == [
        ("a", 2), ("d", 3), ("b", 4)]
    g0 = service._build_recovery(kv, group=0, groups=2, frontends=2)
    assert [e["rid"] for e in g0["inflight"]] == ["a", "b"]
    assert g0["others"] == {(1, 1): "d"}


def _wait(cond, timeout=8.0, tick=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(tick)
    return False


def _rids_for_shard(shard, frontends, count, salt=""):
    out, i = [], 0
    while len(out) < count:
        rid = f"{salt}rid{i}"
        if shard_of(rid, frontends) == shard:
            out.append(rid)
        i += 1
    return out


@pytest.mark.parametrize("pump_pkg", ["port", "jax"])
def test_pump_log_replays_the_same_in_both_packages(kv_server, pump_pkg):
    """Either package's pump writes a log (arrival stamped, gkey = n * F +
    shard) that both packages' recovery replays alike."""
    mod = frontend if pump_pkg == "port" else jfront
    kv = _kv(kv_server)
    pumps = [mod.IngestPump(kv_server, fid=s, frontends=2, gc=False)
             for s in (0, 1)]
    client = ServeClient(f"127.0.0.1:{kv_server.port}", kv_server.secret)
    kv.put(SCOPE, "frontdoor", pickle.dumps({"frontends": 2}))
    rids = [client.submit([1 + i, 2], max_new_tokens=2, rid=f"q{i}")
            for i in range(9)]
    assert sum(p.round() for p in pumps) == 9
    rec = service._build_recovery(kv, frontends=2)
    assert rec == jservice._build_recovery(kv, frontends=2)
    assert sorted(e["rid"] for e in rec["inflight"]) == sorted(rids)
    for e in rec["inflight"]:
        assert e["gkey"] == e["n"] * 2 + e["shard"]
        assert e["shard"] == shard_of(e["rid"], 2) and e["arrival"] > 0


def test_shard_fence_blocks_pump_that_lost_ownership(kv_server):
    kv = _kv(kv_server)
    fence = _ShardFence({0: 0, 1: 1})
    p0 = IngestPump(kv_server, fid=0, frontends=2, gc=False, fence=fence)
    p1 = IngestPump(kv_server, fid=1, frontends=2, gc=False, fence=fence)
    kv.put(SCOPE, "req/0/x", pickle.dumps(
        {"rid": "x", "prompt": [1], "max_new_tokens": 1}))
    assert p0.round() == 1
    fence.transfer(0, 1)
    p1.adopt([0])
    kv.put(SCOPE, "req/0/y", pickle.dumps(
        {"rid": "y", "prompt": [2], "max_new_tokens": 1}))
    assert p0.round() == 0
    assert kv.get(SCOPE, "req/0/y") is not None
    assert p1.round() == 1
    log0 = kv_server.scan(SCOPE + "/log/0/")
    assert {k: pickle.loads(b)["rid"] for k, b in log0.items()} == {
        SCOPE + "/log/0/0": "x", SCOPE + "/log/0/1": "y"}


def test_frontdoor_takeover_adopts_shards_no_drop(kv_server):
    door = FrontDoor(kv_server, frontends=2, interval=0.01,
                     heartbeat_timeout=0.3)
    client = ServeClient(f"127.0.0.1:{kv_server.port}", kv_server.secret)
    assert client.frontends() == 2
    door.start()
    try:
        s0 = _rids_for_shard(0, 2, 3)
        s1 = _rids_for_shard(1, 2, 2)
        for rid in s0 + s1:
            client.submit([1, 2], max_new_tokens=2, rid=rid)
        assert _wait(lambda: door.ingested == 5)
        door.kill(0)
        assert _wait(lambda: door.takeovers == 1)
        (ev,) = door.poll_takeover()
        assert ev["fid"] == 0 and ev["owner"] == 1 and 0 in ev["shards"]
        late = _rids_for_shard(0, 2, 2, salt="late")
        for rid in late:
            client.submit([3], max_new_tokens=1, rid=rid)
        assert _wait(lambda: door.ingested == 7)
        log0 = kv_server.scan(SCOPE + "/log/0/")
        ns = sorted(int(k.rsplit("/", 1)[1]) for k in log0)
        assert ns == list(range(len(s0) + len(late)))
        assert {pickle.loads(b)["rid"] for b in log0.values()} == \
            set(s0) | set(late)
        assert door.stats()["takeovers"] == 1
        assert 'hvdtpu_serve_frontend_up{fid="0"} 0' in door.prometheus()
    finally:
        door.stop()


def test_frontend_exit_fault_point_kills_a_pump(kv_server, monkeypatch):
    """The port wires the reference's ``frontend_beat`` point: the
    advisory ``frontend_exit`` kills the pump at its Nth beat and the
    supervisor takes over."""
    from horovod_tpu_torch.testing import faults

    monkeypatch.setenv("HVDTPU_FAULT_SPEC",
                       "frontend_beat:action=frontend_exit:step=3:rank=0")
    faults.reset()
    try:
        door = FrontDoor(kv_server, frontends=2, interval=0.01,
                         heartbeat_timeout=0.3)
        door.start()
        try:
            assert _wait(lambda: door.takeovers == 1)
            (ev,) = door.poll_takeover()
            assert ev["fid"] == 0 and ev["owner"] == 1
            assert door._gc_pump.alive()
        finally:
            door.stop()
    finally:
        monkeypatch.delenv("HVDTPU_FAULT_SPEC")
        faults.reset()


def test_client_surfaces_machine_readable_rejection(kv_server):
    kv = _kv(kv_server)
    verdict = validate_request({"prompt": [1] * 10, "max_new_tokens": 8},
                               serve_len=16)
    service._publish_out(kv, "bad", tokens=(), done=True, epoch=0,
                         admitted_step=0, error=verdict)
    client = ServeClient(f"127.0.0.1:{kv_server.port}", kv_server.secret)
    with pytest.raises(RequestRejected) as ei:
        client.result("bad", timeout=5)
    assert ei.value.code == "ctx_exceeded" and ei.value.rid == "bad"
    assert "exceeds" in ei.value.message
    # the reference's client reads the port's doc the same way
    jclient = jfront.ServeClient(f"127.0.0.1:{kv_server.port}",
                                 kv_server.secret)
    with pytest.raises(jfront.RequestRejected) as ej:
        jclient.result("bad", timeout=5)
    assert ej.value.code == "ctx_exceeded"


def test_client_frontends_fallback_is_not_cached(kv_server):
    client = ServeClient(f"127.0.0.1:{kv_server.port}", kv_server.secret)
    assert client.frontends() == 1
    _kv(kv_server).put(SCOPE, "frontdoor", pickle.dumps(
        {"frontends": 4, "owners": {s: s for s in range(4)},
         "fd_epoch": 0}))
    assert client.frontends() == 4
