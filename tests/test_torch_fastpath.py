"""The port's steady-state fast path: schedule replay and the online
autotuner (``tests/test_fastpath.py``'s tables, rerun on the port).

In-process tests drive a real port ``EagerEngine`` through hand-cranked
cycles with the same seams the JAX tests use: ``_exchange`` faked as a
2-rank world whose peer mirrors this rank's requests and armed bits, and
``_data_allgather`` faked as a peer contributing the same buffer.  They
cover replay entry after k stable cycles, the epoch-check flag lane and a
break-and-renegotiate case for every deviation class (miss / conflict /
shutdown / join / tuner move / peer flag / stall).  The tuner tables run
on the port's copy of ``ParameterManager``.  One real 2-rank gloo world
(with a 2 ms cycle and replay after 5 stable cycles) shows replay
skipping the control exchange, and a straggler injected mid-epoch
(``HVDTPU_FAULT_SPEC`` delay on rank 1's enqueue) breaking the epoch on
both ranks with correct results instead of a hang; then a second engine
with the autotuner on, whose moves both ranks apply alike.  Sums of ones
are exact: no tolerance.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import _torch_world
from horovod_tpu.runtime.engine import _replay_plan_ok as jax_replay_plan_ok
from horovod_tpu.runtime.messages import Response as JaxResponse
from horovod_tpu.runtime.messages import ResponseType as JaxResponseType
from horovod_tpu_torch.obs import get_registry
from horovod_tpu_torch.ops.collectives import ReduceOp
from horovod_tpu_torch.runtime import response_cache as rcache
from horovod_tpu_torch.runtime.autotune import (
    STATE_CONVERGED,
    STATE_RETUNING,
    ParameterManager,
    TunedParams,
)
from horovod_tpu_torch.runtime.engine import EagerEngine, _replay_plan_ok
from horovod_tpu_torch.runtime.messages import (
    Request,
    RequestList,
    RequestType,
    Response,
    ResponseType,
)


@pytest.fixture(scope="module", autouse=True)
def world_of_one():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield
    hvd.shutdown()


# --------------------------------------------------------------- harness


def _mk_engine(monkeypatch, replay_after=3):
    """A real engine believing in a 2-rank world: the peer mirrors our
    requests and echoes our armed bits, and the data plane stacks our
    buffer twice (an equal-contributing peer).  No thread — cycles are
    cranked by hand."""
    eng = EagerEngine()  # world=1 topology; promote it to a fake pair
    eng.world = 2
    eng._controller.world_size = 2
    eng.replay_enabled = True
    eng.replay_after = replay_after
    calls = {"exchange": 0}

    def _ex(payload, shutdown, joined):
        calls["exchange"] += 1
        bits = np.zeros((2, eng._cache.num_bits), np.uint8)
        for slot in eng._armed:
            bits[:, slot >> 3] |= np.uint8(1 << (slot & 7))
        sd = {0} if shutdown else set()
        jn = {0, 1} if joined else set()
        if payload:
            rl = RequestList.deserialize(payload)
            peer = RequestList(
                requests=[dataclasses.replace(r, request_rank=1)
                          for r in rl.requests],
                tuned_params=rl.tuned_params)
            return sd, jn, bits, [rl, peer]
        return sd, jn, bits, None

    def _gather(local):
        return torch.stack([local, local])

    monkeypatch.setattr(eng, "_exchange", _ex)
    monkeypatch.setattr(eng, "_data_allgather", _gather)
    return eng, calls


def _submit(eng, name="g", shape=(4,), value=1.0):
    return eng.enqueue(RequestType.ALLREDUCE, name,
                       torch.full(shape, value), reduce_op=int(ReduceOp.SUM))


def _check(fut, shape=(4,)):
    assert torch.equal(fut.result(timeout=5), torch.full(shape, 2.0))


def _spin_into_replay(eng):
    """Negotiate once, then repeat identical cycles until the engine opens
    a replay epoch.  Returns the number of cycles it took."""
    n = 0
    while not eng._replaying:
        n += 1
        assert n < 50, "engine never entered replay"
        fut = _submit(eng)
        eng._run_loop_once()
        _check(fut)
    return n


# ------------------------------------------------------- replay mechanics


class TestReplayEntry:
    def test_enters_after_k_stable_cycles(self, monkeypatch):
        eng, calls = _mk_engine(monkeypatch, replay_after=3)
        n = _spin_into_replay(eng)
        assert n == 1 + eng.replay_after  # 1 payload cycle + k stable ones
        assert eng.stats["replay_epochs"] == 1
        assert eng.stats["negotiated_cycles"] == n

    def test_replay_cycles_skip_exchange_and_deliver(self, monkeypatch):
        eng, calls = _mk_engine(monkeypatch, replay_after=3)
        _spin_into_replay(eng)
        frozen = calls["exchange"]
        for _ in range(10):
            fut = _submit(eng)
            eng._run_loop_once()
            _check(fut)
        assert calls["exchange"] == frozen  # zero control-plane exchange
        assert eng.stats["replay_cycles"] == 10
        assert eng._replaying

    def test_idle_cycles_do_not_break(self, monkeypatch):
        eng, calls = _mk_engine(monkeypatch, replay_after=3)
        _spin_into_replay(eng)
        for _ in range(3):
            eng._run_loop_once()  # nothing enqueued: idle, stay in epoch
        assert eng._replaying
        assert eng.stats["replay_idle_cycles"] == 3
        fut = _submit(eng)
        eng._run_loop_once()
        _check(fut)

    def test_skip_rate_gauge_published(self, monkeypatch):
        eng, calls = _mk_engine(monkeypatch, replay_after=2)
        _spin_into_replay(eng)
        for _ in range(7):
            fut = _submit(eng)
            eng._run_loop_once()
            fut.result(timeout=5)
        get_registry().snapshot()
        skip = get_registry().gauge("engine.negotiation_skip_rate").value
        assert skip == pytest.approx(
            1 - eng.stats["negotiated_cycles"] / eng.stats["cycles"])
        assert skip > 0.5

    def test_disabled_by_env_flag(self, monkeypatch):
        monkeypatch.setenv("HVDTPU_SCHEDULE_REPLAY", "0")
        eng, calls = _mk_engine(monkeypatch, replay_after=2)
        eng.replay_enabled = False  # what __init__ reads from the env
        for _ in range(8):
            fut = _submit(eng)
            eng._run_loop_once()
            fut.result(timeout=5)
        assert not eng._replaying
        assert eng.stats["replay_epochs"] == 0


def _plan(response_cls, rtype, reduce_op=int(ReduceOp.SUM), dtype="float32",
          pre=1.0, post=1.0):
    r = response_cls(rtype, ["t"])
    r._fuse_meta = (dtype, reduce_op, pre, post)
    r._shapes = [(4,)]
    return [r]


# (reduce op, dtype, pre, world, response type): the JAX tables' cases
PLAN_CASES = [
    (int(ReduceOp.SUM), "float32", 1.0, 2, "ALLREDUCE"),
    (int(ReduceOp.AVERAGE), "float32", 1.0, 2, "ALLREDUCE"),
    (int(ReduceOp.MIN), "float32", 1.0, 2, "ALLREDUCE"),
    (int(ReduceOp.MAX), "float32", 1.0, 2, "ALLREDUCE"),
    (int(ReduceOp.ADASUM), "float32", 1.0, 2, "ALLREDUCE"),
    (int(ReduceOp.SUM), "float32", 0.0, 2, "ALLREDUCE"),
    (int(ReduceOp.AVERAGE), "int32", 1.0, 2, "ALLREDUCE"),
    (int(ReduceOp.SUM), "int32", 1.0, 2, "ALLREDUCE"),
    (int(ReduceOp.SUM), "bool", 1.0, 2, "ALLREDUCE"),
    (int(ReduceOp.SUM), "float32", 1.0, 2, "BROADCAST"),
    (int(ReduceOp.SUM), "float16", 1e-7, 2, "ALLREDUCE"),
    (int(ReduceOp.AVERAGE), "float16", 1e-3, 2, "ALLREDUCE"),
    (int(ReduceOp.AVERAGE), "float16", 1e-3, 4096, "ALLREDUCE"),
    (int(ReduceOp.AVERAGE), "bfloat16", 1e-7, 4096, "ALLREDUCE"),
]


@pytest.mark.parametrize("op,dtype,pre,world,rtype", PLAN_CASES)
def test_replay_plan_qualification_is_the_references(op, dtype, pre, world,
                                                     rtype):
    """Which memorized schedules may carry the epoch-check lane: the port
    decides as the JAX engine's ``_replay_plan_ok`` on every case of its
    table (SUM/AVERAGE qualify; MIN/MAX/ADASUM, a zero scale, an int
    AVERAGE, bool, a non-allreduce and an fp16 flag that could underflow do
    not)."""
    mine = _replay_plan_ok(
        _plan(Response, ResponseType[rtype], op, dtype, pre), world)
    ref = jax_replay_plan_ok(
        _plan(JaxResponse, JaxResponseType[rtype], op, dtype, pre), world)
    assert mine == ref
    assert not _replay_plan_ok([], 2)


# ------------------------------------------------------- deviation classes


def _break_counter(reason):
    return get_registry().counter("engine.replay_break", reason=reason)


class TestReplayBreaks:
    def test_new_tensor_breaks_and_renegotiates(self, monkeypatch):
        eng, calls = _mk_engine(monkeypatch)
        _spin_into_replay(eng)
        before = _break_counter("miss").value
        fut = _submit(eng, name="brand_new")
        eng._run_loop_once()  # replay cycle sees the MISS: break
        assert not eng._replaying
        assert eng.stats["replay_breaks"] == 1
        assert _break_counter("miss").value == before + 1
        eng._run_loop_once()  # negotiated cycle completes the new tensor
        _check(fut)

    def test_conflict_breaks_and_renegotiates(self, monkeypatch):
        eng, calls = _mk_engine(monkeypatch)
        _spin_into_replay(eng)
        before = _break_counter("conflict").value
        fut = _submit(eng, name="g", shape=(8,))  # same name, new shape
        eng._run_loop_once()
        assert not eng._replaying
        assert _break_counter("conflict").value == before + 1
        for _ in range(3):
            if fut.done():
                break
            eng._run_loop_once()
        _check(fut, (8,))

    def test_shutdown_breaks_then_propagates(self, monkeypatch):
        eng, calls = _mk_engine(monkeypatch)
        _spin_into_replay(eng)
        with eng._lock:
            eng._shutdown_requested = True
        assert eng._run_loop_once() is True  # break cycle
        assert not eng._replaying
        assert eng._run_loop_once() is False  # negotiated cycle exits

    def test_join_breaks(self, monkeypatch):
        eng, calls = _mk_engine(monkeypatch)
        _spin_into_replay(eng)
        fut = eng.join()
        eng._run_loop_once()
        assert not eng._replaying
        eng._run_loop_once()  # negotiated: both fake ranks joined -> JOIN
        assert fut.result(timeout=5) == 1

    def test_tuner_move_breaks_and_applies_params(self, monkeypatch):
        eng, calls = _mk_engine(monkeypatch)
        _spin_into_replay(eng)
        tuned = TunedParams(8 * 1048576, 0.002)
        with eng._lock:
            eng._pending_params = tuned.as_wire()
        eng._run_loop_once()  # break: tuner-move
        assert not eng._replaying
        eng._run_loop_once()  # negotiated: params ride rank 0's list
        assert eng.fusion_bytes == tuned.fusion_bytes
        assert eng.cycle_s == pytest.approx(tuned.cycle_s)

    def test_peer_flag_discards_cycle_and_requeues(self, monkeypatch):
        eng, calls = _mk_engine(monkeypatch)
        _spin_into_replay(eng)

        def _gather_peer_flag(local):
            peer = local.clone()
            peer[-1] = 1.0  # the peer's epoch-check lane says BREAK
            return torch.stack([local, peer])

        monkeypatch.setattr(eng, "_data_allgather", _gather_peer_flag)
        fut = _submit(eng)
        eng._run_loop_once()
        # the cycle's data was discarded: the future is still pending and
        # the epoch closed on this rank too
        assert not fut.done()
        assert not eng._replaying
        monkeypatch.setattr(eng, "_data_allgather",
                            lambda local: torch.stack([local, local]))
        eng._run_loop_once()  # renegotiation completes the requeued op
        _check(fut)

    def test_local_stall_breaks_epoch(self, monkeypatch):
        import time

        eng, calls = _mk_engine(monkeypatch)
        _spin_into_replay(eng)
        eng.stall_warn = 0.02
        before = _break_counter("stall").value
        eng._run_loop_once()  # idle: starts the stall clock
        assert eng._replaying
        time.sleep(0.05)
        eng._run_loop_once()  # idle past stall_warn: flagged break
        assert not eng._replaying
        assert _break_counter("stall").value == before + 1


# ------------------------------------------------- cache schedule fingerprint


class TestScheduleKey:
    def _req(self, name, shape=(4,)):
        return Request(0, RequestType.ALLREDUCE, name, "float32", shape)

    def _resp(self, name):
        r = Response(ResponseType.ALLREDUCE, [name])
        r._fuse_meta = ("float32", int(ReduceOp.SUM), 1.0, 1.0)
        return r

    def test_key_stable_without_mutation(self):
        c = rcache.ResponseCache(16)
        c.insert(self._req("a"), self._resp("a"))
        assert c.schedule_key([0]) == c.schedule_key([0])

    def test_insert_and_evict_change_key(self):
        c = rcache.ResponseCache(16)
        c.insert(self._req("a"), self._resp("a"))
        k1 = c.schedule_key([0])
        c.insert(self._req("b"), self._resp("b"))
        k2 = c.schedule_key([0])
        assert k1 != k2
        c.evict_name("b")
        assert c.schedule_key([0]) != k2

    def test_conflict_reinsert_same_slot_changes_key(self):
        c = rcache.ResponseCache(16)
        c.insert(self._req("a"), self._resp("a"))
        k1 = c.schedule_key([0])
        c.evict_name("a")
        c.insert(self._req("a", shape=(8,)), self._resp("a"))
        assert c.schedule_key([0]) != k1


# --------------------------------------------------------- online autotuner


def _pm(**kw):
    kw.setdefault("enabled", True)
    kw.setdefault("initial", TunedParams(4 * 1048576, 0.005))
    kw.setdefault("warmup_samples", 0)
    kw.setdefault("steps_per_sample", 1)
    kw.setdefault("samples_per_category", 4)
    kw.setdefault("categories",
                  [{"cache_enabled": True, "hierarchical_allreduce": False}])
    kw.setdefault("drift_threshold", 0.3)
    kw.setdefault("drift_samples", 2)
    return ParameterManager(**kw)


def _sample(pm, score):
    pm._bytes = int(score)
    pm._sample_start -= 1.0  # pretend 1 s elapsed
    return pm.cycle()


def _converge(pm, score=100.0):
    for _ in range(200):
        _sample(pm, score)
        if pm.converged:
            return
    raise AssertionError("tuner never converged")


def _drift_until_reopen(pm, score, max_windows=15):
    for _ in range(max_windows):
        moved = _sample(pm, score)
        if moved is not None:
            return moved
    raise AssertionError("drift detector never re-opened")


class TestDriftDetector:
    def test_holds_incumbent_while_stable(self):
        pm = _pm()
        _converge(pm)
        incumbent = pm.current
        for _ in range(10):
            assert _sample(pm, 100.0) is None
        assert pm.current == incumbent
        assert pm.state == STATE_CONVERGED
        assert pm.reopens == 0

    def test_jitter_does_not_reopen(self):
        pm = _pm()
        _converge(pm)
        for score in (95.0, 104.0, 92.0, 101.0, 97.0):
            assert _sample(pm, score) is None
        assert pm.reopens == 0

    def test_sustained_regression_reopens_and_reconverges(self):
        pm = _pm()
        _converge(pm)
        assert _drift_until_reopen(pm, 20.0) is not None
        assert pm.state == STATE_RETUNING
        assert pm.reopens == 1
        _converge(pm, score=50.0)  # new regime: settles again
        assert pm.state == STATE_CONVERGED

    def test_one_noisy_search_peak_does_not_thrash(self):
        """A single search window scoring moderately above steady state
        must not convict the incumbent once real hold windows arrive."""
        pm = _pm()
        spiked = False
        for _ in range(200):
            score = 100.0
            if not spiked:
                score, spiked = 115.0, True  # one +15% window
            _sample(pm, score)
            if pm.converged:
                break
        assert pm.converged
        for _ in range(30):
            assert _sample(pm, 100.0) is None
        assert pm.reopens == 0

    def test_reopen_keeps_incumbent_category(self):
        """A drift reopen retunes in the INCUMBENT's categorical config,
        not the category the chain swept last."""
        pm = _pm(categories=[
            {"cache_enabled": True, "hierarchical_allreduce": False},
            {"cache_enabled": False, "hierarchical_allreduce": False},
        ])
        for _ in range(200):
            _sample(pm, 100.0 if pm.current.cache_enabled else 10.0)
            if pm.converged:
                break
        assert pm.converged and pm.current.cache_enabled
        moved = _drift_until_reopen(pm, 20.0)
        assert moved is not None and pm.state == STATE_RETUNING
        assert moved.cache_enabled
        for _ in range(10):
            p = _sample(pm, 50.0)
            if p is not None:
                assert p.cache_enabled

    def test_settles_on_the_start_when_its_window_scored_best(self):
        """The search ends on the best point it scored, the start
        included: after a search whose first window (the start's) scored
        highest, the tuner's last proposal is the start itself."""
        pm = _pm()
        start = pm.current
        proposals = [_sample(pm, 100.0)]
        while not pm.converged:
            proposals.append(_sample(pm, 10.0))
        assert len(proposals) == pm.samples_per_category
        assert proposals[-1] == start
        assert all(p != start for p in proposals[:-1])

    def test_idle_windows_are_not_drift(self):
        pm = _pm()
        _converge(pm)
        for _ in range(10):  # eval/checkpoint pause: no bytes move
            assert _sample(pm, 0.0) is None
        assert pm.reopens == 0
        assert pm.state == STATE_CONVERGED

    def test_single_spike_resets_drift_count(self):
        pm = _pm()
        _converge(pm)
        _sample(pm, 20.0)
        _sample(pm, 100.0)  # recovery resets the counter
        _sample(pm, 20.0)
        assert pm.reopens == 0

    def test_state_gauges_published(self):
        pm = _pm()
        _converge(pm)
        reg = get_registry()
        assert reg.gauge("autotune.state").value == STATE_CONVERGED
        assert reg.gauge("autotune.best_score").value > 0
        assert reg.gauge("autotune.fusion_mb").value == pytest.approx(
            pm.current.fusion_bytes / 1048576)


class TestBusyTimeScoring:
    def test_scores_on_busy_time_not_wall_clock(self):
        feed = {"bytes": 0.0, "busy": 0.0}
        pm = ParameterManager(
            enabled=True, initial=TunedParams(4 * 1048576, 0.005),
            warmup_samples=0, steps_per_sample=1,
            metrics_source=lambda: (feed["bytes"], feed["busy"]))
        feed["bytes"], feed["busy"] = 1000.0, 0.5
        pm._sample_start -= 100.0  # 100 s of host idle on the wall clock
        pm.cycle()
        assert pm._last_score == pytest.approx(2000.0)  # 1000 B / 0.5 s

    def test_source_deltas_are_per_window(self):
        feed = {"bytes": 0.0, "busy": 0.0}
        pm = ParameterManager(
            enabled=True, initial=TunedParams(4 * 1048576, 0.005),
            warmup_samples=0, steps_per_sample=1,
            metrics_source=lambda: (feed["bytes"], feed["busy"]))
        feed["bytes"], feed["busy"] = 1000.0, 1.0
        pm.cycle()
        feed["bytes"], feed["busy"] = 1500.0, 2.0
        pm.cycle()
        assert pm._last_score == pytest.approx(500.0)  # 500 B / 1 s


class TestAutotuneLog:
    def test_append_and_single_header_across_respawn(self, tmp_path):
        log = tmp_path / "autotune.csv"
        for _ in range(2):  # second construction = elastic respawn
            pm = ParameterManager(
                enabled=True, initial=TunedParams(1048576, 0.005),
                log_path=str(log), warmup_samples=0, steps_per_sample=1)
            pm.record_bytes(1000)
            pm._sample_start -= 1.0
            pm.cycle()
        lines = log.read_text().strip().splitlines()
        assert lines[0].startswith("sample,score_bytes_per_sec")
        assert sum(1 for line in lines if line.startswith("sample,")) == 1
        assert len(lines) == 3

    def test_epoch_tagged_under_elastic(self, tmp_path, monkeypatch):
        monkeypatch.setenv("HVDTPU_ELASTIC_EPOCH", "2")
        log = tmp_path / "autotune.csv"
        pm = ParameterManager(
            enabled=True, initial=TunedParams(1048576, 0.005),
            log_path=str(log), warmup_samples=0, steps_per_sample=1)
        pm.record_bytes(1000)
        pm._sample_start -= 1.0
        pm.cycle()
        assert not log.exists()  # the predecessor's file is untouched
        assert len((tmp_path / "autotune.e2.csv").read_text()
                   .strip().splitlines()) == 2


# ------------------------------------------------------- 2-rank gloo world


@pytest.fixture(scope="module")
def replay_world():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HVDTPU_SCHEDULE_REPLAY_CYCLES", "5")
        mp.setenv("HVDTPU_CYCLE_TIME", "2")
        # the stall budget doubles as the replay idle-break deadline
        mp.setenv("HVDTPU_STALL_CHECK_TIME_SECONDS", "0.5")
        # once, on rank 1's 60th enqueue (inside the replay epoch): stall
        # that thread for 1 s
        mp.setenv("HVDTPU_FAULT_SPEC",
                  "enqueue:rank=1:step=60:action=delay:1000")
        results = _torch_world.run_world(_torch_world.replay_worker,
                                         (80, 20), timeout=60)
    return results


def test_two_rank_replay_skips_negotiation(replay_world):
    for stats in replay_world:
        assert stats["values"] == [2.0] * 80
        assert stats["replay_epochs"] >= 1, stats
        assert stats["replay_cycles"] > 0, stats
        assert stats["negotiated_cycles"] < stats["cycles"], stats


def test_two_rank_chaos_delay_breaks_epoch_no_hang(replay_world):
    """The delayed rank idles past the stall budget, raises the
    epoch-check flag, and BOTH ranks fall back to negotiation: every
    result is right and the world ends inside its timeout."""
    assert all(s["replay_breaks"] >= 1 for s in replay_world), replay_world
    assert all(s["replay_epochs"] >= 1 for s in replay_world)


def test_two_rank_autotune_moves_every_rank_alike(replay_world):
    """The online autotuner in a real engine: rank 0 scores and proposes,
    the proposal rides its RequestList, and both ranks apply it on the
    same cycle, so they end with the same parameters, which moved from
    the start; every result is right."""
    tuners = [s["tuner"] for s in replay_world]
    assert [t["tuning"] for t in tuners] == [True, False]
    for t in tuners:
        assert t["values"] == [2.0] * 20
    assert tuners[0]["end"] == tuners[1]["end"]
    assert tuple(tuners[0]["end"][:2]) != tuple(tuners[0]["start"])
