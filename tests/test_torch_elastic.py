"""The port's elastic training (``horovod_tpu_torch.elastic``, the
progress beat ``obs.progress`` and the fault registry
``testing/faults.py``) against the JAX package's.

* Decision tables through both packages on the same inputs: the fault
  grammar, ``maybe_fail``'s counters and filters, ``corrupt_bytes`` /
  ``corrupt_grad``, and ``ProgressPolicy``'s verdicts.
* ``ElasticContext`` on a real KV store, ranks as threads: rendezvous,
  ``allreduce`` of numpy arrays and torch tensors (a bf16 tensor comes
  back bf16), the owner election, an epoch bump interrupting a wait.
* ``elastic.run``'s rollback loop, and ``State`` on a real 2-layer GPT
  with AdamW in each overlap mode: restore and adoption keep the live
  tensors' identities, and the restored runs' losses equal an
  uninterrupted run's bit for bit.
* End to end on the CPU: ``examples/elastic_train.py``'s toy loop through
  the port's ``elastic.launch`` and the JAX package's gives the same
  ``(w[0], step)``, with and without ``worker_exit:step=4:rank=1``; the
  shrink case; a deadlocked training thread found by the progress beat.
"""

from __future__ import annotations

import importlib
import json
import pickle
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_world
import horovod_tpu.elastic as j_elastic
from horovod_tpu.obs import progress as j_progress
from horovod_tpu.testing import faults as j_faults
import horovod_tpu_torch.elastic as elastic
from horovod_tpu_torch.obs import progress
from horovod_tpu_torch.elastic.context import ElasticContext
from horovod_tpu_torch.elastic.exceptions import (
    HorovodShutdownError,
    RankDroppedError,
    WorkersAvailableException,
)
from horovod_tpu_torch.run.rendezvous import KVStoreClient, KVStoreServer
from horovod_tpu_torch.testing import faults

REPO = Path(__file__).resolve().parent.parent
PKG_FAULTS = (faults, j_faults)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(faults.SPEC_ENV, raising=False)
    monkeypatch.delenv("HVDTPU_ELASTIC_EPOCH", raising=False)
    for mod in PKG_FAULTS:
        mod.reset()
    elastic.reset_context()
    progress.reset()
    yield
    for mod in PKG_FAULTS:
        mod.reset()
    elastic.reset_context()
    progress.reset()


# ---------------------------------------------------------------------------
# fault grammar and counters
# ---------------------------------------------------------------------------

SPECS = [
    "ckpt_write:step=3:rank=0,worker_exit:step=5:rank=2",
    "enqueue:name=g7:action=raise:count=2:epoch=any",
    "worker_exit:step=6:rank=0",
    "replica_push:rank=0:action=drop_replica:count=99",
    "shard_write:rank=1:action=corrupt_write",
    "grad_ready:step=2:action=flip_bits,grad_ready:action=nan_inject:epoch=1",
    "task_fn:rank=1:code=7",
    "enqueue:action=delay:250",
    "ckpt_write:action=raise:ValueError",
    "worker_exit:step=5:rank=2:action=hang",
    "enqueue:action=abort:count=3",
]


def _fields(spec):
    return {k: getattr(spec, k) for k in (
        "point", "rank", "step", "epoch", "count", "action", "code",
        "delay_ms", "exc_name", "name")}


@pytest.mark.parametrize("raw", SPECS)
def test_fault_grammar_matches_the_reference(raw):
    assert [_fields(s) for s in faults.parse_spec(raw)] == \
        [_fields(s) for s in j_faults.parse_spec(raw)]


@pytest.mark.parametrize("bad", [
    "ckpt_write:step",               # not key=value
    ":step=1",                       # no point name
    "ckpt_write:wat=1",              # unknown key
    "ckpt_write:action=explode",     # unknown action
    "ckpt_write:action=corrupt_write",   # advisory at the wrong point
    "worker_exit:action=drop_replica",
    "enqueue:action=raise:NotAnException",
])
def test_malformed_specs_raise_in_both(bad):
    for mod in PKG_FAULTS:
        with pytest.raises(ValueError):
            mod.parse_spec(bad)


def test_unwired_points_are_refused():
    """The port refuses a point it does not wire: a chaos run built on it
    would never fire.  Since A13b it wires every point of the reference:
    ``scale_admit`` and ``campaign_point`` parse in both packages, their
    advisory actions only there."""
    with pytest.raises(ValueError, match="not wired"):
        faults.parse_spec("no_such_point:action=raise")
    for spec in ("scale_admit:action=scale_fail",
                 "campaign_point:step=2:action=degrade",
                 "campaign_point:action=abort"):
        for mod in PKG_FAULTS:
            assert mod.parse_spec(spec)[0].point == spec.split(":")[0]
    for bad in ("swap_commit:action=scale_fail",
                "scale_admit:action=degrade"):
        for mod in PKG_FAULTS:
            with pytest.raises(ValueError, match="only implemented at"):
                mod.parse_spec(bad)
    # wired with the tracer (obs/trace.py) since A13a
    assert faults.parse_spec("trace_flush:action=trace_drop")[0].action \
        == "trace_drop"


# (env spec, epoch, calls): each call is (point, step, rank, name); the
# outcome of each — the advisory action returned, None, or the exception
# raised — must be the same in both packages
COUNTER_CASES = [
    ("enqueue:step=2:action=raise:count=1", "0",
     [("enqueue", None, None, None)] * 4),
    ("ckpt_write:step=7:action=raise", "0",
     [("ckpt_write", 3, 0, None), ("ckpt_write", 7, 0, None),
      ("ckpt_write", 7, 0, None)]),
    ("enqueue:rank=1:action=raise", "0",
     [("enqueue", None, 0, None), ("enqueue", None, 1, None)]),
    ("enqueue:step=1:action=raise", "1", [("enqueue", None, 0, None)]),
    ("enqueue:step=1:action=raise:epoch=any", "1",
     [("enqueue", None, 0, None)]),
    ("replica_push:rank=0:action=drop_replica:count=2", "0",
     [("replica_push", s, 0, None) for s in (1, 2, 3)]
     + [("replica_push", 4, 1, None)]),
    ("shard_write:step=3:action=corrupt_write", "0",
     [("shard_write", s, 0, None) for s in (1, 3, 3)]),
    ("grad_ready:name=g1:action=flip_bits:count=5", "0",
     [("grad_ready", 1, 0, "g0"), ("grad_ready", 1, 0, "g1"),
      ("grad_ready", 2, 0, "g1")]),
    ("enqueue:action=raise:KeyError:count=2", "0",
     [("enqueue", None, 0, None)] * 3),
    ("enqueue:action=delay:0:count=2,enqueue:step=3:action=raise", "0",
     [("enqueue", None, 0, None)] * 3),
]


def _outcomes(mod, calls):
    out = []
    for point, step, rank, name in calls:
        try:
            out.append(mod.maybe_fail(point, step=step, rank=rank,
                                      name=name))
        except (mod.InjectedFault, KeyError) as e:
            out.append(type(e).__name__)
        out.append(mod.point_count(point))
    return out


@pytest.mark.parametrize("raw,epoch,calls", COUNTER_CASES)
def test_maybe_fail_counters_match_the_reference(raw, epoch, calls,
                                                 monkeypatch):
    monkeypatch.setenv(faults.SPEC_ENV, raw)
    monkeypatch.setenv("HVDTPU_ELASTIC_EPOCH", epoch)
    got = []
    for mod in PKG_FAULTS:
        mod.reset()
        got.append(_outcomes(mod, calls))
    assert got[0] == got[1]
    fired = any(x is not None and not isinstance(x, int) for x in got[0])
    # the default epoch filter keeps a respawned worker (epoch 1) from
    # re-firing its predecessor's fault
    assert fired == (epoch == "0" or "epoch=any" in raw)


def test_corrupt_helpers_match_the_reference():
    data = bytes(range(50))
    assert faults.corrupt_bytes(data) == j_faults.corrupt_bytes(data)
    for action in ("flip_bits", "nan_inject"):
        for arr in (np.linspace(-1, 1, 37, dtype=np.float32),
                    np.arange(12, dtype=np.int64).reshape(3, 4)):
            np.testing.assert_array_equal(
                faults.corrupt_grad(arr, action, rank=1, step=3, name="g"),
                j_faults.corrupt_grad(arr, action, rank=1, step=3, name="g"))


# ---------------------------------------------------------------------------
# progress beat
# ---------------------------------------------------------------------------


def test_beat_payload_round_trips_through_both_parsers():
    progress.tick(3)
    with progress.waiting():
        raw = progress.beat_payload(epoch=2)
    for mod in (progress, j_progress):
        assert mod.parse_beat(raw) == (3, "steady", True)
        assert mod.beat_epoch(raw) == 2
    assert progress.parse_beat(b"garbage") == (None, None, False)
    progress.set_phase("compile")
    assert progress.phase() == "compile"
    progress.tick(to_steady=False)
    assert progress.phase() == "compile" and progress.value() == 4
    with pytest.raises(ValueError):
        progress.set_phase("warp")


def _beat(p, ph="steady", w=False):
    return json.dumps({"t": 0.0, "p": p, "ph": ph, "w": w}).encode()


# (steady, grace, observations (rank, beat or raw, now))
POLICY_CASES = [
    (2.0, 0.0, [(0, _beat(1), 0.0), (0, _beat(1), 1.0), (0, _beat(1), 2.5),
                (0, _beat(2), 3.0), (0, _beat(2), 4.9), (0, _beat(2), 5.1)]),
    (2.0, 0.0, [(1, _beat(0, "init"), 0.0), (1, _beat(0, "init"), 99.0)]),
    (2.0, 5.0, [(1, _beat(0, "compile"), 0.0),
                (1, _beat(0, "compile"), 4.0),
                (1, _beat(0, "compile"), 6.0)]),
    (2.0, 0.0, [(2, _beat(5, w=True), 0.0), (2, _beat(5, w=True), 50.0),
                (2, _beat(5), 51.0), (2, _beat(5), 54.0)]),
    (0.0, 0.0, [(0, _beat(1), 0.0), (0, _beat(1), 1e6)]),
    (2.0, 0.0, [(0, b"1729.5", 0.0), (0, b"1729.5", 100.0)]),
]


@pytest.mark.parametrize("steady,grace,obs", POLICY_CASES)
def test_progress_policy_verdicts_match_the_reference(steady, grace, obs):
    verdicts = []
    for mod in (progress, j_progress):
        policy = mod.ProgressPolicy(steady, grace)
        verdicts.append([policy.observe(r, raw, now) for r, raw, now in obs])
    assert verdicts[0] == verdicts[1]


def test_progress_policy_forgets_a_respawned_rank():
    policy = progress.ProgressPolicy(1.0)
    assert policy.observe(0, _beat(1), 0.0) is None
    assert policy.observe(0, _beat(1), 5.0) is not None
    policy.forget(0)
    assert policy.observe(0, _beat(1), 6.0) is None


# ---------------------------------------------------------------------------
# ElasticContext on a real KV store (threads as ranks)
# ---------------------------------------------------------------------------


@pytest.fixture()
def kv_world():
    server = KVStoreServer()
    server.start()
    kv = KVStoreClient(f"127.0.0.1:{server.port}", server.secret)

    def mint(epoch, world):
        kv.put("elastic", f"world_{epoch}", pickle.dumps(sorted(world)))
        kv.put("elastic", "epoch", str(epoch).encode())

    def ctx(rank, epoch=0, timeout=20.0):
        return ElasticContext(
            rank, KVStoreClient(f"127.0.0.1:{server.port}", server.secret),
            epoch=epoch, timeout=timeout)

    try:
        yield kv, mint, ctx
    finally:
        server.stop()


def _in_threads(*fns):
    out, errs = [None] * len(fns), [None] * len(fns)

    def call(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:  # noqa: BLE001 - asserted by the test
            errs[i] = e

    threads = [threading.Thread(target=call, args=(i, f), daemon=True)
               for i, f in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    return out, errs


def test_context_allreduce_of_arrays_and_tensors(kv_world):
    kv, mint, make = kv_world
    mint(0, [0, 1])
    c0, c1 = make(0), make(1)

    def rank(ctx, r):
        ctx.rendezvous()
        a = ctx.allreduce(np.full(3, float(r + 1)), name="a")
        t = ctx.allreduce(torch.full((2,), float(r + 1),
                                     dtype=torch.bfloat16), name="t")
        s = ctx.allreduce(torch.tensor([r], dtype=torch.int64),
                          average=False, name="s")
        return a, t, s, progress.value()

    out, errs = _in_threads(lambda: rank(c0, 0), lambda: rank(c1, 1))
    assert errs == [None, None]
    for a, t, s, _ in out:
        np.testing.assert_array_equal(a, np.full(3, 1.5))
        assert t.dtype == torch.bfloat16 and t.tolist() == [1.5, 1.5]
        assert s.dtype == torch.int64 and s.tolist() == [1]
    assert out[0][3] >= 3  # each completed collective ticks the beat


def test_context_sync_elects_highest_commit_count(kv_world):
    kv, mint, make = kv_world
    mint(0, [0, 1])
    c0, c1 = make(0), make(1)

    def rank(ctx, blob, n):
        ctx.rendezvous()
        return ctx.sync_state(lambda: blob, n)

    # the loser receives the owner's bytes; the owner keeps its own state
    out, errs = _in_threads(lambda: rank(c0, b"old", 1),
                            lambda: rank(c1, b"new", 3))
    assert errs == [None, None] and out == [b"new", None]


def test_context_epoch_bump_interrupts_wait(kv_world):
    kv, mint, make = kv_world
    mint(0, [0, 1])
    c0 = make(0, timeout=30)
    c0.kv.put("elastic", "ready_0_1", b"1")  # rank 1 checked in, then dies

    def bump():
        import time

        time.sleep(0.5)
        mint(1, [0, 1])

    threading.Thread(target=bump, daemon=True).start()
    c0.rendezvous()
    with pytest.raises(HorovodShutdownError, match="re-formed"):
        c0.allreduce(np.ones(2), name="x")


def test_context_dropped_rank_refuses_to_rejoin(kv_world):
    kv, mint, make = kv_world
    mint(0, [0, 2])
    with pytest.raises(RankDroppedError):
        make(1).rendezvous(timeout=2)


# ---------------------------------------------------------------------------
# elastic.run and State
# ---------------------------------------------------------------------------


class _FakeCtx:
    """Scripted context: fails the first ``fail_first`` runs of the
    wrapped fn with ``exc``."""

    def __init__(self, fail_first=0, exc=HorovodShutdownError):
        self.rank, self.size, self.epoch, self.world = 0, 1, 0, (0,)
        self.rendezvous_calls = self.sync_calls = 0
        self._fail_first, self._exc = fail_first, exc

    def rendezvous(self, timeout=None):
        self.rendezvous_calls += 1
        return self.epoch

    def world_changed(self):
        return False

    def sync_state(self, make_blob, commit_count):
        self.sync_calls += 1
        return None

    def maybe_fail(self):
        if self._fail_first > 0:
            self._fail_first -= 1
            raise self._exc("scripted failure")


@pytest.mark.parametrize("exc,fails,want_cycles", [
    (HorovodShutdownError, 2, 3), (WorkersAvailableException, 1, 2)])
def test_run_rolls_back_and_resumes(exc, fails, want_cycles, monkeypatch):
    run_mod = importlib.import_module("horovod_tpu_torch.elastic.run")
    ctx = _FakeCtx(fail_first=fails, exc=exc)
    monkeypatch.setattr(run_mod, "_ambient_context", lambda: ctx)
    state = elastic.State(step=0, log=[], w=torch.zeros(2))
    w = state.w

    @elastic.run
    def loop(state):
        while state.step < 4:
            state.w += 1.0
            ctx.maybe_fail()
            state.log = state.log + [state.step]
            state.step += 1
            state.commit()
        return state.step

    assert loop(state) == 4
    assert ctx.rendezvous_calls == ctx.sync_calls == want_cycles
    assert state.log == [0, 1, 2, 3]
    assert state.w is w and state.w.tolist() == [4.0, 4.0]


def test_run_budget_user_errors_and_dropped_ranks(monkeypatch):
    run_mod = importlib.import_module("horovod_tpu_torch.elastic.run")
    ctx = _FakeCtx(fail_first=99)
    monkeypatch.setattr(run_mod, "_ambient_context", lambda: ctx)
    monkeypatch.setenv(run_mod.MAX_RETRIES_ENV, "2")

    @elastic.run
    def doomed(state):
        ctx.maybe_fail()

    with pytest.raises(HorovodShutdownError, match="retry budget"):
        doomed(elastic.State(step=0))

    @elastic.run
    def buggy(state):
        raise ValueError("user bug")

    with pytest.raises(ValueError, match="user bug"):
        buggy(elastic.State())

    def dropped(timeout=None):
        raise RankDroppedError("rank 0 is not a member")

    ctx.rendezvous = dropped
    with pytest.raises(RankDroppedError):
        buggy(elastic.State())


def test_state_commit_restore_roundtrip_in_place():
    t = torch.arange(4.0)
    state = elastic.State(w=t, arr=np.arange(3.0), step=0,
                          meta={"lr": 0.1, "b": torch.ones(2,
                                                           dtype=torch.bfloat16)})
    state.w.add_(1)
    state.step = 3
    state.commit()
    state.w.mul_(100)
    state.arr[:] = -1
    state.step = 9
    state.meta["lr"] = 0.5
    state.meta["b"].fill_(7)
    state.restore()
    assert state.w is t and state.w.tolist() == [1.0, 2.0, 3.0, 4.0]
    assert state.arr.tolist() == [0.0, 1.0, 2.0] and state.step == 3
    assert state.meta["lr"] == 0.1
    assert state.meta["b"].dtype == torch.bfloat16
    assert state.meta["b"].tolist() == [1.0, 1.0]
    with pytest.raises(AttributeError, match="registered"):
        state.nope  # noqa: B018


def test_commit_raises_on_world_change_after_snapshot():
    ctx = _FakeCtx()
    flags = iter([True])
    ctx.world_changed = lambda: next(flags, False)
    state = elastic.State(step=0)
    state._ctx = ctx
    state.step = 5
    with pytest.raises(WorkersAvailableException):
        state.commit()
    state.step = 99
    state.restore()
    assert state.step == 5 and state.commits == 1


MODES = ("off", "bucket", "bucket+zero1")


@pytest.fixture(scope="module")
def state_runs():
    (res,) = _torch_world.run_world(_torch_world.elastic_state_worker,
                                    (MODES, 6, 3), world=1, timeout=120)
    return res


@pytest.mark.parametrize("mode", MODES)
def test_state_restore_and_adoption_keep_identities(state_runs, mode):
    """``restore()`` (to an empty optimizer state and to a commit) and a
    respawned incarnation's adoption write into the live parameters:
    the same objects, storage (ZeRO-1's flat buffers) and gradient
    buckets."""
    assert state_runs[mode]["identities_kept"] == [True, True, True]


@pytest.mark.parametrize("mode", MODES)
def test_restored_runs_equal_the_uninterrupted_run_bit_for_bit(state_runs,
                                                               mode):
    run = state_runs[mode]
    # a snapshot from before the first step clears AdamW's state
    assert run["from_start"] == run["ref"]
    assert run["rolled_back"] == run["ref"][3:]
    assert run["after_adopt"] == run["ref"][3:]


# ---------------------------------------------------------------------------
# end to end through the launchers
# ---------------------------------------------------------------------------


def _toy_train(pkg, steps):
    """``examples/elastic_train.py``'s loop through ``pkg``'s elastic
    API."""
    import importlib as _il

    import numpy as _np

    el = _il.import_module(pkg)
    ctx = el.context()
    state = el.State(w=_np.zeros(8), step=0)

    @el.run
    def loop(state):
        while state.step < steps:
            grad = _np.full(8, float(state.step + 1) * (ctx.rank + 1))
            state.w = state.w - 0.01 * ctx.allreduce(
                grad, name=f"grad{state.step}")
            state.step += 1
            state.commit()
        return float(state.w[0]), state.step

    return loop(state)


def _launch(pkg, launch, fault="", **kw):
    env = {"PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu",
           "OMP_NUM_THREADS": "1"}
    if fault:
        env["HVDTPU_FAULT_SPEC"] = fault
    return launch(_toy_train, args=(pkg, 8), env=env, timeout=120, **kw)


@pytest.fixture(scope="module")
def port_clean():
    return _launch("horovod_tpu_torch.elastic", elastic.launch, np=3)


@pytest.mark.parametrize("fault", ["", "worker_exit:step=4:rank=1"],
                         ids=["clean", "worker_exit"])
def test_toy_loop_matches_the_reference(fault, port_clean):
    if fault:
        port, job = _launch("horovod_tpu_torch.elastic", elastic.launch,
                            fault, np=3)
        events = [e[0] for e in job.trace]
        assert events.count("failure") == 1 and events.count("respawn") == 1
        assert job.epoch == 1 and job.world == [0, 1, 2]
        assert port == port_clean[0]
    else:
        port, job = port_clean
        assert [e[0] for e in job.trace] == ["spawn"] * 3
    ref, ref_job = _launch("horovod_tpu.elastic", j_elastic.launch, fault,
                           np=3)
    assert port == ref
    assert sorted(port) == [0, 1, 2]
    assert len(set(port.values())) == 1 and port[0][1] == 8
    assert job.trace == ref_job.trace


def test_shrink_when_the_respawn_budget_is_spent():
    results, job = _launch("horovod_tpu_torch.elastic", elastic.launch,
                           "worker_exit:step=3:rank=1", np=3,
                           min_workers=2, max_retries=0)
    assert job.world == [0, 2] and sorted(results) == [0, 2]
    events = [e[0] for e in job.trace]
    assert "shrink" in events and "respawn" not in events
    assert all(results[r][1] == 8 for r in results)


def test_deadlock_is_found_by_the_progress_beat(port_clean):
    """A training thread hung in a collective (``action=hang``: the
    heartbeat thread keeps beating) is killed through the progress beat
    and respawned; the peers' collective timeout is far above the run,
    so only the beat can have rescued the job."""
    results, job = elastic.launch(
        _toy_train, args=("horovod_tpu_torch.elastic", 8), np=3,
        env={"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
             "HVDTPU_FAULT_SPEC": "worker_exit:step=5:rank=2:action=hang",
             "HVDTPU_ELASTIC_TIMEOUT": "600"},
        progress_timeout=2.0, max_retries=3, timeout=120)
    assert ("progress_lost", 2, 0) in job.trace
    events = [e[0] for e in job.trace]
    assert events.count("respawn") == 1 and "heartbeat_lost" not in events
    assert results == port_clean[0]
