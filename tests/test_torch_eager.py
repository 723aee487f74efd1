"""The port's eager named-tensor API and engine (``ops/eager.py``,
``runtime/engine.py``, ``runtime/timeline.py``).

World of one, in process (``tests/test_eager.py``'s cases): collectives
are identities with the scales applied, handles resolve at enqueue, the
caller's tensor comes back as itself, a bad broadcast root raises, join and
barrier return; the Chrome-trace timeline writes the JAX timeline's events
for the same calls, up to timestamps.

A 2-rank gloo world (one spawn for the module, a 2 ms cycle and a 64-byte
fusion threshold): every async op against numpy on inputs made from a
seed — allreduce Sum / Average / Min / Max / scaled / int Average
(floor) / int64 / bf16 / fp64 / Adasum, in place, allgather even and
ragged, broadcast, alltoall, reducescatter even and ragged — with the
input's dtype kept; 16 small named tensors in one burst fuse into fewer
responses, each within the threshold; a second in-flight op under one
name and a dtype mismatch raise; ``join`` with rank 1 submitting three
more ops (rank 0 contributes zeros, Average divides by the world); last,
``shutdown`` on rank 0 with an op pending on rank 1 raises
``HorovodShutdownError`` there, and neither process hangs (the world's
timeout).  Tolerances: exact for sums the dtype holds exactly; fp32 1e-6
relative for means and scales; bf16 2^-7 (the inputs and the sum each
rounded to bf16's 8 bits); Adasum 1e-6 against ``_numpy_adasum_rows`` in
fp64.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import _torch_world
from horovod_tpu.ops.adasum import _numpy_adasum_rows
from horovod_tpu.runtime.timeline import Timeline as JaxTimeline
from horovod_tpu_torch.runtime.timeline import Timeline

WORLD = 2


@pytest.fixture(scope="module")
def hvd1():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


# ---------------------------------------------------------- world of one


def test_allreduce_identity_and_scaling(hvd1):
    x = torch.arange(6.0)
    assert torch.equal(hvd1.synchronize(hvd1.allreduce_async(x, hvd1.Sum)), x)
    out = hvd1.synchronize(hvd1.allreduce_async(
        x, hvd1.Sum, prescale_factor=2.0, postscale_factor=3.0))
    assert torch.equal(out, x * 6.0)


def test_async_handle_poll_synchronize(hvd1):
    x = torch.ones(3)
    h = hvd1.allreduce_async(x, name="h1")
    assert hvd1.poll(h)  # a world of one resolves at enqueue
    out = hvd1.synchronize(h)
    assert out is x  # the caller's tensor, no copy


def test_allgather_and_broadcast_identity(hvd1):
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 2)
                         .astype(np.float32))
    assert torch.equal(hvd1.synchronize(hvd1.allgather_async(x)), x)
    assert torch.equal(hvd1.synchronize(hvd1.broadcast_async(x, 0)), x)
    y = torch.zeros(2, dtype=torch.bfloat16)
    assert hvd1.synchronize(hvd1.broadcast_async_(y, 0)) is y


def test_broadcast_bad_root_raises(hvd1):
    from horovod_tpu_torch.ops import eager

    with pytest.raises(ValueError, match="out of range"):
        eager.broadcast(torch.ones(2), root_rank=3)


def test_join_and_barrier_single_process(hvd1):
    from horovod_tpu_torch.ops import eager

    assert hvd1.join() == 0
    eager.barrier()  # must not hang


def test_unnamed_ops_get_sequence_names(hvd1):
    from horovod_tpu_torch.ops import eager

    a, b = eager._auto_name("allreduce"), eager._auto_name("allreduce")
    assert a.startswith("allreduce.noname.") and a != b


def _timeline_events(cls, path):
    tl = cls(str(path), rank=0, mark_cycles=True)
    tl.negotiate_start("grad0", "ALLREDUCE")
    tl.negotiate_rank_ready("grad0", 0)
    tl.negotiate_rank_ready("grad0", 1)
    tl.negotiate_end("grad0", "ALLREDUCE")
    tl.start("grad0", "ALLREDUCE")
    tl.mark_cycle()
    tl.activity_start("grad0", "EXECUTE")
    tl.activity_end("grad0")
    tl.counter("skew", {"ms": 1.5})
    tl.end("grad0", "ALLREDUCE")
    tl.shutdown()
    events = json.loads(path.read_text())
    for e in events:
        e.pop("ts")
    return events


def test_timeline_matches_the_jax_timeline(tmp_path):
    """The same calls write the same Chrome-trace events (B/E/i/C/M),
    timestamps aside; the file is plain valid JSON once shut down."""
    mine = _timeline_events(Timeline, tmp_path / "port.json")
    ref = _timeline_events(JaxTimeline, tmp_path / "jax.json")
    assert mine == ref
    assert {"NEGOTIATE_ALLREDUCE", "ALLREDUCE", "CYCLE_START"} <= \
        {e["name"] for e in mine}


def test_timeline_disabled_is_noop(tmp_path):
    tl = Timeline(None, rank=0)
    assert not tl.enabled
    tl.start("x", "ALLREDUCE")  # must not crash
    tl.shutdown()


def test_native_engine_is_not_ported(hvd1, monkeypatch):
    from horovod_tpu_torch import NotPortedError, _engine_registry

    monkeypatch.setenv("HVDTPU_EAGER_ENGINE", "native")
    with pytest.raises(NotPortedError, match="A15"):
        _engine_registry._make_engine("native")


# ------------------------------------------------------- 2-rank gloo world


def _inputs():
    rng = np.random.RandomState(0)
    return {
        "x": rng.randn(WORLD, 6).astype(np.float32),
        "i": rng.randint(-50, 50, (WORLD, 6)).astype(np.int32),
        "l": rng.randint(-2**40, 2**40, (WORLD, 3)).astype(np.int64),
        "rows": rng.randn(WORLD, 4, 3).astype(np.float32),
        "odd": rng.randn(WORLD, 5, 2).astype(np.float32),
        "ragged": [rng.randn(2 + r, 3).astype(np.float32)
                   for r in range(WORLD)],
    }


@pytest.fixture(scope="module")
def world():
    inputs = _inputs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HVDTPU_CYCLE_TIME", "2")
        mp.setenv("HVDTPU_FUSION_THRESHOLD", "64")
        results = _torch_world.run_world(_torch_world.eager_worker,
                                         (inputs,), world=WORLD, timeout=60)
    return inputs, results


def _expected(inputs):
    x, rows = inputs["x"].astype(np.float64), inputs["rows"]
    i = inputs["i"]
    return {
        "sum": x.sum(0), "avg": x.mean(0), "min": x.min(0), "max": x.max(0),
        "scaled": (inputs["x"] * 2.0).astype(np.float64).sum(0) * 0.25,
        "int_avg": np.floor_divide(i.astype(np.int64).sum(0), WORLD),
        "i64_sum": inputs["l"].sum(0),
        "bf16_sum": x.sum(0),
        "f64_avg": x.mean(0),
        "adasum": _numpy_adasum_rows(x),
        "allgather": np.concatenate(list(rows)),
        "allgather_ragged": np.concatenate(inputs["ragged"]),
        "broadcast": x[1],
    }


@pytest.mark.parametrize("case,rtol", [
    ("sum", 1e-6), ("avg", 1e-6), ("min", 0), ("max", 0), ("scaled", 1e-6),
    ("int_avg", 0), ("i64_sum", 0), ("bf16_sum", 2 ** -7), ("f64_avg", 1e-6),
    ("adasum", 1e-6), ("allgather", 0), ("allgather_ragged", 0),
    ("broadcast", 0),
])
def test_every_rank_gets_the_reduction(world, case, rtol):
    inputs, results = world
    want = _expected(inputs)[case]
    for out in results:
        np.testing.assert_allclose(out[case], want, rtol=rtol, atol=rtol)


def test_results_keep_the_input_dtype(world):
    _, results = world
    for out in results:
        assert out["dtypes"]["int_avg"] == "torch.int32"
        assert out["dtypes"]["bf16_sum"] == "torch.bfloat16"
        assert out["dtypes"]["f64_avg"] == "torch.float64"
        assert out["dtypes"]["sum"] == "torch.float32"
        assert out["dtypes"]["i64_sum"] == "torch.int64"


def test_alltoall_and_reducescatter(world):
    inputs, results = world
    rows, odd = inputs["rows"], inputs["odd"]
    total_odd = odd.sum(0) / WORLD
    for r, out in enumerate(results):
        # alltoall: block r of every rank, in rank order
        np.testing.assert_array_equal(
            out["alltoall"],
            np.concatenate([rows[q][2 * r:2 * r + 2] for q in range(WORLD)]))
        np.testing.assert_allclose(out["reducescatter"],
                                   rows.sum(0)[2 * r:2 * r + 2], rtol=1e-6)
        # 5 rows over 2 ranks: rank 0 keeps 3, rank 1 keeps 2
        lo = [0, 3][r]
        np.testing.assert_allclose(out["reducescatter_ragged"],
                                   total_odd[lo:lo + 3 - r], rtol=1e-6)


def test_inplace_allreduce_writes_its_argument(world):
    inputs, results = world
    for out in results:
        assert out["inplace_is_arg"]
        np.testing.assert_allclose(out["inplace"], inputs["x"].sum(0),
                                   rtol=1e-6)


def test_small_named_tensors_fuse_within_the_threshold(world):
    _, results = world
    for out in results:
        assert out["burst"] == [2.0 * i for i in range(16)]
        responses = out["burst_responses"]
        assert sorted(n for names, _ in responses for n in names) == \
            sorted(f"fuse.{i}" for i in range(16))
        assert len(responses) < 16
        assert all(nbytes <= 64 for _, nbytes in responses)
        assert out["stats"]["fused_responses"] >= 1


def test_duplicate_name_and_dtype_mismatch_raise(world):
    _, results = world
    for out in results:
        assert "same name" in out["duplicate"]
        assert "Mismatched data types" in out["mismatch"]


def test_join_with_uneven_submissions(world):
    """Rank 0 joined: rank 1's three late averages see rank 0's zeros and
    divide by the world, as the reference's controller and engine do."""
    inputs, results = world
    for k, got in enumerate(results[1]["after_join"]):
        np.testing.assert_allclose(got, inputs["x"][1] * (k + 1) / WORLD,
                                   rtol=1e-6)
    assert [out["join"] for out in results] == [WORLD - 1] * WORLD


def test_host_payloads_take_the_gloo_plane(world):
    """CPU payloads reduce on the engine's gloo group: the stageable dtypes
    in place (O(bytes)), the rest by the exact raw gather; nothing rides
    the device plane on a CPU world."""
    _, results = world
    for out in results:
        stats = out["stats"]
        assert stats["host_staged_ops"] > 0
        assert stats["host_data_ops"] > 0
        assert stats["device_data_ops"] == 0
        assert stats["negotiated_cycles"] > 0 and stats["cycles"] > 0


def test_shutdown_with_a_pending_peer_op(world):
    """``hvd.shutdown()`` on rank 0 stops its engine first: the coordinated
    shutdown flag reaches rank 1's engine, whose pending op fails with
    HorovodShutdownError; both processes returned (no hang)."""
    _, results = world
    assert results[0]["shutdown_error"] is None
    assert results[1]["shutdown_error"] == "HorovodShutdownError"
