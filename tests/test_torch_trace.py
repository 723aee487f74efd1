"""The port's tracing plane (``obs/trace.py``, ``obs/trace_merge.py``,
``obs/timeline_merge.py``) against the JAX package's.

* ``sampled()`` reaches the reference's verdict for every id and rate (a
  sha1 of the trace id: every rank and the launcher agree);
* span dumps both ways: the port's tracer and the reference's record the
  same spans, and each package's ``trace_merge`` reads either dump set to
  the same waterfall and latency report; the ``trace_drop`` fault point;
* timelines both ways: each package's ``timeline_merge`` merges either
  package's per-rank Chrome traces to the same document;
* one launcher run: ``--trace`` over a 2-rank gloo training job (gpt-nano,
  two steps) merges every rank's spans into a valid
  waterfall with one ``step`` span per rank and step.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import horovod_tpu.obs.timeline_merge as jtimeline_merge
import horovod_tpu.obs.trace as jtrace
import horovod_tpu.obs.trace_merge as jtrace_merge
import horovod_tpu.runtime.timeline as jtimeline
from horovod_tpu.testing import faults as jfaults
from horovod_tpu_torch.obs import timeline_merge, trace, trace_merge
from horovod_tpu_torch.runtime import timeline
from horovod_tpu_torch.testing import faults

REPO = Path(__file__).resolve().parent.parent
STEPS = 2


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("HVDTPU_TRACE", "HVDTPU_TRACE_SAMPLE_RATE",
                "HVDTPU_TRACE_CAPACITY", "HVDTPU_ELASTIC_EPOCH",
                "HVDTPU_FAULT_SPEC", "HVDTPU_RANK"):
        monkeypatch.delenv(var, raising=False)
    for mod in (trace, jtrace):
        mod.reset_buffer()
    faults.reset()
    jfaults.reset()
    yield
    for mod in (trace, jtrace):
        mod.reset_buffer()
    faults.reset()
    jfaults.reset()


@pytest.mark.parametrize("rate", [0.0, 0.01, 0.25, 0.5, 0.999, 1.0])
def test_sampled_verdicts_equal_the_reference(rate):
    ids = [f"req-{i}" for i in range(500)] + ["", "serve.steps", "ü-1"]
    got = [trace.sampled(i, rate) for i in ids]
    assert got == [jtrace.sampled(i, rate) for i in ids]
    if rate in (0.25, 0.5):
        assert 0 < sum(got) < len(ids)


def _record(mod, rank: int) -> None:
    """Two requests' lives and a few serving steps, as one rank."""
    base = 1000.0 + rank * 0.001
    for n, rid in enumerate(("req-a", "req-b")):
        t = base + n
        mod.add_span(rid, "ingest", t - 0.004, t - 0.003, epoch=0)
        mod.add_span(rid, "queue_wait", t, t + 0.010, epoch=0, step=3)
        mod.add_span(rid, "schedule_broadcast", t + 0.010, t + 0.012,
                     epoch=0, step=3)
        mod.add_span(rid, "admit_wait", t + 0.012, t + 0.013, epoch=0,
                     step=3)
        mod.add_span(rid, "prefill", t + 0.013, t + 0.020, epoch=0, step=3,
                     ttft_ms=20.0)
        mod.add_span(rid, "decode", t + 0.020, t + 0.060, epoch=0, step=9,
                     tokens=8)
        mod.add_span(rid, "finish", t + 0.060, t + 0.060, epoch=0, step=9,
                     reason="length", tokens=9, resumed=0)
    for step in range(3, 10):
        t = base + step * 0.01
        mod.add_span("serve.steps", "schedule_broadcast", t, t + 0.002,
                     epoch=0, step=step)
        mod.add_span("serve.steps", "decode_compute", t + 0.002, t + 0.008,
                     epoch=0, step=step, slots=2)
        mod.add_span("serve.steps", "step", t, t + 0.009, epoch=0,
                     step=step, active=2)


def _spans_dir(mod, tmp_path, tag, monkeypatch):
    d = tmp_path / tag
    d.mkdir()
    monkeypatch.setenv("HVDTPU_TRACE", str(d) + os.sep)
    for rank in (0, 1):
        mod.reset_buffer()
        _record(mod, rank)
        monkeypatch.setenv("HVDTPU_RANK", str(rank))
        assert mod.flush() is not None
    return str(d) + os.sep


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_span_dumps_merge_the_same_both_ways(tmp_path, monkeypatch,
                                             writer):
    raw = _spans_dir(trace if writer == "port" else jtrace, tmp_path,
                     writer, monkeypatch)
    paths = sorted(str(p) for p in Path(raw).glob("spans.*rank*.json"))
    assert len(paths) == 2
    mine = trace_merge.report(paths, expected_ranks=2)
    ref = jtrace_merge.report(paths, expected_ranks=2)
    assert mine == ref
    assert len(mine["requests"]) == 2 and not mine["missing_ranks"]
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    assert trace_merge.merge(paths, a) == jtrace_merge.merge(paths, b) > 0
    assert json.load(open(a)) == json.load(open(b))


def test_trace_drop_suppresses_one_flush(tmp_path, monkeypatch):
    monkeypatch.setenv("HVDTPU_TRACE", str(tmp_path) + os.sep)
    monkeypatch.setenv("HVDTPU_FAULT_SPEC", "trace_flush:action=trace_drop")
    faults.reset()
    trace.add_span("r", "prefill", 1.0, 2.0)
    assert trace.flush() is None
    assert trace.flush() is not None
    with pytest.raises(ValueError):
        faults.parse_spec("enqueue:action=trace_drop")


def _timeline_files(mod, tmp_path, tag):
    d = tmp_path / tag
    d.mkdir()
    for rank in (0, 1):
        tl = mod.Timeline(str(d / f"trace.rank.{rank}.json"), rank)
        tl.negotiate_start("grad.w", "ALLREDUCE")
        tl.negotiate_rank_ready("grad.w", 1 - rank)
        tl.negotiate_end("grad.w", "ALLREDUCE")
        tl.start("grad.w", "ALLREDUCE")
        tl.activity_start("grad.w", "EXECUTE")
        tl.activity_end("grad.w")
        tl.end("grad.w", "ALLREDUCE")
        tl.counter("straggler_skew_ms", {"skew_ms": 1.5})
        tl.shutdown()
    return str(d) + os.sep


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_timelines_merge_the_same_both_ways(tmp_path, writer):
    raw = _timeline_files(timeline if writer == "port" else jtimeline,
                          tmp_path, writer)
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    assert timeline_merge.merge_glob(raw, a) == a
    assert jtimeline_merge.merge_glob(raw, b) == b
    doc = json.load(open(a))
    assert doc == json.load(open(b))
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    assert {e.get("pid") for e in events if e.get("ph") == "B"} >= {0, 1}


WORKER = textwrap.dedent("""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.train import build_gpt_step
    step, state, _ = build_gpt_step("nano", "fp32", 2, 16,
                                    overlap_mode="bucket", device="cpu")
    for _ in range({steps}):
        state = step(*state)[:2] + state[2:]
    hvd.shutdown()
""")


def test_trace_launcher_run_merges_every_rank(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(steps=STEPS))
    spans = tmp_path / "spans"
    spans.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         "--trace", str(spans) + os.sep, sys.executable, str(script)],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[trace] waterfall" in out.stdout
    wf_path, rep_path = trace_merge.merged_output_paths(
        str(spans) + os.sep)
    events = json.load(open(wf_path))
    events = events["traceEvents"] if isinstance(events, dict) else events
    steps = [e for e in events if e.get("name") == "step"]
    assert len(steps) == 2 * STEPS
    assert json.load(open(rep_path))["missing_ranks"] == []
    # the bucket layout's annotation spans, one per bucket and rank
    assert any(e.get("name", "").startswith("bucket") for e in events)
