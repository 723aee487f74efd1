"""The port's live telemetry plane (``obs/stream.py`` worker side,
``obs/live.py`` launcher side, ``obs/straggler.py``) against the JAX
package's.

* the compact snapshot deltas the port's publisher encodes are the
  reference's, and each package's ``LiveAggregator`` ingesting the same
  stream (several ranks, a respawned incarnation, a straggler, health,
  goodput and memory gauges) gives the same ``merged()`` view (the
  autoscale controller's input), the same console digest and history row,
  and the same Prometheus text (the help lines of the gauges whose meaning
  differs on a GPU aside);
* straggler attribution and the ``HVDTPU_ALERT_SKEW_MS`` threshold;
* one launcher run: ``--live-stats-secs`` with ``--live-port 0`` over a
  2-rank gloo job streams rounds into ``--live-history-file``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

import horovod_tpu.obs.live as jlive
import horovod_tpu.obs.registry as jregistry
import horovod_tpu.obs.straggler as jstraggler
import horovod_tpu.obs.stream as jstream
from horovod_tpu_torch.obs import live, registry, straggler, stream

REPO = Path(__file__).resolve().parent.parent
# gauges whose help text names the port's device and allocator
GPU_HELP = ("perf_mfu_estimate", "perf_model_tflops", "mem_hbm_bytes_in_use",
            "mem_live_bytes", "mem_owner_bytes")


def _populate(reg, rank: int, step: int) -> None:
    reg.counter("engine.ops", kind="allreduce").inc(3 + step)
    reg.gauge("serve.queue_depth").set(step % 3)
    for v in (1.0, 2.0 + rank, 40.0 * (step + 1)):
        reg.histogram("engine.cycle_ms").observe(v)
    reg.gauge("health.loss").set(2.0 - 0.1 * step)
    reg.gauge("health.grad_norm_z").set(0.5 * rank)
    reg.gauge("health.alert", **{"class": "loss-spike"}).set(
        1 if step == 2 else 0)
    reg.gauge("goodput.fraction").set(0.6 + 0.1 * rank)
    reg.gauge("perf.mfu").set(0.3)
    reg.gauge("mem.owner_bytes", owner="params").set(1 << 20)
    reg.counter("engine.straggler.last_arrivals", rank=str(1 - rank)).inc(
        1 + rank)


def _stream_docs(reg_mod, stream_mod):
    """The deltas two ranks (rank 1 respawned into epoch 2) publish over
    three rounds, encoded by ``stream_mod``."""
    docs = []
    for rank, epoch in ((0, 0), (1, 0), (1, 2)):
        reg, prev = reg_mod.MetricsRegistry(), {}
        for seq in range(3):
            _populate(reg, rank, seq)
            cur = stream_mod.snapshot_map(reg.snapshot())
            docs.append({"v": 1, "rank": rank, "epoch": epoch, "seq": seq,
                         "t": 1000.0 + seq, "phase": "steady",
                         "progress": 10 * seq + rank, "full": seq == 0,
                         "metrics": stream_mod.encode_delta(prev, cur)})
            prev = cur
    return docs


def test_deltas_encode_like_the_reference():
    assert _stream_docs(registry, stream) == \
        _stream_docs(jregistry, jstream)


def _help_free(text: str) -> str:
    return "\n".join(ln for ln in text.splitlines()
                     if not (ln.startswith("# HELP hvdtpu_")
                             and ln.split()[2][len("hvdtpu_"):] in GPU_HELP))


class _Clock:
    """One monotonic clock that only the test advances, read by both
    aggregators as they read ``time.monotonic`` (each view's ingest stamp
    and the age lines of the Prometheus text); the rest of ``time`` is the
    real module."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def test_aggregator_views_equal_the_reference(tmp_path, monkeypatch):
    # the perf-trend token reads benchmark records: none here, for both
    monkeypatch.setenv("HVDTPU_RECORD_DIR", str(tmp_path))
    # the digest's front-door token reads each process-global registry:
    # fresh ones, not what an earlier test of this worker left there
    monkeypatch.setattr(registry, "_registry", registry.MetricsRegistry())
    monkeypatch.setattr(jregistry, "_registry", jregistry.MetricsRegistry())
    clock = _Clock()
    monkeypatch.setattr(live, "time", clock)
    monkeypatch.setattr(jlive, "time", clock)
    docs = _stream_docs(registry, stream)
    mine, ref = live.LiveAggregator(), jlive.LiveAggregator()
    for doc in docs:
        mine.ingest(json.loads(json.dumps(doc)))
        ref.ingest(json.loads(json.dumps(doc)))
        clock.now += 0.25
    clock.now += 1.5
    got, want = mine.merged(), ref.merged()
    assert sorted(got) == sorted(want) == [0, 1]
    for rank in got:
        assert (got[rank].epoch, got[rank].metrics, got[rank].progress) == \
            (want[rank].epoch, want[rank].metrics, want[rank].progress)
    assert [(v.rank, v.epoch) for v in mine.incarnations()] == \
        [(v.rank, v.epoch) for v in ref.incarnations()]
    # past the wall-clock stamp each opens with
    assert mine.digest(2).split("]", 1)[1] == ref.digest(2).split("]", 1)[1]
    rows = [{k: v for k, v in agg.history_row(2).items() if k != "t"}
            for agg in (mine, ref)]
    assert rows[0] == rows[1]
    text, want_text = mine.prometheus(), ref.prometheus()
    assert _help_free(text) == _help_free(want_text)
    assert "hvdtpu_health_loss" in text and "hvdtpu_live_ranks_reporting" \
        in text


@pytest.mark.parametrize("alert_ms", [0.0, 30.0])
def test_straggler_attribution_matches(alert_ms):
    regs = []
    for mod, rmod in ((straggler, registry), (jstraggler, jregistry)):
        rmod.reset_registry()
        for rank, skew in ((1, 12.0), (0, 45.0), (1, 80.0)):
            mod.record(rank, skew, tensor="g", alert_ms=alert_ms)
        mod.record_waits({0: 0.0, 1: 0.4, 2: 0.01}, 0, tensor="h",
                         alert_ms=alert_ms)
        regs.append(rmod.get_registry().snapshot())
        rmod.reset_registry()
    assert regs[0] == regs[1]


WORKER = textwrap.dedent("""
    import time
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.obs import get_registry
    hvd.init(device="cpu")
    for i in range(6):
        hvd.synchronize(hvd.allreduce_async(torch.ones(4), name=f"t{i}"))
        get_registry().gauge("health.loss").set(3.0 - i)
        time.sleep(0.15)
    hvd.shutdown()
""")


def test_live_stats_launcher_run(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    history = tmp_path / "live.jsonl"
    env = dict(os.environ, PYTHONPATH=str(REPO), HVDTPU_CYCLE_TIME="2")
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         "--live-stats-secs", "0.2", "--live-port", "0",
         "--live-history-file", str(history), sys.executable, str(script)],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(ln) for ln in history.read_text().splitlines()]
    assert rows, out.stdout[-2000:]
    assert max(r["ranks_reporting"] for r in rows) == 2
    assert "/metrics" in out.stdout + out.stderr
