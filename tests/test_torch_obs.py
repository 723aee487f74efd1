"""The port's metrics plane (``obs/registry.py``, ``obs/summary.py``,
``obs/goodput.py``, ``obs/profile.py``) against the JAX package's.

* the registry: the same instrument updates give the same snapshot (the
  reference's list of dicts, histogram quantiles included) and a dump of
  the reference's schema, key for key; ``remove_matching``;
* dumps both ways: the per-rank dumps each package's registry writes for
  the same events are read by both packages' ``summary`` to the same
  table and sections;
* the wall-clock goodput ledger classifies the same flight-recorder
  events into the same books;
* one peak-FLOPs table (``bench`` reads ``obs.profile``'s) and the MFU
  gauges' arithmetic;
* one launcher run: a 2-rank gloo job under ``--stats-summary`` prints
  the per-rank table, leaves no post-mortem and no temporary black box.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import horovod_tpu.obs.goodput as jgoodput
import horovod_tpu.obs.profile as jprofile
import horovod_tpu.obs.registry as jregistry
import horovod_tpu.obs.summary as jsummary
from horovod_tpu.models.transformer import GPT_CONFIGS as JCONFIGS
from horovod_tpu_torch import bench
from horovod_tpu_torch.models.transformer import GPT_CONFIGS
from horovod_tpu_torch.obs import goodput, profile, registry, summary

REPO = Path(__file__).resolve().parent.parent
SECTIONS = ("straggler_section", "fabric_section", "ckpt_section",
            "serve_section", "slo_section", "health_section",
            "goodput_section", "autoscale_section", "perf_section",
            "mem_section")


def _events(reg, rank: int) -> None:
    """One rank's instrument updates: every family the summary reads."""
    rng = np.random.RandomState(rank)
    reg.counter("engine.ops", kind="allreduce").inc(7 + rank)
    reg.gauge("process.rank").set(rank)
    for v in rng.lognormal(1.0, 1.5, 200):
        reg.histogram("engine.cycle_ms").observe(float(v))
    reg.counter("engine.straggler.last_arrivals", rank=str(1 - rank)).inc(
        3 + 2 * rank)
    reg.histogram("engine.straggler.skew_ms").observe(12.5 * (rank + 1))
    reg.gauge("engine.straggler.worst_skew_ms").set(40.0 + rank)
    reg.gauge("health.loss").set(2.5 - rank * 0.1)
    reg.gauge("health.grad_norm").set(1.25)
    reg.histogram("health.grad_norm_hist").observe(1.25)
    reg.gauge("health.nonfinite").set(0)
    reg.counter("health.alerts", **{"class": "loss-spike"}).inc(rank)
    reg.counter("health.divergence.checks").inc(3)
    reg.gauge("goodput.fraction").set(0.75)
    for cls, secs in (("productive_step", 7.5), ("init", 1.5),
                      ("recovery", 1.0)):
        reg.gauge("goodput.secs", **{"class": cls}).set(secs)
    reg.gauge("goodput.lost_secs", cause="respawn", epoch="1").set(1.0)
    reg.gauge("perf.mfu").set(0.41)
    reg.gauge("perf.step_ms").set(35.5)
    reg.gauge("perf.model_tflops").set(400.0)
    reg.gauge("mem.live_bytes").set(3 << 30)
    reg.gauge("mem.owner_bytes", owner="params").set(1 << 30)
    reg.gauge("mem.owner_bytes", owner="other").set(2 << 30)
    reg.counter("serve.admitted").inc(5)
    reg.histogram("serve.ttft_ms").observe(18.0)
    reg.counter("ckpt.commits").inc(2)


def _dump_all(mod, tmp_path, tag):
    d = tmp_path / tag
    d.mkdir()
    for rank in (0, 1):
        reg = mod.MetricsRegistry()
        _events(reg, rank)
        reg.dump(str(d / f"metrics.rank.{rank}.json"), rank=str(rank))
    return str(d)


def test_registry_snapshot_and_dump_match_the_reference(tmp_path):
    mine, ref = registry.MetricsRegistry(), jregistry.MetricsRegistry()
    for reg in (mine, ref):
        _events(reg, 1)
    assert mine.snapshot() == ref.snapshot()
    a = mine.dump(str(tmp_path / "a.json"), rank="1")
    b = ref.dump(str(tmp_path / "b.json"), rank="1")
    assert sorted(a) == sorted(b) and a["schema"] == b["schema"]
    assert a["metrics"] == b["metrics"]
    assert mine.remove_matching("engine.straggler.") == \
        ref.remove_matching("engine.straggler.") == 3
    assert mine.snapshot() == ref.snapshot()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_metrics_dumps_read_the_same_both_ways(tmp_path, writer):
    raw = _dump_all(registry if writer == "port" else jregistry, tmp_path,
                    writer)
    mine, ref = summary.collect_dumps(raw), jsummary.collect_dumps(raw)
    assert sorted(mine) == sorted(ref) == ["0", "1"]
    assert summary.format_summary_table(mine) == \
        jsummary.format_summary_table(ref)
    shown = 0
    for name in SECTIONS:
        got, want = getattr(summary, name)(mine), getattr(jsummary,
                                                          name)(ref)
        assert got == want, name
        shown += got is not None
    assert shown >= 5


def test_dump_paths_and_env(tmp_path, monkeypatch):
    monkeypatch.setenv("HVDTPU_RANK", "3")
    for raw in (str(tmp_path) + os.sep, str(tmp_path / "m.json"),
                str(tmp_path / "m.{rank}.json")):
        assert registry.resolve_dump_path(raw) == \
            jregistry.resolve_dump_path(raw)
    monkeypatch.setenv(registry.METRICS_DUMP_ENV, str(tmp_path) + os.sep)
    registry.reset_registry()
    try:
        registry.get_registry().counter("x").inc()
        path = registry.dump_metrics()
        assert path.endswith("metrics.rank.3.json")
        assert jsummary.collect_dumps(str(tmp_path))["3"]["metrics"]
    finally:
        registry.reset_registry()


def _ledger_events():
    """A flight-recorder ring's events: a life with a compile, steps, a
    checkpoint, a respawn and a stall."""
    rows = [("init", "rank0", -1, 0.0), ("phase", "compile", -1, 1.0),
            ("phase", "steady", -1, 3.0), ("enqueue", "t0", 1, 3.5),
            ("ckpt.begin", "s1", 1, 4.0), ("ckpt.commit", "s1", 1, 4.5),
            ("rendezvous", "epoch", 1, 6.0), ("phase", "steady", -1, 8.0),
            ("signal", "SIGUSR1", -1, 9.0), ("complete", "t1", 2, 9.5)]
    return [{"seq": i, "kind": k, "name": n, "cycle": c, "t": t,
             "detail": ""} for i, (k, n, c, t) in enumerate(rows)]


def test_goodput_ledger_books_the_same_events():
    mine = goodput.ledger_from_events(_ledger_events(), start=0.0)
    ref = jgoodput.ledger_from_events(_ledger_events(), start=0.0)
    assert mine.summary(12.0) == ref.summary(12.0)
    reg_m, reg_r = registry.MetricsRegistry(), jregistry.MetricsRegistry()
    mine.publish(reg_m, 12.0)
    ref.publish(reg_r, 12.0)
    assert reg_m.snapshot() == reg_r.snapshot()


def test_one_peak_table_and_the_mfu_gauges():
    assert bench.PEAK_FLOPS is profile.PEAK_FLOPS
    assert bench.peak_flops is profile.peak_flops
    assert profile.peak_flops("NVIDIA H100 80GB HBM3", "bf16") == 989e12
    assert profile.peak_flops("NVIDIA H100 80GB HBM3", "fp32") == 67e12
    assert profile.peak_flops("cpu", "bf16") is None
    reg = registry.MetricsRegistry()
    prof = profile.MFUProfiler(989e12 * 0.02, "NVIDIA H100 80GB HBM3",
                               registry=reg)
    assert prof.observe(0.05) == pytest.approx(0.4)
    assert reg.gauge("perf.mfu_estimate").value == 0.0
    assert reg.gauge("perf.model_tflops").value == pytest.approx(395.6)
    cpu = profile.MFUProfiler(1e9, "cpu", registry=reg)
    assert cpu.estimate and cpu.peak == profile.CPU_PEAK_ESTIMATE
    assert profile.transformer_step_flops(GPT_CONFIGS["small"], 8, 1024) \
        == jprofile.transformer_step_flops(JCONFIGS["small"], 8, 1024)


def test_campaign_still_raises_naming_a13b(tmp_path, capsys):
    """Since A13b ``bench --campaign`` hands the spec to the campaign
    driver (``bench/campaign.py``), whose unreadable-spec error exits 2,
    as the reference's does."""
    assert bench.main(["--cpu", "--campaign",
                       str(tmp_path / "spec.json")]) == 2
    assert "unreadable campaign spec" in capsys.readouterr().err


WORKER = textwrap.dedent("""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.obs import get_registry
    hvd.init(device="cpu")
    for i in range(4):
        hvd.synchronize(hvd.allreduce_async(torch.ones(4), name=f"t{i}"))
    get_registry().gauge("health.loss").set(1.5 + hvd.rank())
    get_registry().histogram("health.grad_norm_hist").observe(2.0)
    hvd.shutdown()
""")


def test_stats_summary_launcher_run(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO), HVDTPU_CYCLE_TIME="2",
               TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         "--stats-summary", sys.executable, str(script)],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "== per-rank metrics summary ==" in out.stdout
    assert "rank 0" in out.stdout and "rank 1" in out.stdout
    assert "== training health ==" in out.stdout
    assert "post-mortem" not in out.stdout
    # the launcher's temporary metrics and black-box dirs are gone
    assert not [p for p in os.listdir(tmp_path)
                if p.startswith(("hvdtpu_blackbox_", "hvdtpu_metrics_"))]
