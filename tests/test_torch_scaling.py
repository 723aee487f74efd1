"""The port's collective goodput and cycle-scaling gates (counterpart of
``tests/test_scaling.py``), on ``horovod_tpu_torch.bench.collective``.

* The native engine's rate of tiny allreduces at np 4 over np 2, best of
  2 live trials, must not fall below ``max(0.25, band x the recorded
  median)`` of ``horovod_tpu_torch/bench/scaling_baseline.json``: machine
  load only depresses the ratio (np 4 contends harder than np 2), so
  taking the better of two trials is one-sided flake headroom, never a
  way to pass a real regression (a serial receive loop reintroduced into
  rank 0's gather).  The reference gates np 8 over np 2; np 4 keeps this
  suite's worlds small, as its files run six at a time on shared hosts.
  The rate is rank 0's median op of 200, not the reference's mean of 40:
  beside a full run of this suite a rank descheduled for a few hundred
  milliseconds set the mean of the short loop (ratios down to 0.18),
  while a cost every op pays moves the median as much as the mean.  The
  band, 0.5, fails an np 4 op that costs more than about twice np 2's
  (the ``collective.BAND`` comment gives the data it was chosen from).
* A host float32 allreduce on the Python engine takes the staged gloo
  plane, O(bytes) on the wire, never the gather-everything host path.
* The CLI prints the reference's goodput table for both engines.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from horovod_tpu_torch.bench import collective

pytestmark = [pytest.mark.multiprocess, pytest.mark.full,
              pytest.mark.serial]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scaling_threshold() -> tuple:
    with open(collective.BASELINE_PATH) as f:
        base = json.load(f)
    return max(collective.FLOOR, base["band"] * base["np4_over_np2"]), base


def test_native_cycle_cost_sublinear_np4():
    """Per-op negotiation cost must grow sublinearly from 2 to 4 workers,
    within the band of the recorded baseline (the reference's trend gate
    with its one-sided best-of-2 rule)."""
    threshold, base = _scaling_threshold()
    assert base["band"] * base["np4_over_np2"] > collective.FLOOR, (
        "the band puts the gate under the 0.25 cliff floor: the trend gate "
        "would be inert")
    best = max(collective.rate_ratio(trials=2, stop_at=threshold))
    assert best >= threshold, (
        f"np=4/np=2 eager throughput ratio {best:.3f} fell below "
        f"{threshold:.3f} (= band {base['band']} x recorded baseline "
        f"{base['np4_over_np2']}, floor {collective.FLOOR}): negotiation "
        "cost regressed vs the recorded trend (serial recvs reintroduced?)")


def _staged_bytes_worker(nbytes: int):
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch._engine_registry import get_engine
    from horovod_tpu_torch.ops import eager

    hvd.init(device="cpu")
    try:
        x = torch.ones(nbytes // 4, dtype=torch.float32)
        out = eager.allreduce(x, op=hvd.Sum, name="staged")
        return {"sum0": float(out.reshape(-1)[0]),
                "exact": bool(torch.equal(out, x * hvd.size())),
                "stats": dict(get_engine().stats)}
    finally:
        hvd.shutdown()


ENGINES = ("python", "native")


@pytest.fixture(scope="module")
def cli_runs():
    """Both engines' CLI runs, started together (after the timing gate,
    beside the staged-reduce world) and read by the table test."""
    procs = {engine: subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.bench.collective",
         "--device", "cpu", "--engine", engine, "--np", "2", "--sizes-kb",
         "4", "--iters", "5"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO) for engine in ENGINES}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def test_staged_host_reduce_is_o_bytes_np4(cli_runs):
    """A host float32 allreduce takes the staged gloo plane (one reduce,
    wire cost O(bytes)), never the gather-everything path whose receive
    cost is O(world x bytes)."""
    from horovod_tpu_torch.run import run

    nbytes = 1 << 20  # 1 MB
    results = run(_staged_bytes_worker, (nbytes,), np=4, use_cpu=True,
                  timeout=300, env=collective._env("python"))
    for r in results:
        assert r["sum0"] == 4.0 and r["exact"]
        s = r["stats"]
        assert s["host_staged_ops"] >= 1, "staged plane was not used"
        assert s["host_data_ops"] == 0, (
            "1 MB f32 payload fell back to the gather-everything host path")
        assert s["host_recv_bytes"] <= 1.5 * nbytes, (
            f"recv bytes {s['host_recv_bytes']} ~ O(world x bytes): "
            "gather-everything reintroduced")


# the reference's table (scripts/collective_bench.py:62-77)
_TITLE = re.compile(r"^# engine=(python|native) iters=5 "
                    r"\(goodput = payload bytes/sec, rank 0\)$")
_HEADER = "size_kb " + f"np={2:<12d}"
_ROW = re.compile(r"^      4 +\d+\.\d MB/s$")


@pytest.mark.parametrize("engine", ENGINES)
def test_collective_cli_prints_the_goodput_table(engine, cli_runs):
    """``python -m horovod_tpu_torch.bench.collective --device cpu --np 2
    --sizes-kb 4 --iters 5`` prints the reference's table for each
    engine."""
    proc = cli_runs[engine]
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-3000:]
    lines = [ln for ln in stdout.splitlines()
             if not ln.startswith("[")]  # the workers' tagged lines
    assert _TITLE.match(lines[-3]) and lines[-3].split()[1] == \
        f"engine={engine}", lines
    assert lines[-2] == _HEADER, lines
    assert _ROW.match(lines[-1]), lines


def test_collective_cli_runs_on_the_card_unless_asked(capsys):
    """The microbench's payloads are on the card by default; with no card
    visible it refuses (exit 2) and runs no world, rather than measuring
    host payloads under a card's name."""
    import torch

    assert collective._parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        assert collective.main(["--np", "2", "--sizes-kb", "4"]) == 2
        out = capsys.readouterr()
        assert out.out == "" and "no CUDA device is visible" in out.err
