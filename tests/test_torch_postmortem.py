"""The port's flight recorder and post-mortem (``obs/flightrec.py``,
``obs/postmortem.py``) against the JAX package's.

* ring dumps both ways: the port's recorder and the reference's record the
  same life of two ranks (a fault, an OOM black box, a divergence, a
  death by signal; the same clock), and each package's ``postmortem``
  reads either dump set to the same report and verdict;
* the flush thread: a rank whose main thread is blocked in C (here in
  ``signal.sigwait``, where no Python signal handler runs) still writes
  its ring on SIGUSR1, and keeps running;
* one launcher run: a 2-rank gloo job with ``enqueue:rank=1:step=4:
  action=abort`` exits non-zero and its ``postmortem.json`` blames rank 1
  with its last collective.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

import horovod_tpu.obs.flightrec as jflightrec
import horovod_tpu.obs.postmortem as jpostmortem
from horovod_tpu_torch.obs import flightrec, postmortem

REPO = Path(__file__).resolve().parent.parent


class _Clock:
    def __init__(self, t: float):
        self.t = t

    def __call__(self) -> float:
        self.t += 0.001
        return self.t


def _life(mod, rank: int) -> None:
    """One rank's ring: collectives, then rank 1 dies allocating."""
    rec = mod.FlightRecorder(capacity=64)
    rec.record("init", name=f"rank{rank}", detail="world=2")
    rec.record("rendezvous", name="epoch", cycle=0)
    for i in range(4):
        rec.record("enqueue", name=f"t{i}", cycle=i, detail="ALLREDUCE")
        if rank == 0 or i < 3:
            rec.record("complete", name=f"t{i}", cycle=i)
    rec.record("health.divergence", name="bucket2", cycle=3,
               detail="step=3 minority=1 component=bucket2 bucket=2 "
                      "leaf=blocks.0.mlp.weight")
    if rank == 1:
        rec.record("fault", name="mem_alloc", detail="oom:mem_alloc:rank=1")
        rec.record("mem.oom", name="decode_step",
                   detail="where=decode_step owner=kv_cache share=0.82 "
                          "owner_bytes=820 total_bytes=1000")
        try:
            raise RuntimeError("RESOURCE_EXHAUSTED: out of memory")
        except RuntimeError as exc:
            rec.record_exception(exc, where="decode_step")
        rec.record("signal", name="SIGABRT")
    return rec


def _dumps(mod, tmp_path, tag, monkeypatch):
    d = tmp_path / tag
    d.mkdir()
    monkeypatch.setattr(time, "time", _Clock(1000.0))
    for rank, trigger in ((1, "signal:SIGABRT"), (0, "signal:SIGTERM")):
        rec = _life(mod, rank)
        monkeypatch.setenv("HVDTPU_ELASTIC_EPOCH", "0")
        rec.dump(str(d / f"flightrec.rank.{rank}.json"), rank=str(rank),
                 trigger=trigger)
    monkeypatch.undo()
    return str(d)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_ring_dumps_read_the_same_both_ways(tmp_path, monkeypatch, writer):
    d = _dumps(flightrec if writer == "port" else jflightrec, tmp_path,
               writer, monkeypatch)
    mine = postmortem.analyze(postmortem.load_dumps(d), expected_ranks=2)
    ref = jpostmortem.analyze(jpostmortem.load_dumps(d), expected_ranks=2)

    def stable(report):
        return json.loads(json.dumps(report, default=str))

    assert stable(mine) == stable(ref)
    verdict = postmortem.verdict(mine)
    assert verdict == jpostmortem.verdict(ref)
    assert "rank 1" in verdict and "OUT OF DEVICE MEMORY" in verdict


def test_the_two_recorders_write_the_same_dump(tmp_path, monkeypatch):
    docs = []
    for mod in (flightrec, jflightrec):
        monkeypatch.setattr(time, "time", _Clock(1000.0))
        rec = _life(mod, 1)
        doc = rec.dump(str(tmp_path / f"{mod.__name__}.json"), rank="1",
                       trigger="signal:SIGABRT")
        monkeypatch.undo()
        doc.pop("pid"), doc.pop("wall_time")
        doc["last_exception"].pop("traceback")
        docs.append(doc)
    assert docs[0] == docs[1]


VICTIM = textwrap.dedent("""
    import signal, sys
    sys.path.insert(0, {repo!r})
    from horovod_tpu_torch.obs import flightrec
    flightrec.install_death_hooks()
    flightrec.record("enqueue", name="t0", cycle=0)
    signal.pthread_sigmask(signal.SIG_BLOCK, {{signal.SIGUSR2}})
    print("ready", flush=True)
    signal.sigwait({{signal.SIGUSR2}})   # blocked in C: no handler runs
    print("released", flush=True)
""")


def test_sigusr1_dumps_while_the_main_thread_is_blocked(tmp_path):
    env = dict(os.environ, HVDTPU_FLIGHTREC_DUMP=str(tmp_path) + os.sep,
               HVDTPU_RANK="0")
    p = subprocess.Popen([sys.executable, "-c",
                          VICTIM.format(repo=str(REPO))],
                         stdout=subprocess.PIPE, text=True, env=env)
    try:
        assert p.stdout.readline().strip() == "ready"
        p.send_signal(signal.SIGUSR1)
        dump = tmp_path / "flightrec.rank.0.json"
        deadline = time.time() + 20
        while not dump.exists() and time.time() < deadline:
            time.sleep(0.05)
        assert dump.exists()
        assert p.poll() is None           # dump-only: still running
        doc = json.loads(dump.read_text())
        assert doc["trigger"] == "signal:SIGUSR1"
        assert [e["name"] for e in doc["events"]][:1] == ["t0"]
        p.send_signal(signal.SIGUSR2)
        assert p.wait(timeout=20) == 0
        assert p.stdout.read().strip() == "released"
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()


WORKER = textwrap.dedent("""
    import torch
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    for i in range(8):
        hvd.synchronize(hvd.allreduce_async(torch.ones(4), name=f"t{i}"))
    hvd.shutdown()
""")


def test_abort_on_rank1_yields_a_blaming_postmortem(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    box = tmp_path / "bb"
    box.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO), HVDTPU_CYCLE_TIME="2",
               HVDTPU_FAULT_SPEC="enqueue:rank=1:step=4:action=abort")
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         "--flightrec-dump", str(box), sys.executable, str(script)],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=str(tmp_path))
    assert out.returncode != 0
    assert "== post-mortem ==" in out.stdout
    report = json.loads((box / "postmortem.json").read_text())
    assert report["first_failure"]["rank"] == 1
    assert "Rank 1 failed first" in report["verdict"]
    assert "'t2'" in report["verdict"]
    dumps = sorted(p.name for p in box.glob("flightrec.rank.*.json"))
    assert dumps == ["flightrec.rank.0.json", "flightrec.rank.1.json"]
