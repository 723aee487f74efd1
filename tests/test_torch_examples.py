"""The reference's 13 examples as the port's ``horovod_tpu_torch.examples``:
every one runs its smoke on the CPU, at world 1 in this process with
``--cpu`` and its smallest flags, and ``mnist`` and ``bert_style`` also at
world 2 through ``python -m horovod_tpu_torch.run -np 2`` (started first,
in the background, and read last).  Each run must finish (``main``
returns 0, the launcher exits 0) and print its closing JSON line; where
the example trains, its loss must fall.  ``tf2_mnist`` trains on random
labels, as the reference's does, so its loss is only held finite.
``keras_mnist`` and ``tf2_mnist`` skip without TensorFlow.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from horovod_tpu_torch.examples import NAMES

REPO = Path(__file__).resolve().parent.parent
LAUNCHED = {"mnist": ("--smoke",), "bert_style": ("--smoke",)}
LAUNCH_TIMEOUT = 240


def _records(text: str) -> list:
    out = []
    for line in text.splitlines():
        start = line.find('{"example"')
        if start >= 0:
            out.append(json.loads(line[start:]))
    return out


def _fell(losses) -> bool:
    """The mean of the last quarter of the losses is below the first."""
    k = max(len(losses) // 4, 1)
    return all(map(math.isfinite, losses)) and \
        sum(losses[-k:]) / k < losses[0]


@pytest.fixture(scope="module", autouse=True)
def launched():
    """The world-2 runs, started before the in-process ones (two intra-op
    threads a rank, as ``_torch_world.bench_env`` says why)."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
         sys.executable, "-m", f"horovod_tpu_torch.examples.{name}",
         "--cpu", *flags],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(REPO)) for name, flags in LAUNCHED.items()}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _run(capsys, name: str, *argv) -> dict:
    mod = importlib.import_module(f"horovod_tpu_torch.examples.{name}")
    capsys.readouterr()
    assert mod.main(["--cpu", *argv]) == 0
    recs = _records(capsys.readouterr().out)
    assert recs and recs[-1]["example"] == name, recs
    return recs[-1]


def test_every_reference_example_has_a_port():
    ref = sorted(p.stem for p in (REPO / "examples").glob("*.py"))
    assert sorted(NAMES) == ref
    for name in NAMES:
        assert callable(importlib.import_module(
            f"horovod_tpu_torch.examples.{name}").main)


def test_mnist(capsys):
    rec = _run(capsys, "mnist", "--smoke")
    assert rec["world"] == 1 and _fell(rec["losses"])


def test_synthetic_benchmark(capsys):
    rec = _run(capsys, "synthetic_benchmark", "--model", "resnet18",
               "--batch-size", "1", "--num-warmup-batches", "1",
               "--num-batches-per-iter", "1", "--num-iters", "1")
    assert rec["images_per_sec"] > 0 and _fell(rec["losses"])


def test_bert_style(capsys):
    assert _fell(_run(capsys, "bert_style", "--smoke")["losses"])


def test_long_context_zigzag(capsys):
    assert _fell(_run(capsys, "long_context_zigzag", "--smoke")["losses"])


def test_checkpoint_resume_resumes(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("CKPT_DIR", str(tmp_path / "ckpt"))
    first = _run(capsys, "checkpoint_resume")
    assert first["start_step"] == 0 and first["saved"] == 40
    assert _fell(first["losses"])
    second = _run(capsys, "checkpoint_resume")
    assert second["start_step"] == 40 and second["saved"] == 80


def test_adasum_small_model(capsys):
    rec = _run(capsys, "adasum_small_model", "--steps", "50")
    assert _fell(rec["losses"]) and math.isfinite(rec["final_loss"])


def test_torch_mnist(capsys):
    rec = _run(capsys, "torch_mnist", "--samples", "512")
    assert rec["losses"][-1] < rec["losses"][0]


def test_pipeline_train(capsys):
    assert _fell(_run(capsys, "pipeline_train", "--smoke")["losses"])


def test_estimator_train(capsys, tmp_path):
    rec = _run(capsys, "estimator_train", "--epochs", "2", "--samples",
               "256", "--store-dir", str(tmp_path / "store"))
    losses = [h["loss"] for h in rec["history"]]
    assert losses[-1] < losses[0] and rec["accuracy"] > 0.9


def test_cluster_run(capsys):
    # rank r's vector is r + 1 + step: 8 x (1.5 + step) summed over 5 steps
    rec = _run(capsys, "cluster_run", "--steps", "5")
    assert rec["metrics"] == [140.0, 140.0]


def test_elastic_train(capsys):
    # w -= 0.01 x the mean over 2 ranks of (step + 1)(rank + 1), 3 steps
    rec = _run(capsys, "elastic_train", "--np", "2", "--steps", "3")
    assert rec["w0"] == [pytest.approx(-0.09)]
    assert not rec["respawned"]


def test_keras_mnist(capsys):
    pytest.importorskip("tensorflow")
    assert _fell(_run(capsys, "keras_mnist", "--epochs", "2")["losses"])


def test_tf2_mnist(capsys):
    pytest.importorskip("tensorflow")
    rec = _run(capsys, "tf2_mnist", "--steps", "4")
    assert all(map(math.isfinite, rec["losses"] + [rec["final_loss"]]))


@pytest.mark.parametrize("name", sorted(LAUNCHED))
def test_world_of_two_through_the_launcher(launched, name):
    out, err = launched[name].communicate(timeout=LAUNCH_TIMEOUT)
    assert launched[name].returncode == 0, err[-3000:]
    recs = _records(out)
    assert len(recs) == 1 and recs[0]["world"] == 2, out[-3000:]
    assert _fell(recs[0]["losses"])
