"""The port's regression gate (``horovod_tpu_torch/bench/gate.py``) held
against the reference's (``scripts/perf_gate.py``): the nine cases of
``tests/test_perf_gate.py``, each run through both on the same record
dir, must give the same exit code, the same stdout and stderr apart from
the provenance token (``JAX_PLATFORMS=`` in the reference,
``CUDA_VISIBLE_DEVICES=`` in the port: each prints its own package's
key) and the same ``--json`` verdict document.  Then the port's own
cases: the record dir's resolution from the environment, and the gate
agreeing with the bench's in-record sentinel."""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import re
import runpy
import warnings

import pytest

from horovod_tpu_torch.bench import attach_regression, gate, supervisor

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "reference_perf_gate", os.path.join(REPO_ROOT, "scripts", "perf_gate.py"))
perf_gate = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(perf_gate)

METRIC = "resnet50_images_per_sec_per_chip"
# the provenance token each package prints of its own stamp
_PROV_TOKEN = re.compile(r" (JAX_PLATFORMS|CUDA_VISIBLE_DEVICES)=\S*?"
                         r"(?=[\])])")


def _run(mod, argv, capsys):
    rc = mod.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _verdict(out):
    return json.loads(out[out.index("\n{") + 1:]) if "\n{" in out else None


def _both(argv, capsys):
    """The reference's and the port's (rc, stdout, stderr) on ``argv``,
    after checking that they agree: the same exit code, the same lines
    but for the provenance token, the same verdict document."""
    ref = _run(perf_gate, argv, capsys)
    port = _run(gate, argv, capsys)
    assert port[0] == ref[0]
    assert _PROV_TOKEN.sub("", port[1]) == _PROV_TOKEN.sub("", ref[1])
    assert port[2] == ref[2]
    assert _verdict(port[1]) == _verdict(ref[1])
    return ref, port


@pytest.fixture()
def real_baseline_dir(tmp_path):
    """One real baseline (value 1000) and one degraded record that must
    never become a bar; the degraded one carries both packages'
    provenance keys."""
    (tmp_path / "BENCH_r01.json").write_text(json.dumps({
        "n": 1, "rc": 0,
        "parsed": {"metric": METRIC, "value": 1000.0,
                   "device": "TPU v5 lite"},
    }))
    (tmp_path / "BENCH_r02.json").write_text(json.dumps({
        "n": 2, "rc": 0, "degraded": True, "failure_phase": "cpu",
        "parsed": {"metric": METRIC, "value": 9999.0,
                   "device": "TPU v5 lite", "degraded": True},
        "provenance": {"platform": "cpu", "device_kind": "cpu",
                       "jax_platforms": "cpu",
                       "cuda_visible_devices": "cpu"},
    }))
    return tmp_path


def _candidate(tmp_path, **doc):
    path = tmp_path / "fresh.json"
    path.write_text(json.dumps(doc))
    return str(path)


def test_committed_trajectory_partition_and_exit_zero(capsys):
    """The repository's own records (the reference's TPU trajectory,
    named explicitly: the port never defaults to them): r01-r02 real,
    r06-r12 degraded, the dark rounds failed, exit 0 in both."""
    assert len(glob.glob(os.path.join(REPO_ROOT, "BENCH_r*.json"))) == 12
    _, (rc, out, _) = _both(["--records-dir", REPO_ROOT, "--json"], capsys)
    assert rc == 0
    verdict = _verdict(out)
    assert verdict["real"] == ["BENCH_r01.json", "BENCH_r02.json"]
    assert verdict["degraded"] == [f"BENCH_r{n:02d}.json"
                                   for n in range(6, 13)]
    assert verdict["failed"] == [f"BENCH_r{n:02d}.json" for n in (3, 4, 5)]
    assert "# baselines" in out


def test_degraded_record_never_becomes_baseline(real_baseline_dir):
    got = [mod.baselines(mod.load_records(str(real_baseline_dir)))
           for mod in (perf_gate, gate)]
    assert got[0] == got[1]
    assert got[1][(METRIC, "TPU v5 lite")][1]["value"] == 1000.0


def test_regressing_candidate_fails_the_gate(real_baseline_dir, tmp_path,
                                             capsys):
    cand = _candidate(tmp_path, metric=METRIC, value=800.0,
                      device="TPU v5 lite",
                      provenance={"platform": "tpu",
                                  "device_kind": "TPU v5 lite",
                                  "jax_platforms": "",
                                  "cuda_visible_devices": ""})
    _, (rc, out, _) = _both(["--records-dir", str(real_baseline_dir),
                             "--candidate", cand, "--json"], capsys)
    assert rc == 1
    assert "REGRESSION" in out
    verdict = _verdict(out)
    assert verdict["regression"] is True
    assert verdict["candidate"]["pct"] == pytest.approx(-20.0)


def test_in_band_candidate_passes(real_baseline_dir, tmp_path, capsys):
    cand = _candidate(tmp_path, metric=METRIC, value=980.0,
                      device="TPU v5 lite")
    _, (rc, out, _) = _both(["--records-dir", str(real_baseline_dir),
                             "--candidate", cand], capsys)
    assert rc == 0
    assert "OK" in out


def test_degraded_candidate_is_announced_not_judged(real_baseline_dir,
                                                    tmp_path, capsys):
    cand = _candidate(tmp_path, metric=METRIC, value=1.0, device=None,
                      degraded=True)
    _, (rc, out, _) = _both(["--records-dir", str(real_baseline_dir),
                             "--candidate", cand], capsys)
    assert rc == 0
    assert "DEGRADED" in out
    assert "REGRESSION" not in out


def test_candidate_without_baseline_scenario_passes(real_baseline_dir,
                                                    tmp_path, capsys):
    cand = _candidate(tmp_path, metric="brand_new_metric", value=5.0,
                      device="cpu")
    _, (rc, out, _) = _both(["--records-dir", str(real_baseline_dir),
                             "--candidate", cand], capsys)
    assert rc == 0
    assert "no real baseline" in out


def test_corrupt_record_skipped_loudly(real_baseline_dir, capsys):
    (real_baseline_dir / "BENCH_r03.json").write_text("{not json")
    _, (rc, _, err) = _both(["--records-dir", str(real_baseline_dir)],
                            capsys)
    assert rc == 0
    assert "unreadable record BENCH_r03.json" in err


def test_empty_records_dir_is_bad_input(tmp_path, capsys):
    _, (rc, _, err) = _both(["--records-dir", str(tmp_path)], capsys)
    assert rc == 2
    assert "no BENCH_*.json" in err


def test_provenance_printed_beside_verdict(real_baseline_dir, tmp_path,
                                           capsys):
    cand = _candidate(tmp_path, metric=METRIC, value=980.0,
                      device="TPU v5 lite",
                      provenance={"platform": "cpu", "device_kind": "cpu",
                                  "jax_platforms": "cpu",
                                  "cuda_visible_devices": "0"})
    (_, ref, _), (_, out, _) = _both(
        ["--records-dir", str(real_baseline_dir), "--candidate", cand],
        capsys)
    assert "JAX_PLATFORMS=cpu" in ref
    assert "platform=cpu" in out
    assert "CUDA_VISIBLE_DEVICES=0" in out
    assert "JAX_PLATFORMS" not in out


# ------------------------------------------------------- the port's own


def test_no_record_dir_is_bad_input_and_reads_nothing(monkeypatch, capsys):
    for name in ("HVDTPU_BENCH_RECORD_DIR", "HVDTPU_RECORD_DIR"):
        monkeypatch.delenv(name, raising=False)

    def refuse(*_):
        raise AssertionError("the gate read a record dir nobody named")

    monkeypatch.setattr(gate, "load_records", refuse)
    rc, out, err = _run(gate, [], capsys)
    assert rc == 2 and out == ""
    assert "HVDTPU_BENCH_RECORD_DIR" in err and "HVDTPU_RECORD_DIR" in err


def test_provenance_of_the_ports_own_record(tmp_path, monkeypatch,
                                            capsys):
    """A degraded record from the port's writer carries
    ``cuda_visible_devices`` and no JAX key: the port prints it, the
    reference has nothing to print."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    supervisor.write_degraded_record("planted", rc=86, phase="build",
                                     record_dir=str(tmp_path))
    argv = ["--records-dir", str(tmp_path)]
    _, ref, _ = _run(perf_gate, argv, capsys)
    rc, out, _ = _run(gate, argv, capsys)
    assert rc == 0
    assert "  degraded  BENCH_r01.json: build [CUDA_VISIBLE_DEVICES=3]" in out
    assert "  degraded  BENCH_r01.json: build [provenance unknown]" in ref


def test_bench_record_dir_wins_over_record_dir(real_baseline_dir, tmp_path,
                                               monkeypatch, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("HVDTPU_RECORD_DIR", str(empty))
    monkeypatch.setenv("HVDTPU_BENCH_RECORD_DIR", str(real_baseline_dir))
    rc, out, _ = _run(gate, ["--json"], capsys)
    assert rc == 0
    assert _verdict(out)["real"] == ["BENCH_r01.json"]
    monkeypatch.delenv("HVDTPU_BENCH_RECORD_DIR")
    rc, _, err = _run(gate, [], capsys)
    assert rc == 2 and str(empty) in err


def test_module_entry_runs_the_gate(real_baseline_dir, monkeypatch, capsys):
    """``python -m horovod_tpu_torch.bench.gate`` is :func:`gate.main`."""
    monkeypatch.setattr("sys.argv", ["gate", "--records-dir",
                                     str(real_baseline_dir)])
    with warnings.catch_warnings():
        # the module is imported already; running it as __main__ warns
        warnings.simplefilter("ignore", RuntimeWarning)
        with pytest.raises(SystemExit) as exc:
            runpy.run_module("horovod_tpu_torch.bench.gate",
                             run_name="__main__")
    assert exc.value.code == 0
    assert "1 real, 1 degraded, 0 failed" in capsys.readouterr().out


CARD = "NVIDIA H100 80GB HBM3"
TOKENS = "gpt_small_tokens_per_sec_per_gpu"


@pytest.mark.parametrize("value,degraded,regression", [
    (50_000.0, False, True),     # far below the EWMA
    (158_000.0, False, False),   # inside the band
    (1.0, True, False),          # a CPU run, stamped degraded
], ids=["regression", "in_band", "degraded"])
def test_gate_and_sentinel_agree(tmp_path, capsys, value, degraded,
                                 regression):
    """On one record dir and one candidate, the gate and the bench's
    sentinel (``attach_regression``) give the same EWMA, fold the same
    records and raise the same flag."""
    for n, v in ((1, 160_000.0), (2, 150_000.0), (3, 158_000.0)):
        (tmp_path / f"BENCH_r{n:02d}.json").write_text(json.dumps({
            "n": n, "rc": 0,
            "parsed": {"metric": TOKENS, "value": v, "device": CARD}}))
    (tmp_path / "BENCH_r04.json").write_text(json.dumps({
        "n": 4, "rc": 86, "degraded": True, "failure_phase": "build",
        "parsed": None}))
    cand = {"metric": TOKENS, "value": value, "device": CARD}
    if degraded:
        cand.update(device="cpu", degraded=True)
    path = _candidate(tmp_path, **cand)
    rc, out, _ = _run(gate, ["--records-dir", str(tmp_path), "--candidate",
                             path, "--json"], capsys)
    verdict = _verdict(out)
    # the best real value is the audit's bar; the EWMA judges
    assert f"  {TOKENS} on {CARD}: 160000.0 (BENCH_r01.json)\n" in out
    sentinel = attach_regression(dict(cand), str(tmp_path))
    assert verdict["regression"] is regression
    assert (rc == 1) is regression
    assert bool(sentinel["regression"]) is regression
    if degraded:
        assert sentinel["regression"] is None
        assert verdict["candidate"] == {"scenario": [TOKENS, "cpu"],
                                        "degraded": True}
        return
    judged = verdict["candidate"]
    assert sentinel["deltas"]["value"]["baseline"] == judged["baseline"]
    assert sentinel["deltas"]["value"]["pct"] == judged["pct"]
    assert sentinel["baseline_record"]["baseline_records"] == \
        judged["baseline_records"] == ["BENCH_r01.json", "BENCH_r02.json",
                                       "BENCH_r03.json"]
    assert sentinel["baseline_record"]["file"] == judged["baseline_record"]
