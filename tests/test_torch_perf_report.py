"""The port's trajectory report (``horovod_tpu_torch/bench/report.py``)
held against the reference's (``scripts/perf_report.py``), which has no
test of its own: on the committed trajectory, on the gate's fixtures and
on a campaign journal written by the port's ``bench/campaign.py`` (a
scripted runner, no bench process), both must give the same exit code,
the same stdout and stderr, the same ``--json`` document, and the same
``--write-docs`` section apart from its banner (each names its own
command)."""

from __future__ import annotations

import importlib.util
import json
import os
import runpy
import warnings

import pytest

from horovod_tpu_torch.bench import campaign, report, supervisor

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "reference_perf_report",
    os.path.join(REPO_ROOT, "scripts", "perf_report.py"))
perf_report = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(perf_report)

CARD = "NVIDIA H100 80GB HBM3"
TOKENS = "gpt_small_tokens_per_sec_per_gpu"
DOCS = ("# Notes\n\nbefore\n\n" + report.DOCS_BEGIN + "\nstale\n"
        + report.DOCS_END + "\n\nafter\n")


def _run(mod, argv, capsys):
    rc = mod.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(argv, capsys):
    """The port's (rc, stdout, stderr) on ``argv`` after checking that
    the reference's are the same."""
    ref = _run(perf_report, argv, capsys)
    port = _run(report, argv, capsys)
    assert port == ref
    return port


def _json_doc(out):
    return json.loads(out[out.index("\n{") + 1:])


def _gate_fixture(d, corrupt=False):
    """The gate's fixture (one real record, one degraded), and with
    ``corrupt`` an unreadable third record."""
    (d / "BENCH_r01.json").write_text(json.dumps({
        "n": 1, "rc": 0, "parsed": {
            "metric": "resnet50_images_per_sec_per_chip", "value": 1000.0,
            "device": "TPU v5 lite", "mfu": 0.41}}))
    (d / "BENCH_r02.json").write_text(json.dumps({
        "n": 2, "rc": 0, "degraded": True, "failure_phase": "cpu",
        "parsed": {"metric": "resnet50_images_per_sec_per_chip",
                   "value": 9999.0, "device": "TPU v5 lite",
                   "degraded": True}}))
    if corrupt:
        (d / "BENCH_r03.json").write_text("{not json")
    return d


def _campaign_fixture(d):
    """A two-point gpt-small campaign journal from the port's campaign.py with
    a scripted runner, the points' records landed as harness records in
    the journal's order, and one degraded record of the port's writer."""
    spec = {"name": "gpt_small_overlap", "retry_degraded": 0,
            "point_budget_secs": 600,
            "base_args": ["--model", "gpt-small", "--dtype", "bf16"],
            "axes": {"overlap": ["off", "bucket"], "grad_bucket_mb": [16]}}
    values = iter((161_234.5, 158_300.25))

    def runner(point, spec):
        return {"rc": 0, "tail": "", "parsed": {
            "metric": TOKENS, "value": next(values), "device": CARD,
            "mfu": 0.31, "overlap_mode": point["id"]}}

    journal = campaign.run_campaign(spec, str(d), runner=runner,
                                    log=lambda m: None)
    for k, pid in enumerate(journal["order"], start=1):
        (d / f"BENCH_r{k:02d}.json").write_text(json.dumps(
            {"n": k, "rc": 0, "parsed": journal["points"][pid]["record"]}))
    supervisor.write_degraded_record("planted", rc=86, phase="build",
                                     record_dir=str(d))
    return journal


def test_committed_trajectory_renders_alike(capsys):
    rc, out, _ = _both(["--records-dir", REPO_ROOT, "--json"], capsys)
    assert rc == 0
    assert "# partition: 2 real, 7 degraded, 3 failed" in out
    assert "# MULTICHIP rounds: 5" in out
    assert _json_doc(out)["partition"] == {"real": 2, "degraded": 7,
                                           "failed": 3}


@pytest.mark.parametrize("corrupt", [False, True],
                         ids=["gate_fixture", "corrupt_record"])
def test_gate_fixtures_render_alike(tmp_path, capsys, corrupt):
    rc, out, _ = _both(["--records-dir", str(_gate_fixture(tmp_path,
                                                           corrupt)),
                        "--json"], capsys)
    assert rc == 0
    assert "# partition: 1 real, 1 degraded, 0 failed" in out
    assert "# EWMA baseline resnet50_images_per_sec_per_chip on TPU v5 " \
        "lite: 1000.0 over BENCH_r01.json" in out


def test_campaign_journal_renders_alike(tmp_path, capsys):
    journal = _campaign_fixture(tmp_path)
    rc, out, _ = _both(["--records-dir", str(tmp_path), "--json"], capsys)
    assert rc == 0
    assert "# partition: 2 real, 1 degraded, 0 failed" in out
    lines = out.splitlines()
    for pid, value in zip(journal["order"], (161_234.5, 158_300.25)):
        assert (f"  done      {pid}: attempts=1 compile=cold "
                f"value={value}") in lines
    doc = _json_doc(out)
    assert doc["campaign"] == campaign.summarize_journal(journal)
    assert doc["campaign"]["done"] == 2
    assert doc["degraded_streak"]["last_real_record"] == "BENCH_r02.json"


def test_write_docs_renders_the_same_section(tmp_path, capsys):
    (tmp_path / "records").mkdir()
    _campaign_fixture(tmp_path / "records")
    records = str(tmp_path / "records")
    docs = {}
    for mod in (perf_report, report):
        path = tmp_path / f"{mod.__name__}.md"
        path.write_text(DOCS)
        rc, out, _ = _run(mod, ["--records-dir", records, "--write-docs",
                                str(path)], capsys)
        assert rc == 0 and f"# docs: {path} updated" in out
        rc, out, _ = _run(mod, ["--records-dir", records, "--write-docs",
                                str(path)], capsys)
        assert rc == 0 and f"# docs: {path} already current" in out
        docs[mod] = path.read_text().splitlines()
    banner = [i for i, line in enumerate(docs[report])
              if line.startswith("<!-- generated by")]
    assert banner == [5]
    assert "python -m horovod_tpu_torch.bench.report" in docs[report][5]
    assert "scripts/perf_report.py" in docs[perf_report][5]
    del docs[report][5], docs[perf_report][5]
    assert docs[report] == docs[perf_report]
    text = "\n".join(docs[report])
    assert text.startswith("# Notes\n\nbefore\n\n" + report.DOCS_BEGIN)
    assert text.endswith(report.DOCS_END + "\n\nafter")
    assert "stale" not in text and "| 3 | BENCH_r03.json | degraded |" in text


def test_missing_markers_is_bad_input(tmp_path, capsys):
    _gate_fixture(tmp_path)
    path = tmp_path / "plain.md"
    path.write_text("# no markers\n")
    rc, _, err = _both(["--records-dir", str(tmp_path), "--write-docs",
                        str(path)], capsys)
    assert rc == 2 and "markers" in err
    assert path.read_text() == "# no markers\n"


def test_absent_named_campaign_is_bad_input(tmp_path, capsys):
    _gate_fixture(tmp_path)
    missing = str(tmp_path / "nowhere.json")
    rc, _, err = _both(["--records-dir", str(tmp_path), "--campaign",
                        missing], capsys)
    assert rc == 2 and f"campaign journal {missing} not found" in err


def test_empty_dir_is_bad_input(tmp_path, capsys):
    rc, _, err = _both(["--records-dir", str(tmp_path)], capsys)
    assert rc == 2 and "no BENCH_*/MULTICHIP_*.json records" in err


# ------------------------------------------------------- the port's own


def test_no_record_dir_reads_and_writes_nothing(tmp_path, monkeypatch,
                                                capsys):
    for name in ("HVDTPU_BENCH_RECORD_DIR", "HVDTPU_RECORD_DIR"):
        monkeypatch.delenv(name, raising=False)

    def refuse(*_):
        raise AssertionError("the report read a record dir nobody named")

    monkeypatch.setattr(report.trend, "load_bench_records", refuse)
    monkeypatch.setattr(report.trend, "load_multichip_records", refuse)
    path = tmp_path / "notes.md"
    path.write_text(DOCS)
    rc, out, err = _run(report, ["--write-docs", str(path)], capsys)
    assert rc == 2 and out == ""
    assert "HVDTPU_BENCH_RECORD_DIR" in err and "HVDTPU_RECORD_DIR" in err
    assert path.read_text() == DOCS


def test_write_docs_needs_a_path(tmp_path, capsys):
    """The reference's bare ``--write-docs`` rewrites its
    docs/performance.md; the port's takes only a named file."""
    with pytest.raises(SystemExit) as exc:
        report.main(["--records-dir", str(tmp_path), "--write-docs"])
    assert exc.value.code == 2
    assert "--write-docs" in capsys.readouterr().err


def test_module_entry_runs_the_report(tmp_path, monkeypatch, capsys):
    """``python -m horovod_tpu_torch.bench.report`` is :func:`report.main`,
    with the record dir from the environment."""
    monkeypatch.setenv("HVDTPU_BENCH_RECORD_DIR",
                       str(_gate_fixture(tmp_path)))
    monkeypatch.setattr("sys.argv", ["report"])
    with warnings.catch_warnings():
        # the module is imported already; running it as __main__ warns
        warnings.simplefilter("ignore", RuntimeWarning)
        with pytest.raises(SystemExit) as exc:
            runpy.run_module("horovod_tpu_torch.bench.report",
                             run_name="__main__")
    assert exc.value.code == 0
    assert "# partition: 1 real, 1 degraded, 0 failed" in \
        capsys.readouterr().out

