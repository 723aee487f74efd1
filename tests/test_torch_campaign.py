"""The port's campaign driver (``horovod_tpu_torch/bench/campaign.py``) held
against the reference's (``horovod_tpu/bench/campaign.py``): the ten
campaign cases of ``tests/test_campaign.py:47-296``.

The spec, expansion and journal logic is host code copied with the port's
imports, so the expansions must be equal point for point, and the same
injected runner results must leave the same journals in both packages
(timestamps and per-point seconds aside).  The chaos case runs the port's
CLI with a stub bench, as the reference's test does; one more case runs a
real point, ``python -m horovod_tpu_torch.bench --cpu --model gpt-nano``,
through the default runner.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys

import pytest

from horovod_tpu.bench import campaign as jcampaign
from horovod_tpu.testing import faults as jfaults
from horovod_tpu_torch.bench import campaign
from horovod_tpu_torch.testing import faults

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = pytest.mark.parametrize("mod", [campaign, jcampaign],
                               ids=["port", "reference"])


def _grid_spec(**over):
    spec = {
        "name": "t",
        "base_args": ["--model", "resnet18"],
        "axes": {
            "overlap": ["off", "bucket"],
            "grad_bucket_mb": [2, 4],
            "hierarchical": [False, True],
        },
        "points": [],
        "retry_degraded": 1,
        "point_budget_secs": 60,
    }
    spec.update(over)
    return spec


def test_expand_grid_collapses_inert_bucket_axis():
    """overlap=off makes the bucket knob inert: the 2x2x2 grid yields
    (1 + 2) x 2 = 6 points, not 8, the same in both packages."""
    points = campaign.expand_points(_grid_spec())
    assert points == jcampaign.expand_points(_grid_spec())
    assert len(points) == 6
    off = [p for p in points if p["knobs"].get("overlap") == "off"]
    assert len(off) == 2
    assert all("grad_bucket_mb" not in p["knobs"] for p in off)
    # the bucket axis is the port bench's own flag
    assert any(p["argv"][-2:] == ["--overlap", "bucket"]
               and "--grad-bucket-mb" in p["argv"] for p in points)


def test_compile_key_classification():
    """Runtime env toggles (hierarchical/replay) share a configuration; a
    bucket-size change does not."""
    spec = _grid_spec(axes={
        "overlap": ["bucket"],
        "grad_bucket_mb": [2, 4],
        "hierarchical": [False, True],
    })
    points = campaign.expand_points(spec)
    assert points == jcampaign.expand_points(spec)
    by_knobs = {tuple(sorted(p["knobs"].items())): p for p in points}
    k = by_knobs[(("grad_bucket_mb", "2"), ("hierarchical", "0"),
                  ("overlap", "bucket"))]["compile_key"]
    same = by_knobs[(("grad_bucket_mb", "2"), ("hierarchical", "1"),
                     ("overlap", "bucket"))]["compile_key"]
    other_bucket = by_knobs[(("grad_bucket_mb", "4"), ("hierarchical", "0"),
                             ("overlap", "bucket"))]["compile_key"]
    assert k == same
    assert k != other_bucket
    assert all("--hierarchical" not in " ".join(p["argv"]) for p in points)
    assert any(p["env"].get("HVDTPU_HIERARCHICAL_ALLREDUCE") == "1"
               for p in points)


@PKGS
def test_axes_and_points_are_mutually_exclusive(tmp_path, mod):
    path = tmp_path / "spec.json"
    path.write_text(json.dumps({
        "name": "bad", "axes": {"overlap": ["off"]},
        "points": [{"name": "p", "args": []}],
    }))
    with pytest.raises(mod.CampaignError, match="both axes and points"):
        mod.load_spec(str(path))


def test_explicit_points_keep_order_and_reject_duplicates():
    spec = _grid_spec(axes={}, points=[
        {"name": "b", "args": ["--iters", "2"], "budget_secs": 120},
        {"name": "a", "args": ["--iters", "3"],
         "env": {"HVDTPU_SCHEDULE_REPLAY": "1"}},
    ])
    points = campaign.expand_points(spec)
    assert points == jcampaign.expand_points(spec)
    assert [p["id"] for p in points] == ["b", "a"]  # plan order
    assert points[0]["budget_secs"] == 120
    assert points[1]["env"] == {"HVDTPU_SCHEDULE_REPLAY": "1"}
    spec["points"].append({"name": "a", "args": []})
    for mod in (campaign, jcampaign):
        with pytest.raises(mod.CampaignError, match="duplicate"):
            mod.expand_points(spec)


# --------------------------------------------------------- resume/retry

def _runner_factory(results, calls):
    """Injected runner: pops the scripted result per point id, logging
    which points ran."""
    def runner(point, spec):
        calls.append(point["id"])
        return dict(results[point["id"]].pop(0))
    return runner


def _tiny_spec():
    return {
        "name": "resume", "base_args": [],
        "axes": {"hierarchical": [False, True]},
        "points": [], "retry_degraded": 1, "point_budget_secs": 60,
    }


OK = {"rc": 0, "parsed": {"metric": "m", "value": 1.0}, "tail": ""}
DEGRADED = {"rc": 0, "parsed": {"metric": "m", "degraded": True},
            "tail": ""}
FAILED = {"rc": 1, "parsed": None, "tail": "boom"}


def _comparable(journal: dict) -> dict:
    """A journal without its clocks (created/updated stamps, seconds)."""
    doc = json.loads(json.dumps(journal))
    doc.pop("created"), doc.pop("updated")
    for entry in doc["points"].values():
        entry.pop("elapsed_secs", None)
    return doc


def _both(tmp_path, sessions):
    """Run the same sessions of scripted results through both packages,
    each in its own record dir; returns [(calls, journal)] per session
    for the port, after checking the reference's match."""
    out = []
    dirs = {m: str(tmp_path / m.__name__.split(".")[0]) for m in
            (campaign, jcampaign)}
    for results, kw in sessions:
        got = {}
        for mod in (campaign, jcampaign):
            calls = []
            journal = mod.run_campaign(
                _tiny_spec(), dirs[mod],
                runner=_runner_factory(json.loads(json.dumps(results)),
                                       calls),
                log=lambda m: None, **kw)
            got[mod] = (calls, _comparable(journal))
        assert got[campaign] == got[jcampaign]
        out.append(got[campaign])
    return out


def test_resume_skips_done_and_retries_degraded_exactly_once(tmp_path):
    (calls1, j1), (calls2, j2), (calls3, j3) = _both(tmp_path, [
        ({"hierarchical=0": [OK], "hierarchical=1": [DEGRADED]}, {}),
        ({"hierarchical=1": [DEGRADED]}, {}),
        ({}, {}),
    ])
    assert calls1 == ["hierarchical=0", "hierarchical=1"]
    assert j1["points"]["hierarchical=0"]["status"] == "done"
    assert j1["points"]["hierarchical=1"]["status"] == "degraded"
    # second session: done point skipped, degraded point retried once,
    # against a configuration an earlier attempt already ran
    assert calls2 == ["hierarchical=1"]
    assert j2["points"]["hierarchical=1"]["attempts"] == 2
    assert j2["points"]["hierarchical=1"]["compile"] == "reused"
    # third session: retry budget (1 + retry_degraded) spent
    assert calls3 == []
    assert j3["points"]["hierarchical=1"]["status"] == "degraded"


def test_failed_point_keeps_tail_and_sets_exit_semantics(tmp_path):
    ((_, journal),) = _both(tmp_path, [
        ({"hierarchical=0": [OK], "hierarchical=1": [FAILED]}, {})])
    entry = journal["points"]["hierarchical=1"]
    assert entry["status"] == "failed"
    assert entry["tail"] == "boom"
    summary = campaign.summarize_journal(journal)
    assert summary == jcampaign.summarize_journal(journal)
    assert summary["done"] == 1 and summary["failed"] == 1


@PKGS
def test_changed_spec_is_refused_unless_force_new(tmp_path, mod):
    d = str(tmp_path)
    mod.run_campaign(_tiny_spec(), d, runner=lambda p, s: dict(OK),
                     log=lambda m: None)
    changed = _tiny_spec()
    changed["base_args"] = ["--model", "vgg16"]
    with pytest.raises(mod.CampaignError, match="different"):
        mod.run_campaign(changed, d, runner=lambda p, s: dict(OK),
                         log=lambda m: None)
    journal = mod.run_campaign(changed, d, runner=lambda p, s: dict(OK),
                               force_new=True, log=lambda m: None)
    assert journal["spec_sha"] == mod.spec_sha(changed) \
        == jcampaign.spec_sha(changed)


@PKGS
def test_corrupt_journal_is_refused(tmp_path, mod):
    (tmp_path / mod.JOURNAL_NAME).write_text("{ torn")
    with pytest.raises(mod.CampaignError, match="corrupt"):
        mod.load_journal(str(tmp_path))


@pytest.mark.parametrize("line,want", [
    ("noise\n{\"a\": 1}", {"a": 1}),
    ("Traceback ...\nValueError", None),
    ("[1, 2]", None),           # not an object
    ('{"v": NaN}', None),       # not strict
    ("", None),
])
def test_result_line_must_be_strict_json_object(line, want):
    assert campaign._parse_result_line(line) == want \
        == jcampaign._parse_result_line(line)


# ----------------------------------------------------------------- chaos

@pytest.fixture()
def fault_env(monkeypatch):
    faults.reset()
    jfaults.reset()
    yield monkeypatch
    monkeypatch.delenv(faults.SPEC_ENV, raising=False)
    faults.reset()
    jfaults.reset()


def test_injected_degrade_forces_point_without_running_it(
        tmp_path, fault_env):
    fault_env.setenv(faults.SPEC_ENV, "campaign_point:step=1:action=degrade")
    ((calls, journal),) = _both(tmp_path, [
        ({"hierarchical=1": [OK]}, {})])
    # point 1 journaled degraded without its runner; point 2 ran
    assert calls == ["hierarchical=1"]
    entry = journal["points"]["hierarchical=0"]
    assert entry["status"] == "degraded"
    assert entry["forced_degraded"] is True
    assert entry["record"]["degraded"] is True


def _write_stub_bench(tmp_path):
    """A bench stand-in: logs its argv to a count file and prints one
    strict-JSON record line."""
    stub = tmp_path / "stub_bench.py"
    stub.write_text(
        "import json, os, sys\n"
        "with open(os.environ['STUB_COUNT_FILE'], 'a') as f:\n"
        "    f.write(' '.join(sys.argv[1:]) + '\\n')\n"
        "print(json.dumps({'metric': 'stub_tokens_per_sec',\n"
        "                  'value': 123.0, 'device': 'cpu'}))\n"
    )
    return stub


def test_cli_abort_between_points_loses_only_inflight_point(tmp_path):
    """A seeded SIGABRT between point 1's journal commit and point 2's
    launch kills the campaign; the journal on disk is complete; the rerun
    (no fault) runs only point 2."""
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps({
        "name": "ci", "base_args": [],
        "points": [{"name": "p1", "args": ["--iters", "1"]},
                   {"name": "p2", "args": ["--iters", "2"]}],
    }))
    stub = _write_stub_bench(tmp_path)
    count_file = tmp_path / "count.txt"
    d = tmp_path / "records"
    cmd = [sys.executable, "-m", "horovod_tpu_torch.bench.campaign",
           "--spec", str(spec_path), "--record-dir", str(d),
           "--bench", f"{sys.executable} {stub}"]
    env = dict(os.environ, STUB_COUNT_FILE=str(count_file),
               HVDTPU_FAULT_SPEC="campaign_point:step=2:action=abort")
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          cwd=REPO_ROOT, timeout=120)
    assert proc.returncode in (-signal.SIGABRT, 128 + signal.SIGABRT), (
        proc.returncode, proc.stderr[-800:])
    journal = campaign.load_journal(str(d))
    assert journal["points"]["p1"]["status"] == "done"
    assert journal["points"]["p2"]["status"] == "pending"
    assert count_file.read_text().count("\n") == 1

    env.pop("HVDTPU_FAULT_SPEC")
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          cwd=REPO_ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr[-800:]
    journal = campaign.load_journal(str(d))
    assert journal["points"]["p1"]["attempts"] == 1  # not re-run
    assert journal["points"]["p2"]["status"] == "done"
    assert count_file.read_text().count("\n") == 2
    # the stub saw each point's own flags, and no budget flag of the
    # reference's bench
    assert count_file.read_text().splitlines() == ["--iters 1", "--iters 2"]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["done"] == 2 and summary["failed"] == 0


def test_real_point_runs_the_ports_bench(tmp_path, monkeypatch):
    """One short point through the default runner: ``python -m
    horovod_tpu_torch.bench --cpu --model gpt-nano`` lands its record,
    with its anatomy, in the journal; ``bench --campaign`` drives it."""
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps({
        "name": "real", "point_budget_secs": 120, "retry_degraded": 0,
        "base_args": ["--cpu", "--model", "gpt-nano", "--seq-len", "16",
                      "--batch-size", "2", "--iters", "1", "--warmup", "1"],
        "axes": {"overlap": ["off"]},
    }))
    monkeypatch.setenv("HVDTPU_RECORD_DIR", str(tmp_path))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setenv("PYTHONPATH", REPO_ROOT + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    from horovod_tpu_torch import bench

    assert bench.main(["--campaign", str(spec_path)]) == 0
    journal = campaign.load_journal(str(tmp_path))
    entry = journal["points"]["overlap=off"]
    assert entry["status"] == "done", entry
    record = entry["record"]
    assert record["metric"] == "gpt-nano_bf16_tokens_per_sec_per_gpu"
    assert record["device"] == "cpu" and record["overlap_mode"] == "off"
    anat = record["anatomy"]
    assert anat["method"]["compute"] == "flops / peak"  # no MFU on a CPU
    assert anat["method"]["peak_flops_estimate"] is True
    assert sum(anat["components_ms"].values()) == pytest.approx(
        anat["step_ms"], rel=1e-3)
    assert "top_ops" not in anat  # the CPU runs no flash kernel


@PKGS
def test_runner_hands_each_point_its_budget_and_record_dir(tmp_path, mod):
    """A bench child (a stub named as a bench) receives the point's budget
    as ``--total-budget-secs`` and the journal's directory as
    ``HVDTPU_BENCH_RECORD_DIR``, as the reference's runner hands them;
    the campaign's fault spec stays out of its environment."""
    stub = tmp_path / "bench_stub.py"
    seen = tmp_path / "seen.json"
    stub.write_text(
        "import json, os, sys\n"
        f"with open({str(seen)!r}, 'w') as f:\n"
        "    json.dump({'argv': sys.argv[1:], 'env': {k: os.environ.get(k)\n"
        "               for k in ('HVDTPU_BENCH_RECORD_DIR', 'POINT_ENV',\n"
        "                         'HVDTPU_FAULT_SPEC')}}, f)\n"
        "print(json.dumps({'metric': 'stub', 'value': 1.0}))\n")
    point = {"id": "p", "argv": ["--iters", "2"],
             "env": {"POINT_ENV": "x"}, "budget_secs": 77}
    d = tmp_path / "records"
    os.environ["HVDTPU_FAULT_SPEC"] = "campaign_point:step=9:action=abort"
    try:
        res = mod.subprocess_runner(point, {"point_budget_secs": 60},
                                    bench_cmd=[sys.executable, str(stub)],
                                    record_dir=str(d))
    finally:
        os.environ.pop("HVDTPU_FAULT_SPEC")
    assert res["rc"] == 0 and res["parsed"] == {"metric": "stub",
                                                "value": 1.0}
    got = json.loads(seen.read_text())
    assert got["argv"] == ["--iters", "2", "--total-budget-secs", "77"]
    assert got["env"] == {"HVDTPU_BENCH_RECORD_DIR": str(d),
                          "POINT_ENV": "x", "HVDTPU_FAULT_SPEC": None}


def test_runner_budgets_the_ports_bench_module(tmp_path, monkeypatch):
    """The port's default command, ``python -m horovod_tpu_torch.bench``,
    is the real bench: it gets the budget flag too (unless the point set
    one)."""
    calls = []

    def fake_run(cmd, env, **kw):
        calls.append((cmd, env["HVDTPU_BENCH_RECORD_DIR"]))
        return subprocess.CompletedProcess(cmd, 0, '{"value": 1.0}\n', "")

    monkeypatch.setattr(campaign.subprocess, "run", fake_run)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.bench"]
    for argv in (["--cpu"], ["--cpu", "--total-budget-secs", "5"]):
        campaign.subprocess_runner(
            {"id": "p", "argv": argv, "env": {}}, {"point_budget_secs": 60},
            bench_cmd=cmd, record_dir=str(tmp_path))
    assert calls == [
        (cmd + ["--cpu", "--total-budget-secs", "60"], str(tmp_path)),
        (cmd + ["--cpu", "--total-budget-secs", "5"], str(tmp_path))]
