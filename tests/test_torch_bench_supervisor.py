"""The port's bench supervisor (``horovod_tpu_torch/bench/supervisor.py``
and its wiring in ``bench/__init__.py``) against the reference's
contracts: one test for each of ``tests/test_bench_retry.py``'s, the
degraded record and the regression sentinel of ``tests/test_fastpath.py``
and ``tests/test_campaign.py`` run through both packages over the same
record directories, the trend plane's readings of the same directories,
and one bench process on this GPU-less host.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import pytest

from horovod_tpu_torch.bench import supervisor as sup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_record_dir(monkeypatch):
    """No test here writes a record or a sidecar unless it names a
    directory itself."""
    for name in sup.RECORD_DIR_ENVS + (sup.SIDECAR_ENV,):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def ref_bench():
    import bench

    return bench


def test_is_unavailable_matches_card_signatures():
    transient = [
        RuntimeError("CUDA error: all CUDA-capable devices are busy or "
                     "unavailable\nCUDA kernel errors might be "
                     "asynchronously reported"),
        RuntimeError("cudaErrorDevicesUnavailable: CUDA-capable device(s) "
                     "is/are busy or unavailable"),
        type("DistStoreError", (RuntimeError,), {})(
            "Timed out after 301 seconds waiting for clients. 1/2 clients "
            "joined."),
        RuntimeError("Timed out initializing process group in store based "
                     "barrier on rank 0, for key: store_based_barrier_key:1"),
        RuntimeError("NCCL communicator was aborted on rank 1: Timeout "
                     "waiting for ncclCommInitRank"),
        type("DistBackendError", (RuntimeError,), {})(
            "Timed out waiting for NCCL communicator initialization on "
            "rank 1"),
    ]
    for exc in transient:
        assert sup._is_unavailable(exc), exc
    permanent = [
        RuntimeError("horovod_tpu_torch.init(): no CUDA device is visible; "
                     "pass device='cpu' to run on the CPU"),
        RuntimeError("CUDA error: out of memory"),
        RuntimeError("CUDA kernel build failed:\n--- flash_fwd_tc"),
        # a collective that hung inside a step is the port's fault, not
        # the card's: torch's NCCL watchdog, not communicator init
        type("DistBackendError", (RuntimeError,), {})(
            "[Rank 0] Watchdog caught collective operation timeout: "
            "WorkNCCL(SeqNum=7, OpType=ALLREDUCE, NumelIn=1024, "
            "NumelOut=1024, Timeout(ms)=600000) ran for 600081 "
            "milliseconds before timing out."),
        RuntimeError("NCCL error: unhandled system error, NCCL version "
                     "2.21.5; last error: Timeout in ncclAllReduce"),
        ValueError("shape mismatch"),
        KeyboardInterrupt(),
    ]
    for exc in permanent:
        assert not sup._is_unavailable(exc), exc


class _Args:
    """Minimal stand-in for the parsed-argparse namespace."""

    cpu = False
    watchdog_secs = 780
    retry_attempt = 1
    attempts = 4
    deadline_epoch = 0.0


def test_reexec_runs_the_module_with_the_deadline_carried(monkeypatch):
    calls = {}

    def fake_execv(exe, argv):
        calls["exe"], calls["argv"] = exe, argv
        raise SystemExit(0)  # execv never returns; simulate the cut

    monkeypatch.setattr(sup.os, "execv", fake_execv)
    monkeypatch.setattr(
        sup.sys, "argv",
        ["/x/horovod_tpu_torch/bench/__main__.py", "--model", "gpt-small",
         "--batch-size", "8", "--retry-attempt=1", "--deadline-epoch=123.0"])
    args = _Args()
    args.deadline_epoch = 456.0
    with pytest.raises(SystemExit):
        sup._reexec_next_attempt(args)
    argv = calls["argv"]
    assert calls["exe"] == sys.executable
    assert argv[:3] == [sys.executable, "-m", "horovod_tpu_torch.bench"]
    assert argv.count("--retry-attempt=2") == 1
    assert "--retry-attempt=1" not in argv
    # carried, never re-minted: a fresh deadline would reset the budget
    assert argv.count("--deadline-epoch=456.0") == 1
    assert "--deadline-epoch=123.0" not in argv
    assert argv[3:7] == ["--model", "gpt-small", "--batch-size", "8"]


def test_give_up_when_budget_exhausted(monkeypatch, capsys):
    """Retries left but under 180 s of budget: exit 86 at once, no
    re-exec, and the sidecar (no path named) on stderr."""
    rc = {}
    monkeypatch.setattr(sup.os, "_exit", lambda c: rc.setdefault("rc", c))
    monkeypatch.setattr(
        sup.os, "execv",
        lambda *a: pytest.fail("must not re-exec with no budget"))
    args = _Args()
    args.deadline_epoch = time.time() + 60
    sup._give_up_or_retry(args, "watchdog: test")
    assert rc["rc"] == 86
    err = capsys.readouterr().err
    side = json.loads(err.split("# bench failure: ", 1)[1].splitlines()[0])
    assert side["outcome"] == "gave_up" and side["why"] == "watchdog: test"


def test_retry_when_budget_remains(monkeypatch):
    calls = {}

    def fake_execv(exe, argv):
        calls["argv"] = argv
        raise SystemExit(0)

    monkeypatch.setattr(sup.os, "execv", fake_execv)
    monkeypatch.setattr(sup.sys, "argv", ["__main__.py"])
    args = _Args()
    args.deadline_epoch = time.time() + 1000
    with pytest.raises(SystemExit):
        sup._give_up_or_retry(args, "device unavailable")
    assert any(a == "--retry-attempt=2" for a in calls["argv"])


def test_kernel_build_dir_inside_the_checkout():
    """The counterpart of the reference's compile cache: a retry (and a
    later run of the same checkout) loads the kernels and the native
    engine its predecessor built, from a git-ignored directory of the
    checkout."""
    from horovod_tpu_torch.ops import kernels
    from horovod_tpu_torch.runtime import native_build

    for path in (kernels.build_dir(), native_build.BUILD_ROOT):
        rel = os.path.relpath(os.path.realpath(path), os.path.realpath(REPO))
        assert not rel.startswith(".."), path
        assert rel.startswith(os.path.join("horovod_tpu_torch", "_build"))
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "horovod_tpu_torch/_build/" in f.read().split()


class _FakeThread:
    daemon = True

    def start(self):
        pass


def test_watchdog_disarmed_on_cpu(monkeypatch):
    started = []
    monkeypatch.setattr(
        threading, "Thread",
        lambda *a, **k: started.append(1) or _FakeThread())
    args = _Args()
    args.cpu = True
    sup._arm_watchdog(args)
    assert not started


def test_backend_provenance_no_probe_never_initialises_cuda(monkeypatch):
    """The degraded and death paths may run while CUDA is what hangs:
    probe=False reads only a context that exists."""
    import torch

    from horovod_tpu_torch import basics

    def boom(*a, **k):
        raise AssertionError("probe=False called into CUDA")

    for name in ("init", "_lazy_init", "is_available", "device_count",
                 "current_device", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, boom)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(basics, "is_initialized", lambda: False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    prov = sup.backend_provenance(probe=False)
    assert prov == {"platform": None, "device_kind": None,
                    "cuda_visible_devices": "0"}


def test_backend_provenance_probe_reports_device(monkeypatch):
    from horovod_tpu_torch import basics

    monkeypatch.setattr(basics, "is_initialized", lambda: False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    prov = sup.backend_provenance(probe=True)
    assert prov == {"platform": "cpu", "device_kind": "cpu",
                    "cuda_visible_devices": ""}


def test_degraded_record_carries_provenance_stamp(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    path = sup.write_degraded_record("watchdog fired", rc=86,
                                     phase="measure",
                                     record_dir=str(tmp_path))
    doc = json.load(open(path))
    assert doc["degraded"] is True
    prov = doc["provenance"]
    assert set(prov) == {"platform", "device_kind", "cuda_visible_devices"}
    assert prov["cuda_visible_devices"] == ""
    assert doc["cmd"].startswith("python -m horovod_tpu_torch.bench")


def test_no_record_without_a_named_dir(tmp_path, monkeypatch):
    """With no record dir named, nothing is written: the checkout is not
    a default."""
    monkeypatch.chdir(tmp_path)
    assert sup.write_degraded_record("x", rc=1, phase="init") is None
    assert sup._auto_record("x", rc=1, phase="init") is None
    assert os.listdir(tmp_path) == []
    monkeypatch.setenv("HVDTPU_RECORD_DIR", str(tmp_path))
    assert sup._auto_record("x", rc=1, phase="init").endswith(
        "BENCH_r01.json")
    monkeypatch.setenv("HVDTPU_BENCH_RECORD_DIR", str(tmp_path / "b"))
    os.makedirs(tmp_path / "b")
    assert sup.bench_record_dir() == str(tmp_path / "b")
    monkeypatch.setenv("HVDTPU_RANK", "1")
    assert sup._auto_record("x", rc=1, phase="init") is None  # rank 0 only


def test_watchdog_gives_up_from_its_thread(monkeypatch):
    """The daemon thread decides alone: a spent budget before
    ``measure``, then a phase that outlived its window; in ``measure`` a
    spent budget alone fires nothing (a progressing measurement is never
    killed)."""
    fired = []
    done = threading.Event()

    def record(args, why):
        fired.append((why, sup._phase_name))
        done.set()
        raise SystemExit  # ends the watchdog thread, as os._exit would

    monkeypatch.setattr(sup, "WATCHDOG_TICK", 0.01)
    monkeypatch.setattr(sup, "_give_up_or_retry", record)
    monkeypatch.setattr(threading, "excepthook", lambda a: None)
    args = _Args()
    args.deadline_epoch = time.time() - 1
    sup._touch_progress(phase="build")
    sup._arm_watchdog(args)
    assert done.wait(10)
    assert fired == [("watchdog: total budget exhausted", "build")]
    done.clear()
    sup._touch_progress(phase="measure")  # the budget is still spent
    sup._arm_watchdog(args)
    assert not done.wait(0.5), fired  # ~50 ticks
    sup._watchdog_disarm.set()
    time.sleep(0.05)  # the thread sees the disarm and ends
    sup._touch_progress(next_window=0.0, phase="measure")
    sup._arm_watchdog(args)
    assert done.wait(10)
    assert fired[1] == ("watchdog: no progress in phase 'measure' for 0s",
                        "measure")
    sup._watchdog_disarm.set()
    sup._touch_progress(phase="init")


# ------------------------------------- degraded record, both packages


class TestDegradedBenchRecord:
    def test_write_and_schema(self, tmp_path, ref_bench):
        for mod, d in ((ref_bench, tmp_path / "ref"), (sup, tmp_path / "p")):
            d.mkdir()
            path = mod.write_degraded_record(
                "device unavailable", rc=86, phase="compile",
                record_dir=str(d))
            doc = json.loads(open(path).read())
            assert doc["degraded"] is True
            assert doc["failure_phase"] == "compile"
            assert doc["parsed"] is None
            assert isinstance(doc["n"], int) and doc["rc"] == 86
            assert "unavailable" in doc["tail"]
            assert os.path.basename(path) == "BENCH_r01.json"

    def test_numbering_continues_from_existing(self, tmp_path, ref_bench):
        (tmp_path / "BENCH_r07.json").write_text(json.dumps({"n": 7}))
        for mod, want in ((ref_bench, "BENCH_r08.json"),
                          (sup, "BENCH_r09.json")):
            path = mod.write_degraded_record(
                "x", rc=86, phase="init", record_dir=str(tmp_path))
            assert path.endswith(want)


SENTINEL_KEYS = ("regression", "deltas", "baseline_record", "trend")


def _both(ref_bench, out, d):
    """``attach_regression`` of both packages on copies of ``out`` over
    ``d``; the port's result, after holding the keys equal."""
    from horovod_tpu_torch import bench

    ref, port = dict(out), dict(out)
    ref_bench.attach_regression(ref, record_dir=str(d))
    bench.attach_regression(port, record_dir=str(d))
    for k in SENTINEL_KEYS:
        assert ref.get(k) == port.get(k), k
    return port


def test_attach_regression_skips_degraded(tmp_path, ref_bench):
    good = {"n": 1, "rc": 0,
            "parsed": {"metric": "m", "device": "NVIDIA H100 80GB HBM3",
                       "value": 100.0, "mfu": 0.3}}
    degraded = {"n": 2, "rc": 86, "degraded": True, "failure_phase": "init",
                "parsed": None}
    (tmp_path / "BENCH_r01.json").write_text(json.dumps(good))
    (tmp_path / "BENCH_r02.json").write_text(json.dumps(degraded))
    out = _both(ref_bench, {"metric": "m", "device": "NVIDIA H100 80GB HBM3",
                            "value": 90.0}, tmp_path)
    assert out["baseline_record"]["file"] == "BENCH_r01.json"
    assert out["baseline_record"]["degraded_records_skipped"] == 1
    assert out["deltas"]["value"]["pct"] == pytest.approx(-10.0)


@pytest.fixture()
def ewma_dir(tmp_path):
    """Three real records (1000, 1000, 1000) and a degraded 9999 that must
    never become a bar."""
    for n, doc in enumerate((
        {"rc": 0, "parsed": {"metric": "ips", "value": 1000.0,
                             "device": "NVIDIA H100 80GB HBM3"}},
        {"rc": 0, "parsed": {"metric": "ips", "value": 1000.0,
                             "device": "NVIDIA H100 80GB HBM3"}},
        {"rc": 0, "parsed": {"metric": "ips", "value": 1000.0,
                             "device": "NVIDIA H100 80GB HBM3"}},
        {"rc": 0, "degraded": True,
         "parsed": {"metric": "ips", "value": 9999.0,
                    "device": "NVIDIA H100 80GB HBM3", "degraded": True}},
    ), start=1):
        doc["n"] = n
        (tmp_path / f"BENCH_r{n:02d}.json").write_text(json.dumps(doc))
    return tmp_path


def test_sentinel_flags_planted_regression(ewma_dir, ref_bench):
    out = _both(ref_bench, {"metric": "ips", "value": 700.0,
                            "device": "NVIDIA H100 80GB HBM3"}, ewma_dir)
    assert out["regression"] is True
    assert out["deltas"]["value"]["pct"] == pytest.approx(-30.0)
    prov = out["baseline_record"]
    assert prov["baseline_records"] == [
        "BENCH_r01.json", "BENCH_r02.json", "BENCH_r03.json"]
    assert prov["degraded_records_skipped"] == 1
    assert out["trend"]["last_real_record"] == "BENCH_r03.json"


def test_sentinel_quiet_on_noise(ewma_dir, ref_bench):
    out = _both(ref_bench, {"metric": "ips", "value": 980.0,
                            "device": "NVIDIA H100 80GB HBM3"}, ewma_dir)
    assert out["regression"] is False
    out = _both(ref_bench, {"metric": "other", "value": 1.0,
                            "device": "NVIDIA H100 80GB HBM3"}, ewma_dir)
    assert out["regression"] is None  # nothing comparable: no verdict


def test_sentinel_with_no_record_dir_compares_nothing():
    from horovod_tpu_torch import bench

    out = bench.attach_regression({"metric": "m", "value": 1.0,
                                   "device": "cpu"})
    assert out["regression"] is None and "trend" not in out
    assert out["baseline_record"]["file"] is None


@pytest.mark.parametrize("which", ["repo_records", "mixed"])
def test_trend_reads_record_dirs_as_the_reference(which, tmp_path):
    """``obs/trend.py``'s readings of the same directories: the repo
    root's TPU trajectory (every schema era, read in place), and a mixed
    directory of real, degraded, failed, bare and unreadable records."""
    from horovod_tpu.obs import trend as ref
    from horovod_tpu_torch.obs import trend as port

    if which == "repo_records":
        d = REPO
    else:
        d = str(tmp_path)
        docs = {
            "BENCH_r01.json": {"n": 1, "rc": 0, "parsed": {
                "metric": "ips", "value": 10.0, "mfu": 0.1,
                "device": "NVIDIA H100 80GB HBM3"}},
            "BENCH_r02.json": {"n": 2, "rc": 1, "parsed": None},
            "BENCH_r03.json": {"metric": "ips", "value": 11.0,
                               "device": "NVIDIA H100 80GB HBM3"},
            "BENCH_r04.json": {"n": 4, "rc": 86, "degraded": True,
                               "failure_phase": "build", "parsed": None},
            "BENCH_r05.json": {"n": 5, "rc": 0, "parsed": {
                "metric": "ips", "value": 12.0, "device": "cpu"}},
        }
        for name, doc in docs.items():
            (tmp_path / name).write_text(json.dumps(doc))
        (tmp_path / "BENCH_r06.json").write_text("{not json")
    records = ref.load_bench_records(d)
    assert records and port.load_bench_records(d) == records
    for _, _, doc in records:
        assert port.classify(doc) == ref.classify(doc)
        parsed = ref.parsed_payload(doc)
        assert port.parsed_payload(doc) == parsed
        if isinstance(parsed, dict):
            assert port.scenario_key(parsed) == ref.scenario_key(parsed)
    keys = {ref.scenario_key(p) for p in (
        ref.parsed_payload(doc) for _, _, doc in records)
        if isinstance(p, dict)}
    for key in keys:
        assert port.ewma_baseline(records, *key) == \
            ref.ewma_baseline(records, *key)
    assert port.trend_stamp(d) == ref.trend_stamp(d)


def _bench_files():
    return {f: os.stat(os.path.join(REPO, f)).st_mtime_ns
            for f in os.listdir(REPO)
            if f.startswith("BENCH_") or f == sup.SIDECAR_NAME}


def test_bench_without_a_gpu_lands_an_init_record(tmp_path):
    """``python -m horovod_tpu_torch.bench`` without ``--cpu`` on a host
    with no card: "no CUDA device is visible" is not transient, so the
    process exits non-zero at once, never re-execs, and lands one
    degraded record whose phase is ``init``, in the named dir alone."""
    before = _bench_files()
    env = dict(os.environ, HVDTPU_BENCH_RECORD_DIR=str(tmp_path),
               CUDA_VISIBLE_DEVICES="")
    env.pop("HVDTPU_RECORD_DIR", None)
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench", "--model",
         "gpt-nano"], env=env, capture_output=True, text=True, timeout=120,
        cwd=REPO)
    assert out.returncode not in (0, 86), out.stderr[-2000:]
    assert "no CUDA device is visible" in out.stderr
    assert "re-exec" not in out.stderr
    assert time.monotonic() - t0 < sup.WATCHDOG_TICK + 60
    assert sorted(os.listdir(tmp_path)) == ["BENCH_r01.json"]
    doc = json.load(open(tmp_path / "BENCH_r01.json"))
    assert doc["degraded"] is True and doc["failure_phase"] == "init"
    assert doc["rc"] == 1 and "no CUDA device is visible" in doc["tail"]
    assert doc["provenance"]["platform"] is None
    assert _bench_files() == before  # nothing written into the checkout
