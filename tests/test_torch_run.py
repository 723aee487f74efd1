"""The port's launcher (``horovod_tpu_torch.run``) against the JAX
package's (``horovod_tpu.run``): the pure decision tables — host parsing,
slot allocation, CLI flags to worker env, config layering, the host
blacklist — run through both on the same inputs; the HMAC-signed KV store
(round trip, unsigned writes and deletes rejected, one package's client
against the other's server); the flags of unported planes refused; and a
2-rank CPU job through ``launch_job`` and through ``python -m
horovod_tpu_torch.run``, whose gloo ranks see rank/size 0/2 and 1/2.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import horovod_tpu.run.allocate as j_alloc
import horovod_tpu.run.blacklist as j_black
import horovod_tpu.run.config_parser as j_cfg
import horovod_tpu.run.rendezvous as j_kv
import horovod_tpu.run.runner as j_runner
from horovod_tpu_torch.run import allocate, blacklist, config_parser, \
    rendezvous, runner

REPO = Path(__file__).resolve().parent.parent


def _slots(pkg, hosts, np):
    return [dataclasses.astuple(s)
            for s in pkg.allocate(pkg.parse_hosts(hosts), np)]


@pytest.mark.parametrize("hosts", ["h1:2,h2:4", "solo", " a:1 , b ",
                                   "node-1:3"])
def test_parse_hosts_matches_the_reference(hosts):
    assert [(h.hostname, h.slots) for h in allocate.parse_hosts(hosts)] == \
        [(h.hostname, h.slots) for h in j_alloc.parse_hosts(hosts)]


@pytest.mark.parametrize("bad", ["", "h1:x", ","])
def test_bad_hosts_raise_in_both(bad):
    for pkg in (allocate, j_alloc):
        with pytest.raises(ValueError):
            pkg.parse_hosts(bad)


def test_parse_hostfile_matches_the_reference(tmp_path):
    p = tmp_path / "hosts"
    p.write_text(textwrap.dedent("""
        # comment
        node1 slots=2
        node2   slots=1
        node3
        node4 slots = 4  # trailing
        """))
    port = [(h.hostname, h.slots) for h in allocate.parse_hostfile(str(p))]
    assert port == [(h.hostname, h.slots)
                    for h in j_alloc.parse_hostfile(str(p))]
    assert port[:3] == [("node1", 2), ("node2", 1), ("node3", 1)]


@pytest.mark.parametrize("hosts,np", [
    ("a:2,b:2", 4), ("a:4,b:4", 5), ("a:1,b:2", 3), ("a:3,b:1,c:2", 6),
    ("localhost:8", 1),
])
def test_allocation_matches_the_reference(hosts, np):
    assert _slots(allocate, hosts, np) == _slots(j_alloc, hosts, np)


def test_allocation_overflow_raises_in_both():
    for pkg in (allocate, j_alloc):
        with pytest.raises(ValueError, match="only 2 slots"):
            pkg.allocate(pkg.parse_hosts("a:2"), 3)


@pytest.mark.parametrize("np,slices", [(8, 2), (6, 3), (4, 1), (6, 4)])
def test_slice_assignment_matches_the_reference(np, slices):
    def run(pkg):
        try:
            return pkg.slice_assignment(np, slices)
        except ValueError as e:
            return type(e)
    assert run(allocate) == run(j_alloc)


# flags of the planes both packages carry
SHARED_ARGV = [
    ["--fusion-threshold-mb", "32", "--cycle-time-ms", "3.5"],
    ["--fusion-threshold-mb", "0"],
    ["--timeline-filename", "/tmp/t.json", "--timeline-mark-cycles"],
    ["--no-stall-check", "--log-level", "debug"],
    ["--stall-check-warning-time-seconds", "5",
     "--stall-check-shutdown-time-seconds", "9"],
    ["--autotune", "--autotune-log-file", "/tmp/a.csv",
     "--autotune-warmup-samples", "1", "--autotune-steps-per-sample", "2",
     "--autotune-bayes-opt-max-samples", "5",
     "--autotune-gaussian-process-noise", "0.01",
     "--autotune-drift-threshold", "0.3", "--autotune-drift-samples", "4"],
    ["--hierarchical-allreduce", "--num-slices", "2",
     "--dcn-compression", "bf16"],
    ["--no-schedule-replay", "--schedule-replay-cycles", "7",
     "--cache-capacity", "64"],
    ["--ckpt-dir", "/tmp/ck", "--ckpt-replica",
     "--ckpt-replica-chunk-kb", "256", "--ckpt-commit-timeout-secs", "30"],
    ["--serve", "--serve-model", "small", "--serve-slots", "16",
     "--serve-max-len", "900", "--serve-seed", "3", "--serve-kv-mode",
     "paged", "--serve-page-size", "16", "--serve-kv-pages", "512",
     "--serve-weights-dir", "/w", "--serve-swap-poll-steps", "8",
     "--frontends", "2", "--serve-tenant-budget", "64"],
    ["--slo-ttft-ms", "500", "--slo-tpot-ms", "80", "--slo-objective",
     "0.9", "--slo-class", "standard"],
]


@pytest.mark.parametrize("flags", SHARED_ARGV,
                         ids=[f[0].lstrip("-") for f in SHARED_ARGV])
def test_parse_args_to_env_matches_the_reference(flags):
    argv = ["-np", "2", *flags, "python", "train.py"]
    port, ref = runner.parse_args(argv), j_runner.parse_args(argv)
    assert port.np == ref.np == 2
    assert port.command == ref.command == ["python", "train.py"]
    env_port, env_ref = {}, {}
    config_parser.set_env_from_args(env_port, port)
    j_cfg.set_env_from_args(env_ref, ref)
    assert env_port == env_ref and env_port


@pytest.mark.parametrize("flags", [
    ["--min-workers", "2", "--max-elastic-retries", "0"],
    ["--blacklist-cooldown-secs", "0", "--progress-timeout-secs", "120",
     "--progress-grace-secs", "900"],
])
def test_elastic_launcher_knobs_match_the_reference(flags):
    argv = ["-np", "3", "--elastic", *flags, "python", "x"]
    port, ref = runner.parse_args(argv), j_runner.parse_args(argv)
    for attr in ("elastic", "min_workers", "max_elastic_retries",
                 "blacklist_cooldown_secs", "progress_timeout_secs",
                 "progress_grace_secs"):
        assert getattr(port, attr) == getattr(ref, attr), attr


def test_config_file_layering_matches_the_reference(tmp_path):
    """Explicit CLI flags beat the config file; the file beats defaults
    (reference runner.py:446-450)."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(textwrap.dedent("""
        params:
          fusion-threshold-mb: 16
          cycle-time-ms: 2
        timeline:
          filename: /from/file.json
        checkpoint:
          dir: /from/file/ckpt
        """))
    argv = ["-np", "2", "--config-file", str(cfg), "--cycle-time-ms", "9",
            "python", "x.py"]
    port, ref = runner.parse_args(argv), j_runner.parse_args(argv)
    for attr in ("fusion_threshold_mb", "cycle_time_ms",
                 "timeline_filename", "ckpt_dir"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.cycle_time_ms == 9 and port.fusion_threshold_mb == 16


@pytest.mark.parametrize("flags,item", [
    (["--scale-up-queue", "4"], "A13b"),
    (["--serve-autoscale"], "A13b"),
    (["--max-workers", "4"], "A13b"),
    (["--scale-down-idle-secs", "30"], "A13b"),
    (["--scale-cooldown-secs", "5"], "A13b"),
])
def test_unported_flags_raise_naming_their_item(flags, item):
    """The serving-autoscale flags, which ROADMAP ``item`` ported: they
    parse as the reference's do and land in the same env."""
    argv = ["-np", "1", "--serve", *flags, "python", "x"]
    port, ref = runner.parse_args(argv), j_runner.parse_args(argv)
    attr = flags[0][2:].replace("-", "_")
    assert getattr(port, attr) == getattr(ref, attr) is not None
    env_port, env_ref = {}, {}
    config_parser.set_env_from_args(env_port, port)
    j_cfg.set_env_from_args(env_ref, ref)
    assert env_port == env_ref and env_port


# The observability planes' flags (ported with obs/): they parse as the
# reference's do and land in the same env for every rank.
OBS_FLAGS = [
    ["--alert-skew-ms", "5"], ["--health-check-steps", "10"],
    ["--stats-summary"], ["--metrics-dump", "/tmp/m"],
    ["--live-stats-secs", "1"], ["--live-port", "0"],
    ["--live-history-file", "/tmp/h.jsonl"],
    ["--flightrec-dump", "/tmp/f"], ["--trace", "/tmp/t"],
    ["--trace-sample-rate", "0.25"], ["--health", "on"],
    ["--divergence-action", "halt"], ["--dump-grace-secs", "0"],
]


@pytest.mark.parametrize("flags", OBS_FLAGS)
def test_obs_flags_are_ported_like_the_reference(flags):
    argv = ["-np", "1", *flags, "python", "x"]
    port, ref = runner.parse_args(argv), j_runner.parse_args(argv)
    attr = flags[0][2:].replace("-", "_")
    assert getattr(port, attr) == getattr(ref, attr)
    env_port, env_ref = {}, {}
    config_parser.set_env_from_args(env_port, port)
    j_cfg.set_env_from_args(env_ref, ref)
    assert env_port == env_ref


def test_unported_config_keys_raise(tmp_path):
    """The serving-autoscale config keys (ported with A13b) layer under
    the command line as the reference's do."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("serve:\n  autoscale: true\n  max-workers: 3\n"
                   "  scale-up-queue: 6\n")
    argv = ["-np", "1", "--config-file", str(cfg), "--scale-up-queue", "2",
            "x"]
    port, ref = runner.parse_args(argv), j_runner.parse_args(argv)
    for attr in ("serve_autoscale", "max_workers", "scale_up_queue"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert (port.serve_autoscale, port.max_workers, port.scale_up_queue) \
        == (True, 3, 2)


def test_obs_config_keys_match_the_reference(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(textwrap.dedent("""
        metrics:
          dump: /from/file/m
          flightrec-dump: /from/file/f
          live-stats-secs: 2
          alert-skew-ms: 7
          health: "on"
          health-check-steps: 4
          divergence-action: dump
        trace:
          target: /from/file/t
          sample-rate: 0.5
        """))
    argv = ["-np", "1", "--config-file", str(cfg), "python", "x"]
    port, ref = runner.parse_args(argv), j_runner.parse_args(argv)
    env_port, env_ref = {}, {}
    config_parser.set_env_from_args(env_port, port)
    j_cfg.set_env_from_args(env_ref, ref)
    assert env_port == env_ref and len(env_port) == 9


@pytest.mark.parametrize("kwarg,item", [
    ({"autoscale": {}}, "A13b"), ({"max_workers": 4}, "A13b"),
])
def test_unported_elastic_keywords_raise(kwarg, item):
    """The serving-autoscale keywords (ported with ROADMAP ``item``) run a
    job: a world of one ``true``, with standby slots up to max_workers or
    the controller armed (no serving gauges: it never decides)."""
    result = runner.launch_elastic_job(["true"], 1, job_timeout=60, **kwarg)
    assert result.exit_codes == {0: 0}
    assert not [e for e in result.trace if e[0].startswith("scale_")]


@pytest.mark.parametrize("kwarg", [
    {"live_history": "h.jsonl", "live_stats_secs": 0.2},
    {"dump_grace_secs": 0.5},
])
def test_obs_elastic_keywords_are_accepted(kwarg, tmp_path, monkeypatch):
    """The observability keywords of ``launch_elastic_job`` run a job (a
    world of one ``true``): the live plane's history lands where asked."""
    monkeypatch.chdir(tmp_path)
    result = runner.launch_elastic_job([sys.executable, "-c", "pass"], 1,
                                       job_timeout=60, **kwarg)
    assert result.exit_codes == {0: 0}


def test_build_slot_env_matches_the_reference():
    slot = allocate.SlotInfo("h", 3, 8, 1, 4, 0, 2)
    jslot = j_alloc.SlotInfo("h", 3, 8, 1, 4, 0, 2)
    base = {"PATH": "/bin"}
    assert runner.build_slot_env(slot, "10.0.0.1:9999", base) == \
        j_runner.build_slot_env(jslot, "10.0.0.1:9999", base)


def test_check_build_reports_torch_not_jax():
    report = runner.check_build()
    assert "torch" in report and "gloo" in report and "NCCL" in report
    assert "flash-attention kernels built" in report
    assert "XLA" not in report and "jax" not in report


BLACKLIST = [
    # (op, host, arg): "fail" records a failure, "tick" advances the
    # clock; after each op every package's answers are compared
    [("fail", "a", None), ("tick", None, 5.0), ("fail", "a", None),
     ("tick", None, 10.0), ("tick", None, 10.0)],
    [("fail", "a", None), ("fail", "b", None), ("tick", None, 9.0),
     ("fail", "c", None), ("tick", None, 2.0)],
    [("fail", "a", None)] * 12 + [("tick", None, 299.0),
                                   ("tick", None, 2.0)],
]


@pytest.mark.parametrize("ops", BLACKLIST, ids=["backoff", "select",
                                                 "cap"])
def test_blacklist_backoff_and_selection_match_the_reference(ops):
    def trace(pkg):
        now = [0.0]
        bl = pkg.HostBlacklist(cooldown_base=10.0, cooldown_cap=300.0,
                               clock=lambda: now[0])
        out = []
        for op, host, arg in ops:
            if op == "fail":
                out.append(bl.record_failure(host))
            else:
                now[0] += arg
            out.append((
                bl.blacklisted(),
                [bl.is_admissible(h) for h in "abc"],
                [round(bl.readmission_in(h), 9) for h in "abc"],
                bl.select(["a", "b", "c"], prefer="a"),
                bl.select(["a"], prefer="a"),
            ))
        return out

    assert trace(blacklist) == trace(j_black)


def test_blacklist_slice_quorum_matches_the_reference():
    def trace(pkg):
        now = [0.0]
        bl = pkg.HostBlacklist(cooldown_base=10.0, clock=lambda: now[0])
        members = ["h0", "h1", "h2"]
        out = [bl.record_failure("h0", slice_id=0, slice_hosts=members),
               bl.blacklisted_slices(),
               bl.record_failure("h1", slice_id=0, slice_hosts=members),
               bl.blacklisted_slices(), bl.blacklisted()]
        now[0] += 11.0
        out += [bl.blacklisted_slices(), bl.select(members + ["x"])]
        return out

    assert trace(blacklist) == trace(j_black)


@pytest.fixture
def server():
    srv = rendezvous.KVStoreServer()
    srv.start()
    try:
        yield srv
    finally:
        srv.stop()


def test_kvstore_roundtrip(server):
    client = rendezvous.KVStoreClient(f"127.0.0.1:{server.port}",
                                      secret=server.secret)
    assert client.get("s", "missing") is None
    client.put("s", "k", b"payload")
    assert client.get("s", "k") == b"payload"
    assert client.wait("s", "k", timeout=1) == b"payload"
    client.delete("s", "k")
    assert client.get("s", "k") is None


def test_kvstore_rejects_unsigned_writes_and_deletes(server):
    good = rendezvous.KVStoreClient(f"127.0.0.1:{server.port}",
                                    secret=server.secret)
    attacker = rendezvous.KVStoreClient(f"127.0.0.1:{server.port}",
                                        secret="wrong")
    with pytest.raises(PermissionError, match="rejected"):
        attacker.put("s", "k", b"evil")
    assert good.get("s", "k") is None  # nothing was stored
    good.put("s", "k", b"v")
    with pytest.raises(PermissionError, match="rejected the delete"):
        attacker.delete("s", "k")
    assert good.get("s", "k") == b"v"
    with pytest.raises(PermissionError, match="bad payload signature"):
        attacker.get("s", "k")


@pytest.mark.parametrize("server_pkg,client_pkg", [
    (rendezvous, j_kv), (j_kv, rendezvous)], ids=["port_server",
                                                   "jax_server"])
def test_kvstore_wire_matches_the_reference(server_pkg, client_pkg):
    """The same signed protocol: each package's client against the
    other's server."""
    srv = server_pkg.KVStoreServer()
    srv.start()
    try:
        client = client_pkg.KVStoreClient(f"127.0.0.1:{srv.port}",
                                          secret=srv.secret)
        client.put("scope", "key", b"\x00bytes\xff")
        assert client.get("scope", "key") == b"\x00bytes\xff"
        client.delete("scope", "key")
        assert client.get("scope", "key") is None
    finally:
        srv.stop()


def test_kvstore_transport_error_names_address():
    client = rendezvous.KVStoreClient("127.0.0.1:1", secret="x")
    with pytest.raises(ConnectionError, match="127.0.0.1:1"):
        client.get("s", "k")


RANK_SIZE = ("import horovod_tpu_torch as hvd; hvd.init(device='cpu'); "
             "print('RS', hvd.rank(), hvd.size(), flush=True); "
             "hvd.shutdown()")


def _env():
    return {"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}


def test_launch_job_two_gloo_ranks(tmp_path):
    """A 2-rank ``launch_job`` of a command that calls ``hvd.init(device=
    "cpu")``: each rank sees its rank and the world size, and
    ``--output-filename`` captures each rank's stream."""
    rcs = runner.launch_job([sys.executable, "-c", RANK_SIZE], 2,
                            env=_env(), output_filename=str(tmp_path),
                            job_timeout=60, start_timeout=60)
    assert rcs == {0: 0, 1: 0}
    for rank in (0, 1):
        out = (tmp_path / f"rank.{rank}" / "stdout").read_text()
        assert f"RS {rank} 2" in out


def test_cli_two_gloo_ranks_import_no_jax():
    """``python -m horovod_tpu_torch.run -np 2 python -c ...`` on the
    CPU: two gloo ranks at 0/2 and 1/2, and neither the launcher nor the
    workers import jax, horovod_tpu, cloudpickle, orbax or ml_dtypes."""
    blocked = ("jax", "horovod_tpu", "cloudpickle", "orbax", "ml_dtypes")
    block = ("import sys\n"
             f"for m in {blocked!r}:\n"
             "    sys.modules[m] = None\n")
    worker = block + RANK_SIZE.replace("; ", "\n")
    cmd = [sys.executable, "-I", "-c",
           block + "import runpy, sys\n"
           f"sys.path.insert(0, {str(REPO)!r})\n"
           "sys.argv = ['hvdrun', '-np', '2', sys.executable, '-I', '-c', "
           f"{('import sys; sys.path.insert(0, ' + repr(str(REPO)) + ')' + chr(10) + worker)!r}]\n"
           "runpy.run_module('horovod_tpu_torch.run', run_name='__main__')"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                         env={**os.environ, **_env()}, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = sorted(ln for ln in out.stdout.splitlines() if "RS" in ln)
    assert lines == ["[0]RS 0 2", "[1]RS 1 2"]


@pytest.mark.parametrize("env,want", [
    ({"HVDTPU_ELASTIC_RANK": "3", "HVDTPU_LOCAL_RANK": "3"}, 1),
    ({"HVDTPU_ELASTIC_RANK": "0", "HVDTPU_LOCAL_RANK": "0"}, 0),
    ({"HVDTPU_ELASTIC_RANK": "1"}, 0),
    # a static world of the launcher: cuda:local_rank
    ({"HVDTPU_SIZE": "4", "HVDTPU_LOCAL_RANK": "1"}, 1),
])
def test_an_elastic_worker_takes_its_slots_gpu(env, want, monkeypatch):
    """Elastic workers run worlds of one of their own: each takes the GPU
    of its launcher slot (``HVDTPU_LOCAL_RANK``), round-robin over the
    host's GPUs (two here)."""
    import torch

    from horovod_tpu_torch import basics

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    local = int(env.get("HVDTPU_LOCAL_RANK", 0)) if "HVDTPU_SIZE" in env \
        else 0
    assert basics._resolve_device(None, local, env) == \
        torch.device("cuda", want)


ELASTIC_WORKER = '''
import json, sys
for m in ("jax", "horovod_tpu", "cloudpickle", "orbax", "ml_dtypes"):
    sys.modules[m] = None
sys.path.insert(0, {repo!r})
import numpy as np
import horovod_tpu_torch.elastic as elastic

ctx = elastic.context()
state = elastic.State(w=np.zeros(8), step=0)


@elastic.run
def loop(state):
    while state.step < 8:
        grad = np.full(8, float(state.step + 1) * (ctx.rank + 1))
        state.w = state.w - 0.01 * ctx.allreduce(grad, name=f"g{{state.step}}")
        state.step += 1
        state.commit()
    return float(state.w[0]), state.step


print("RESULT", json.dumps([ctx.rank, *loop(state)]), flush=True)
'''


def test_cli_elastic_recovers_a_killed_rank(tmp_path):
    """``python -m horovod_tpu_torch.run --elastic -np 2 python worker.py``
    (command mode, no cloudpickle anywhere): rank 1 is killed at its 3rd
    collective, the launcher respawns it, and both ranks end with the
    toy loop's state of a clean run."""
    worker = tmp_path / "worker.py"
    worker.write_text(ELASTIC_WORKER.format(repo=str(REPO)))
    blocked = ("jax", "horovod_tpu", "cloudpickle", "orbax", "ml_dtypes")
    launcher = ("import runpy, sys\n"
                f"for m in {blocked!r}:\n"
                "    sys.modules[m] = None\n"
                f"sys.path.insert(0, {str(REPO)!r})\n"
                "sys.argv = ['hvdrun', '--elastic', '-np', '2', "
                f"sys.executable, '-I', {str(worker)!r}]\n"
                "runpy.run_module('horovod_tpu_torch.run', "
                "run_name='__main__')")
    env = {**os.environ, **_env(),
           "HVDTPU_FAULT_SPEC": "worker_exit:step=3:rank=1"}
    out = subprocess.run([sys.executable, "-I", "-c", launcher],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    results = sorted(json.loads(ln.split("RESULT ", 1)[1])
                     for ln in out.stdout.splitlines() if "RESULT" in ln)
    # the clean run's w[0]: -0.01 * mean(1, 2) * (1 + ... + 8)
    assert results == [[0, pytest.approx(-0.54), 8],
                       [1, pytest.approx(-0.54), 8]]
    assert results[0][1] == results[1][1]
    assert "respawned rank 1" in out.stderr
