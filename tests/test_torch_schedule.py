"""The port's schedule gate (``horovod_tpu_torch.analysis.schedule``, fed by
``obs.collective_schedule.dump_collective_schedule``), the counterpart of
the reference's HLO gate (``horovod_tpu.analysis.hlo``).

* A 2-rank gloo world runs gpt-nano ``bucket`` steps with torch's flight
  recorder on; both ranks' dumps agree (the CLI exits 0), each step's
  slice issues one ``all_reduce`` per bucket plus the loss's.  The same
  world with rank 1 issuing one extra ``all_reduce`` under a rank guard
  diverges (exit 1) at the position of the extra collective.  Bad
  arguments exit 2.
* ``diff_schedules`` gives the reference's verdict on the same sequences,
  each collective mapped to the reference's opcode.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from _torch_world import run_world, schedule_worker
from horovod_tpu.analysis import hlo
from horovod_tpu_torch.analysis import schedule
from horovod_tpu_torch.obs import collective_schedule

REPO = Path(__file__).resolve().parent.parent
STEPS = 2


def _cli(*args, cwd=None):
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.analysis.schedule", *args],
        capture_output=True, text=True, timeout=120, cwd=cwd,
        env={**os.environ, "PYTHONPATH": str(REPO) + os.pathsep
             + os.environ.get("PYTHONPATH", "")})


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Two 2-rank worlds with the recorder on: ``clean`` and ``extra``
    (rank 1 issues one more all_reduce)."""
    mp = pytest.MonkeyPatch()
    for k, v in collective_schedule.recorder_env(5000).items():
        mp.setenv(k, v)   # the spawned ranks inherit it before init
    try:
        out = {}
        for name, extra in (("clean", None), ("extra", 1)):
            d = tmp_path_factory.mktemp(f"sched_{name}")
            out[name] = (d, run_world(schedule_worker, (str(d), STEPS, extra),
                                      timeout=120))
        yield out
    finally:
        mp.undo()


def _load(d, rank):
    return schedule.extract_schedule((d / f"rank{rank}.json").read_text(),
                                     label=f"rank{rank}")


def test_ranks_agree_and_each_step_reduces_every_bucket(worlds):
    d, results = worlds["clean"]
    (buckets, n0), (_, n1) = results
    assert n0 == n1 > 0
    r = _cli(f"rank0={d}/rank0.json", f"rank1={d}/rank1.json",
             "--expect-collectives", "1")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "2 schedule(s) identical" in r.stdout
    s = _load(d, 0)
    assert not s.truncated and not s.p2p
    reduces = [i for i in s.instrs if i.kind == "all_reduce"]
    # one all_reduce per bucket and the loss's mean, every step
    assert len(reduces) == STEPS * (buckets + 1)
    per_step = len(reduces) // STEPS
    slices = [schedule.CollectiveSchedule(f"step{k}",
                                          reduces[k * per_step:
                                                  (k + 1) * per_step])
              for k in range(STEPS)]
    assert schedule.diff_schedules(slices) == []
    assert sum(i.elements == 1 for i in slices[0].instrs) >= 1


def test_extra_collective_on_one_rank_diverges_at_its_position(worlds):
    d, _ = worlds["extra"]
    r0, r1 = _load(d, 0), _load(d, 1)
    extra = [k for k, i in enumerate(r1.instrs)
             if i.group != r1.instrs[0].group]
    assert len(extra) == 1 and len(r1.instrs) == len(r0.instrs) + 1
    r = _cli(f"rank0={d}/rank0.json", f"rank1={d}/rank1.json")
    assert r.returncode == 1, r.stdout + r.stderr
    assert f"rank1: collective #{extra[0]} diverges" in r.stdout
    assert "HOW MANY" in r.stdout


def _main(*args) -> int:
    """The CLI's entry point in this process (argparse's errors exit)."""
    try:
        return schedule.main(list(args))
    except SystemExit as e:
        return e.code


def test_cli_usage_errors_exit_2(worlds, tmp_path):
    d, _ = worlds["clean"]
    assert _cli().returncode == 2
    assert _main(f"rank0={d}/rank0.json", str(tmp_path / "nope.json")) == 2
    (tmp_path / "text.json").write_text("not json")
    (tmp_path / "other.json").write_text(json.dumps({"version": "2.10"}))
    for bad in ("text.json", "other.json"):
        assert _main(f"rank0={d}/rank0.json", str(tmp_path / bad)) == 2, bad
    assert _main(f"{d}/rank0.json", "--format", "yaml") == 2


def test_cli_json_format_and_expect_collectives(worlds, tmp_path, capsys):
    d, _ = worlds["clean"]
    assert _main(f"{d}/rank0.json", "--format", "json") == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["schema"] == schedule.SCHEDULE_SCHEMA
    assert doc["divergences"] == []
    assert {"kind", "dtype", "shape", "elements", "bytes", "group",
            "position", "record", "p2p"} <= set(
                doc["schedules"][0]["collectives"][0])
    (tmp_path / "empty.json").write_text(json.dumps({"entries": []}))
    assert _main(str(tmp_path / "empty.json"), "--expect-collectives",
                 "1") == 1
    assert "expected >= 1" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# extraction and the differ on synthetic dumps
# ---------------------------------------------------------------------------

_OPCODE = {"all_reduce": "all-reduce", "all_gather": "all-gather",
           "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
           "broadcast": "collective-broadcast"}
_DTYPE = {"Float": ("f32", 4), "BFloat16": ("bf16", 2), "Long": ("s64", 8)}
_GROUPS = {"0:default_pg": "{{0,1}}", "1:hvd_local": "{{0},{1}}"}


def _fr(seq, backend="nccl"):
    """A flight-recorder dump of ``seq``: (kind, elements, dtype, group)."""
    seqs, entries = {}, []
    for k, (kind, n, dtype, group) in enumerate(seq):
        pg_id, desc = group.split(":")
        seqs[group] = seqs.get(group, 0) + 1
        entries.append({
            "record_id": k, "pg_id": int(pg_id), "process_group":
            [pg_id, desc], "collective_seq_id": seqs[group],
            "p2p_seq_id": 0, "op_id": seqs[group],
            "profiling_name": f"{backend}:{kind}", "is_p2p": False,
            "input_sizes": [[n]], "input_dtypes": [dtype],
            "output_sizes": [[n]], "output_dtypes": [dtype],
            "state": "completed", "retired": True})
    return {"version": "2.10", "pg_config": {}, "entries": entries}


def _hlo(seq):
    """The same sequence as a scheduled HLO module of the reference."""
    lines = ["HloModule step, is_scheduled=true", "",
             "ENTRY %main (p0: f32[8]) -> f32[8] {"]
    for k, (kind, n, dtype, group) in enumerate(seq):
        t = _DTYPE[dtype][0]
        lines.append(f"  %c{k} = {t}[{n}]{{0}} {_OPCODE[kind]}({t}[{n}]{{0}} "
                     f"%p0), replica_groups={_GROUPS[group]}, to_apply=%add")
    lines.append("}")
    return "\n".join(lines)


A = [("all_reduce", 1024, "Float", "0:default_pg"),
     ("all_gather", 64, "BFloat16", "0:default_pg"),
     ("all_reduce", 8, "Float", "1:hvd_local"),
     ("broadcast", 16, "Long", "0:default_pg"),
     ("reduce_scatter", 256, "Float", "0:default_pg")]
SCENARIOS = {
    "identical": [A, list(A)],
    "swapped": [A, [A[1], A[0]] + A[2:]],
    "extra_at_end": [A, A + [("all_reduce", 1, "Float", "0:default_pg")]],
    "extra_in_middle": [A, A[:2] + [("all_to_all", 4, "Float",
                                     "0:default_pg")] + A[2:]],
    "missing_one": [A, A[:3] + A[4:]],
    "other_size": [A, A[:3] + [("broadcast", 32, "Long", "0:default_pg")]
                   + A[4:]],
    "other_dtype": [A, [("all_reduce", 1024, "BFloat16", "0:default_pg")]
                    + A[1:]],
    "other_group": [A, A[:2] + [("all_reduce", 8, "Float", "0:default_pg")]
                    + A[3:]],
    "third_rank_diverges": [A, list(A), A[:4]],
}


def _verdict(problems):
    return [("HOW MANY" in p, re.findall(r"collective #(\d+) diverges", p))
            for p in problems]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_diff_gives_the_references_verdict(name):
    seqs = SCENARIOS[name]
    port = schedule.diff_schedules([
        schedule.extract_schedule(json.dumps(_fr(s)), f"rank{r}")
        for r, s in enumerate(seqs)])
    ref = hlo.diff_schedules([hlo.extract_schedule(_hlo(s), f"rank{r}")
                              for r, s in enumerate(seqs)])
    assert _verdict(port) == _verdict(ref)
    assert (port == []) == (name == "identical")


def test_extract_strips_the_backend_and_counts_bytes():
    s = schedule.extract_schedule(_fr(A, backend="gloo"), "r")
    assert [i.kind for i in s.instrs] == [k for k, *_ in A]
    assert s.instrs[1].elements == 64 and s.instrs[1].nbytes == 128
    assert s.instrs[2].group == "1:hvd_local" and s.instrs[2].position == 1
    assert s.total_bytes == 4096 + 128 + 32 + 128 + 1024
    assert s.signatures() == schedule.extract_schedule(
        _fr(A, backend="nccl"), "r").signatures()


def test_p2p_is_kept_apart_and_a_wrapped_ring_is_flagged():
    doc = _fr(A)
    doc["entries"].insert(2, {
        "record_id": 100, "pg_id": 0, "process_group": ["0", "default_pg"],
        "collective_seq_id": 0, "p2p_seq_id": 1, "is_p2p": True,
        "profiling_name": "nccl:send 0->1", "input_sizes": [[4]],
        "input_dtypes": ["Float"], "output_sizes": [[4]],
        "output_dtypes": ["Float"]})
    s = schedule.extract_schedule(doc)
    assert len(s.instrs) == len(A) and len(s.p2p) == 1
    assert s.p2p[0].kind == "send 0->1" and not s.truncated
    assert schedule.diff_schedules([s, schedule.extract_schedule(
        _fr(A))]) == []
    wrapped = _fr(A)
    wrapped["entries"] = wrapped["entries"][1:]
    assert schedule.extract_schedule(wrapped).truncated


def test_since_slices_a_later_dump():
    full = schedule.extract_schedule(_fr(A + A))
    first = schedule.extract_schedule(_fr(A))
    step2 = full.since(first, "step2")
    assert len(step2.instrs) == len(A)
    assert schedule.diff_schedules([first, step2]) == []


def test_producer_refuses_an_empty_or_unarmed_recorder(monkeypatch):
    for name in collective_schedule.RECORDER_ENV:
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="flight recorder is off"):
        collective_schedule.dump_collective_schedule("unused.json")
    monkeypatch.setenv(collective_schedule.RECORDER_ENV[0], "100")
    # this process created no process group: nothing was recorded
    with pytest.raises(RuntimeError, match="holds no collective"):
        collective_schedule.dump_collective_schedule("unused.json")
    assert not os.path.exists("unused.json")
