"""The port's function-shipping API (horovod_tpu_torch.run.run, its
``_pickle_func`` and the worker ``run/task_fn.py``) against the
reference's (horovod_tpu.run.api), on the CPU.

* ``run(fn, np=2)`` returns the per-rank results in rank order; a
  function of plain numpy sees the same launcher environment (rank,
  size, local and cross coordinates) under both packages' ``run``; a
  gloo world opened by ``init(device="cpu")`` reduces as the reference's
  2-process world does (tests/test_multiprocess.py's cases).
* ``_pickle_func`` writes the reference's bytes where cloudpickle is
  installed (a test file's function by value, a package's by reference);
  with cloudpickle blocked, a function of an importable module travels
  by reference through ``pickle`` and one that must travel by value
  raises an ``ImportError`` naming cloudpickle.
* A worker's exception and the ``task_fn`` fault point surface as the
  reference's do.
Tolerance: exact.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import horovod_tpu.run.api as japi
from horovod_tpu_torch.run import api, run

REPO = Path(__file__).resolve().parent.parent
ENV = {"PYTHONPATH": os.pathsep.join([str(REPO), str(REPO / "tests")])}


def _env_fn(scale):
    import os

    keys = ("HVDTPU_RANK", "HVDTPU_SIZE", "HVDTPU_LOCAL_RANK",
            "HVDTPU_LOCAL_SIZE", "HVDTPU_CROSS_RANK", "HVDTPU_CROSS_SIZE")
    return {"env": {k: os.environ.get(k) for k in keys},
            "scaled": [scale * (int(os.environ["HVDTPU_RANK"]) + 1)]}


def test_run_gives_the_references_launcher_contract():
    got = run(_env_fn, (2.5,), np=2, use_cpu=True, timeout=120, env=ENV)
    want = japi.run(_env_fn, (2.5,), np=2, use_cpu=True, timeout=180,
                    env=ENV)
    assert got == want
    assert [r["env"]["HVDTPU_RANK"] for r in got] == ["0", "1"]
    assert [r["scaled"] for r in got] == [[2.5], [5.0]]


def _world_fn():
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    r = hvd.rank()
    x = torch.full((4,), float(r + 1))
    out = {
        "rank": r, "size": hvd.size(),
        "allreduce_sum": hvd.allreduce(x, op=hvd.Sum).tolist(),
        "allreduce_avg": hvd.allreduce(x, op=hvd.Average).tolist(),
        "allgather": hvd.allgather(
            torch.full((r + 1, 2), float(r))).tolist(),
        "broadcast": hvd.broadcast(torch.tensor([100.0 * (r + 1)]),
                                   root_rank=1).tolist(),
    }
    hvd.shutdown()
    return out


def test_run_returns_per_rank_results_of_a_gloo_world():
    results = run(_world_fn, np=2, use_cpu=True, timeout=120, env=ENV)
    assert [r["rank"] for r in results] == [0, 1]
    for r in results:
        # tests/test_multiprocess.py's expectations of the same collectives
        assert r["size"] == 2
        assert r["allreduce_sum"] == [3.0] * 4
        assert r["allreduce_avg"] == [1.5] * 4
        assert r["allgather"] == [[0.0, 0.0], [1.0, 1.0], [1.0, 1.0]]
        assert r["broadcast"] == [200.0]


def _raising_fn():
    raise ValueError("bad learning rate 42")


def test_worker_exception_traceback_surfaces():
    with pytest.raises(RuntimeError, match="bad learning rate 42"):
        run(_raising_fn, np=2, use_cpu=True, timeout=120, env=ENV)


def test_task_fn_fault_point_fails_the_job():
    with pytest.raises(RuntimeError):
        run(_env_fn, (1.0,), np=2, use_cpu=True, timeout=120,
            env=dict(ENV, HVDTPU_FAULT_SPEC="task_fn:rank=1"))


@pytest.mark.parametrize("fn,args", [
    (_env_fn, (1.0,)),                    # a test file's: by value
    (np.linalg.norm, ([3.0, 4.0],)),      # a package's: by reference
    (os.path.join, ("a", "b")),           # the standard library's
])
def test_pickle_func_writes_the_references_bytes(fn, args):
    assert api._pickle_func(fn, args, {"k": 1}) == \
        japi._pickle_func(fn, args, {"k": 1})


_BLOCKED = textwrap.dedent("""
    import json, os, pickle, sys
    sys.modules["cloudpickle"] = None
    sys.path.insert(0, {repo!r})
    from horovod_tpu_torch.run import api
    from horovod_tpu_torch.serve.service import DEFAULT_SPEC, serve_worker
    out = {{}}
    blob = api._pickle_func(serve_worker, (DEFAULT_SPEC,), {{}})
    fn, args, _ = pickle.loads(blob)
    out["by_reference"] = fn is serve_worker and args == (DEFAULT_SPEC,)
    def outer():
        def inner():
            return 2
        return inner
    for name, f in (("lambda", lambda: 1), ("closure", outer())):
        try:
            api._pickle_func(f, (), {{}})
            out[name] = "pickled"
        except ImportError as exc:
            out[name] = str(exc)
    def in_main():
        return 3
    in_main.__module__ = "__main__"
    try:
        api._pickle_func(in_main, (), {{}})
        out["__main__"] = "pickled"
    except ImportError as exc:
        out["__main__"] = str(exc)
    out["results"] = api.run(os.getcwd, np=2, use_cpu=True, timeout=120,
                             env={{"PYTHONPATH": {repo!r}}})
    print(json.dumps(out))
""")


def test_without_cloudpickle_a_function_travels_by_reference():
    """The card's machine may lack cloudpickle: ``ServeJob``'s
    ``serve_worker`` and any importable function still ship (by
    reference, through pickle), and ``run`` works end to end; what must
    travel by value names cloudpickle."""
    import json

    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED.format(repo=str(REPO))],
        capture_output=True, text=True, timeout=180, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["by_reference"] is True
    for key in ("lambda", "closure", "__main__"):
        assert "cloudpickle" in res[key], res[key]
    assert res["results"] == [str(REPO)] * 2
