"""The port's cluster integration (horovod_tpu_torch.cluster) and NIC
discovery (run/driver_service.py, ``hvdrun --discover-nics``) against the
reference's, on the CPU.

* ``assign_ranks`` gives the reference's slots (host-hash grouping, the
  barrel shift that puts task 0's host first) on seeded random maps.
* ``run_on_cluster`` with the local executor runs the whole protocol —
  register, ranks, function shipping, the ``torch.distributed`` world on
  the coordinator rank 0's task publishes, results in rank order — and a
  task's exception surfaces.
* The driver service's signed frames and probes interoperate with the
  reference's on loopback: a port client against a reference task server
  and the reverse give the same answers, and ``discover_common_interfaces``
  / ``discover_nics`` find what the reference's find.
Tolerance: exact.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import horovod_tpu.cluster as jcluster
import horovod_tpu.run.driver_service as jds
from horovod_tpu_torch import cluster
from horovod_tpu_torch.cluster import (assign_ranks, local_executor,
                                       run_on_cluster)
from horovod_tpu_torch.run import driver_service as ds

REPO = Path(__file__).resolve().parent.parent
ENV = {"PYTHONPATH": os.pathsep.join([str(REPO), str(REPO / "tests")])}


@pytest.mark.parametrize("seed", range(6))
def test_assign_ranks_is_the_references(seed):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(1, 12))
    hosts = [f"host{c}" for c in "ABCDE"[:int(rng.randint(1, 5))]]
    task_hosts = {i: hosts[rng.randint(len(hosts))] for i in range(n)}
    got = assign_ranks(task_hosts)
    assert got == jcluster.assign_ranks(task_hosts)
    assert sorted(s["rank"] for s in got) == list(range(n))
    assert got[0]["rank"] == 0 and got[0]["cross_rank"] == 0


def test_assign_ranks_barrel_shift():
    slots = assign_ranks({0: "hostB", 1: "hostA", 2: "hostB", 3: "hostA"})
    assert [s["rank"] for s in slots] == [0, 2, 1, 3]
    assert all(s["local_size"] == 2 and s["cross_size"] == 2 for s in slots)


def _cluster_fn(scale):
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    r = hvd.rank()
    out = hvd.allreduce(torch.full((3,), float(r + 1) * scale), op=hvd.Sum)
    res = {"rank": r, "size": hvd.size(), "local_rank": hvd.local_rank(),
           "cross_size": hvd.cross_size(), "sum": out.tolist()}
    hvd.shutdown()
    return res


def test_run_on_cluster_local_executor():
    results = run_on_cluster(_cluster_fn, (10.0,), num_proc=2,
                             executor=local_executor(ENV),
                             start_timeout=120, job_timeout=120)
    assert [r["rank"] for r in results] == [0, 1]
    assert all(r["size"] == 2 and r["cross_size"] == 1 for r in results)
    assert sorted(r["local_rank"] for r in results) == [0, 1]
    for r in results:
        assert r["sum"] == [30.0, 30.0, 30.0]  # 10 + 20


def _boom():
    raise ValueError("cluster task exploded")


def test_run_on_cluster_task_failure_propagates():
    with pytest.raises(RuntimeError, match="cluster task exploded"):
        run_on_cluster(_boom, num_proc=2, executor=local_executor(ENV),
                       start_timeout=120, job_timeout=120)


def test_spark_executor_without_pyspark_says_so():
    import builtins

    real = builtins.__import__

    def no_pyspark(name, *args, **kwargs):
        if name == "pyspark":
            raise ImportError("no pyspark")
        return real(name, *args, **kwargs)

    builtins.__import__ = no_pyspark
    try:
        with pytest.raises(RuntimeError, match="requires pyspark"):
            cluster.spark_executor()(1, "127.0.0.1:1", "s")
    finally:
        builtins.__import__ = real


@pytest.mark.parametrize("server_pkg,client_pkg", [(ds, jds), (jds, ds)],
                         ids=["port_server", "jax_server"])
def test_driver_service_wire_matches_the_reference(server_pkg, client_pkg):
    key = ds.make_secret()
    srv = server_pkg.TaskServer(key)
    try:
        out = client_pkg.probe("127.0.0.1", srv.port, key,
                               {"op": "addresses"})
        assert out["addresses"] == ds.local_addresses() == \
            jds.local_addresses()
        import socket

        dead = socket.socket()
        dead.bind(("127.0.0.1", 0))
        dead_port = dead.getsockname()[1]
        dead.close()
        out = client_pkg.probe(
            "127.0.0.1", srv.port, key,
            {"op": "probe", "candidates": [
                ["ifup", "127.0.0.1", srv.port],
                ["ifdown", "127.0.0.1", dead_port]]})
        assert out["reachable"] == ["ifup"]
        with pytest.raises((ValueError, OSError)):
            client_pkg.probe("127.0.0.1", srv.port, "attacker-key",
                             {"op": "addresses"}, timeout=3)
    finally:
        srv.close()
    msg = ds._pack(key, {"op": "addresses"})
    assert msg == jds._pack(key, {"op": "addresses"})
    with pytest.raises(ValueError, match="signature"):
        ds._unpack("wrong-key", msg)


def test_discover_common_interfaces_as_the_reference():
    key = ds.make_secret()
    a, b = ds.TaskServer(key), jds.TaskServer(key)
    try:
        tasks = [("127.0.0.1", a.port), ("127.0.0.1", b.port)]
        got = ds.discover_common_interfaces(tasks, key)
        assert got == jds.discover_common_interfaces(tasks, key)
        assert got == sorted(ds.local_addresses())
        assert ds.discover_common_interfaces(tasks[:1], key) == got
    finally:
        a.close()
        b.close()
    assert ds.discover_common_interfaces([], key) == \
        jds.discover_common_interfaces([], key)


def test_hvdrun_discover_nics_runs():
    from horovod_tpu_torch.run.runner import discover_nics

    assert discover_nics(hosts="localhost:1,localhost:1") == \
        sorted(ds.local_addresses())
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "--discover-nics"],
        capture_output=True, text=True, timeout=60, cwd=str(REPO),
        env={**os.environ, **ENV})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == sorted(ds.local_addresses())
