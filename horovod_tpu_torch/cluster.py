"""Cluster-manager integration: run a horovod_tpu_torch job inside task
slots a cluster scheduler already allocated (a port of
``horovod_tpu/cluster.py``).

Reference: ``horovod.spark.run`` (horovod/spark/runner.py:100-189) — one
Horovod process per Spark task: a driver service waits for every task to
register, assigns ranks grouped by host hash (barrel-shifted so rank 0
lands on the first host), ships the pickled function to each task, and
collects per-rank results.

The driver is this package's HMAC-signed HTTP KV store (the same
rendezvous the launcher uses, run/rendezvous.py ≙ the reference's
RendezvousServer).  The task assigned rank 0 picks the address of the
``torch.distributed`` store and publishes it through the driver's KV
store; every task gets it as ``HVDTPU_COORDINATOR`` with its rank, so the
function's ``horovod_tpu_torch.init()`` opens the world there (NCCL on
each task's GPU, gloo with ``init(device="cpu")``).  The cluster manager
only has to run ``task_main(index, driver, secret)`` in each of its task
slots — adapters:

* :func:`local_executor` — subprocess slots on this machine (the test
  topology, and a correctness reference for any adapter).
* :func:`spark_executor` — one task per Spark partition, exactly the
  reference's ``_make_spark_thread`` shape (imports pyspark lazily).

Any other scheduler (k8s indexed Jobs, Slurm steps, Ray actors) integrates
by invoking ``python -m horovod_tpu_torch.cluster --task <i> --driver
<addr> --secret <key>`` in each slot.  The function travels as
``run/api.py``'s ``_pickle_func`` ships it (cloudpickle only where it
must travel by value).
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from .run.allocate import routable_ip
from .run.rendezvous import KVStoreClient, KVStoreServer, make_secret

START_TIMEOUT_DEFAULT = 600.0


# ---------------------------------------------------------------------------
# rank assignment (reference spark/runner.py:186-205: host-hash grouping +
# barrel shift so index 0's host holds rank 0)
# ---------------------------------------------------------------------------


def assign_ranks(task_hosts: Dict[int, str]) -> List[dict]:
    """task index -> host hash, to per-task slot dicts (rank, local_rank,
    local_size, cross_rank, cross_size, size)."""
    by_host: Dict[str, List[int]] = {}
    for idx in sorted(task_hosts):
        by_host.setdefault(task_hosts[idx], []).append(idx)
    hosts = sorted(by_host)
    # Barrel shift until task index 0 is in the first host.
    first = task_hosts[0]
    while hosts[0] != first:
        hosts = hosts[1:] + hosts[:1]
    slots = [None] * len(task_hosts)
    rank = 0
    for cross_rank, h in enumerate(hosts):
        for local_rank, idx in enumerate(by_host[h]):
            slots[idx] = {
                "rank": rank,
                "local_rank": local_rank,
                "local_size": len(by_host[h]),
                "cross_rank": cross_rank,
                "cross_size": len(hosts),
                "size": len(task_hosts),
            }
            rank += 1
    return slots


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def run_on_cluster(
    fn: Callable,
    args: tuple = (),
    kwargs: Optional[dict] = None,
    *,
    num_proc: int,
    executor: Callable[[int, str, str], object],
    start_timeout: float = START_TIMEOUT_DEFAULT,
    job_timeout: Optional[float] = None,
    env: Optional[Dict[str, str]] = None,
    driver_host: Optional[str] = None,
    min_workers: Optional[int] = None,
    max_retries: int = 0,
):
    """Run ``fn`` as a ``num_proc``-rank horovod_tpu_torch job inside cluster
    task slots; returns the per-rank results in rank order (reference
    horovod.spark.run contract).

    ``start_timeout`` bounds task START-UP (scheduling + registration —
    the reference's start_timeout semantics, spark/runner.py); the
    training function itself may run as long as it likes unless
    ``job_timeout`` is set.  ``driver_host`` overrides the advertised
    driver address for networks where the outbound-interface probe picks
    the wrong NIC.

    Elastic knobs (matching the launcher's, run/runner.py):
    ``min_workers`` — when the registration deadline passes with at
    least this many tasks checked in, the job proceeds with the reduced
    world instead of failing start-up (unregistered slots are released
    with a ``None`` rank assignment); default ``None`` keeps the strict
    all-``num_proc`` contract.  ``max_retries`` — re-run the whole
    attempt (fresh rendezvous + executor invocation) up to this many
    times when a task fails; default 0 keeps fail-fast.

    ``executor(num_tasks, driver_addr, secret)`` must arrange for
    :func:`task_main`-equivalent execution in each slot; returning an
    object with ``failed()`` / ``join()`` / ``terminate()`` gives the
    driver fast failure detection and cleanup.
    """
    attempts = 0
    while True:
        try:
            return _run_cluster_attempt(
                fn, args, kwargs,
                num_proc=num_proc, executor=executor,
                start_timeout=start_timeout, job_timeout=job_timeout,
                env=env, driver_host=driver_host,
                min_workers=min_workers,
            )
        except (RuntimeError, TimeoutError) as exc:
            attempts += 1
            if attempts > max_retries:
                raise
            print(
                f"horovod_tpu_torch.cluster: attempt {attempts} failed "
                f"({exc}); retrying ({max_retries - attempts + 1} "
                f"retries left)",
                file=sys.stderr,
            )


def _run_cluster_attempt(
    fn: Callable,
    args: tuple,
    kwargs: Optional[dict],
    *,
    num_proc: int,
    executor: Callable[[int, str, str], object],
    start_timeout: float,
    job_timeout: Optional[float],
    env: Optional[Dict[str, str]],
    driver_host: Optional[str],
    min_workers: Optional[int],
):
    """One rendezvous + execution attempt (the pre-elastic
    run_on_cluster body)."""
    # Bind every interface and advertise the outbound-interface address:
    # task slots generally live on OTHER hosts (same logic as the
    # launcher's KV server, run/api.py bind_all=not all_local; the probe
    # address is never contacted — routable_ip uses a connected UDP
    # socket only to pick the interface).
    server = KVStoreServer(secret=(secret := make_secret()), bind_all=True)
    port = server.start()
    advertised = f"{driver_host or routable_ip('192.0.2.1')}:{port}"
    from .run.api import _pickle_func  # noqa: PLC0415

    kv = KVStoreClient(f"127.0.0.1:{port}", secret)
    kv.put("job", "program", _pickle_func(fn, args, kwargs or {}))
    kv.put("job", "env", pickle.dumps(env or {}))

    handle = executor(num_proc, advertised, secret)

    def posted_failure():
        """A task that raised posts its traceback BEFORE exiting; that
        diagnostic must win over the generic died-without-result error."""
        for j in range(num_proc):
            raw = kv.get("result", str(j))
            if raw is not None:
                ok, value = pickle.loads(raw)
                if not ok:
                    return j, value
        return None

    def check_executor_failure(what: str) -> None:
        """Fail the job promptly when a slot died: surface its posted
        traceback when one exists, else a generic death notice."""
        failed = getattr(handle, "failed", None)
        if failed is None or not failed():
            return
        post = posted_failure()
        if post is not None:
            j, tb = post
            raise RuntimeError(f"cluster task {j} raised:\n{tb}")
        raise RuntimeError(
            f"a cluster task died during {what} without reporting "
            "a result (see its slot's logs)"
        )

    def wait_kv(scope: str, key: str, deadline, what: str) -> bytes:
        """Poll the KV in short slices, interleaving executor-death checks
        so a crashed slot fails the job promptly instead of burning the
        whole timeout."""
        while True:
            try:
                return kv.wait(scope, key, timeout=5.0)
            except TimeoutError:
                pass
            check_executor_failure(what)
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"cluster {what} timed out waiting for {scope}/{key}"
                )

    try:
        # 1. registration (reference: driver.task_host_hash_indices).
        # With min_workers set, a deadline pass with at least that many
        # registrants proceeds on the reduced world (the cluster-level
        # analog of the elastic launcher's shrink path) instead of
        # failing start-up on stragglers the scheduler never placed.
        start_deadline = time.monotonic() + start_timeout
        task_hosts: Dict[int, str] = {}
        pending = set(range(num_proc))
        while pending:
            # Block server-side on ONE representative key (so the common
            # fast path has sub-second latency without hammering the
            # single-threaded KV store at poll rate), then sweep the
            # rest with cheap gets once per wakeup.
            probe = min(pending)
            try:
                raw = kv.wait("register", str(probe), timeout=1.0)
                task_hosts[probe] = pickle.loads(raw)["host_hash"]
            except TimeoutError:
                pass
            for i in sorted(pending - set(task_hosts)):
                raw = kv.get("register", str(i))
                if raw is not None:
                    task_hosts[i] = pickle.loads(raw)["host_hash"]
            pending -= set(task_hosts)
            if not pending:
                break
            check_executor_failure("start-up")
            if time.monotonic() > start_deadline:
                if (min_workers is not None
                        and len(task_hosts) >= min_workers):
                    break
                raise TimeoutError(
                    f"cluster start-up timed out with "
                    f"{len(task_hosts)}/{num_proc} tasks registered"
                    + (f" (min_workers={min_workers})"
                       if min_workers is not None else "")
                )
        # 2. rank assignment, published per task.  assign_ranks wants
        # dense indexes, so a reduced world is densified first; slots
        # that never registered get an explicit None so a late-arriving
        # task releases its slot cleanly instead of hanging on the key.
        registered = sorted(task_hosts)
        dense = assign_ranks(
            {pos: task_hosts[i] for pos, i in enumerate(registered)}
        )
        slots = {i: dense[pos] for pos, i in enumerate(registered)}
        for i in range(num_proc):
            kv.put("slot", str(i), pickle.dumps(slots.get(i)))
        # 3. results, in rank order (bounded only by job_timeout; a task
        # that died without posting is detected through the executor
        # handle rather than a timeout)
        job_deadline = (
            time.monotonic() + job_timeout if job_timeout else None
        )
        results = [None] * len(registered)
        for i in registered:
            ok, value = pickle.loads(
                wait_kv("result", str(i), job_deadline, "job")
            )
            if not ok:
                raise RuntimeError(
                    f"cluster task {i} (rank {slots[i]['rank']}) raised:\n"
                    f"{value}"
                )
            results[slots[i]["rank"]] = pickle.loads(value)
    except BaseException:
        # Error path: peers may be blocked mid-negotiation on the dead
        # rank — tear the slots down rather than joining forever.
        terminate = getattr(handle, "terminate", None)
        if terminate is not None:
            try:
                terminate()
            except Exception:
                pass
        raise
    finally:
        joiner = getattr(handle, "join", None)
        if joiner is not None:
            try:
                joiner()
            except Exception:
                pass
        server.stop()
    return results


# ---------------------------------------------------------------------------
# task side
# ---------------------------------------------------------------------------


def task_main(index: int, driver_addr: str, secret: str) -> None:
    """Body of one cluster task slot: register, learn the rank and the
    ``torch.distributed`` coordinator, run the user function, report the
    result (reference horovod/spark/task/__init__.py + task_service)."""
    kv = KVStoreClient(driver_addr, secret)
    try:
        kv.put(
            "register", str(index),
            pickle.dumps({"host_hash": socket.gethostname(),
                          "pid": os.getpid()}),
        )
        slot = pickle.loads(kv.wait("slot", str(index), timeout=600))
        if slot is None:
            # Reduced world (driver proceeded with min_workers before
            # this task registered): release the slot without error so
            # the executor's handle never reads it as a failure.
            kv.put("result", str(index), pickle.dumps((True, pickle.dumps(None))))
            return
        extra_env = pickle.loads(kv.wait("job", "env", timeout=60))
        os.environ.update(extra_env)
        os.environ.update({
            "HVDTPU_RANK": str(slot["rank"]),
            "HVDTPU_SIZE": str(slot["size"]),
            "HVDTPU_LOCAL_RANK": str(slot["local_rank"]),
            "HVDTPU_LOCAL_SIZE": str(slot["local_size"]),
            "HVDTPU_CROSS_RANK": str(slot["cross_rank"]),
            "HVDTPU_CROSS_SIZE": str(slot["cross_size"]),
        })
        # rank 0 hosts the torch.distributed store; everyone else learns
        # its address through the driver KV (≙ the reference's
        # task-to-task address registration, spark/runner.py:193-199).
        # The reserving socket stays OPEN (SO_REUSEADDR) until just before
        # the user fn runs, shrinking the port-reuse window to the init
        # prologue rather than the whole fan-out of the address.
        reserve = None
        if slot["rank"] == 0:
            reserve = socket.socket()
            reserve.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            reserve.bind(("", 0))
            coord = f"{routable_ip(driver_addr.rsplit(':', 1)[0])}:" \
                    f"{reserve.getsockname()[1]}"
            kv.put("job", "coordinator", coord.encode())
        else:
            coord = kv.wait("job", "coordinator", timeout=600).decode()
        os.environ["HVDTPU_COORDINATOR"] = coord

        fn, args, kwargs = pickle.loads(
            kv.wait("job", "program", timeout=60)
        )
        if reserve is not None:
            reserve.close()
        result = fn(*args, **kwargs)
        kv.put("result", str(index),
               pickle.dumps((True, pickle.dumps(result))))
    except BaseException:  # noqa: BLE001 — report, then re-raise
        import traceback

        try:
            kv.put("result", str(index),
                   pickle.dumps((False, traceback.format_exc())))
        except Exception:
            pass
        raise


def _main() -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="horovod_tpu_torch cluster task entry (run one per "
                    "slot)"
    )
    parser.add_argument("--task", type=int, required=True)
    parser.add_argument("--driver", required=True)
    parser.add_argument("--secret", required=True)
    a = parser.parse_args()
    task_main(a.task, a.driver, a.secret)
    return 0


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------


class _LocalHandle:
    def __init__(self, procs: List[subprocess.Popen]):
        self.procs = procs

    def join(self, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        for p in self.procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def terminate(self) -> None:
        """Tear down surviving slots (error path: peers may be blocked
        mid-negotiation on a dead rank forever)."""
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + 5.0
        for p in self.procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()

    def failed(self) -> bool:
        """True when any slot process exited non-zero (a task that died
        without posting its result — the driver stops waiting)."""
        return any(
            p.poll() is not None and p.poll() != 0 for p in self.procs
        )


def local_executor(base_env: Optional[Dict[str, str]] = None):
    """Task slots as local subprocesses — the test topology, and the
    template for writing adapters (every slot just needs to exec the
    module entry with its index)."""

    def launch(num_tasks: int, driver_addr: str, secret: str) -> _LocalHandle:
        procs = []
        for i in range(num_tasks):
            env = dict(os.environ)
            env.update(base_env or {})
            procs.append(
                subprocess.Popen(
                    [sys.executable, "-m", "horovod_tpu_torch.cluster",
                     "--task", str(i), "--driver", driver_addr,
                     "--secret", secret],
                    env=env,
                )
            )
        return _LocalHandle(procs)

    return launch


def spark_executor(spark_context=None):
    """One horovod_tpu_torch process per Spark task, the reference's topology
    (spark/runner.py _make_spark_thread + mapPartitionsWithIndex).  Lazily
    imports pyspark; raises a clear error when Spark is absent."""

    def launch(num_tasks: int, driver_addr: str, secret: str):
        try:
            import pyspark  # noqa: PLC0415
        except ImportError as exc:
            raise RuntimeError(
                "spark_executor requires pyspark; install it or use "
                "local_executor / a custom adapter"
            ) from exc
        sc = spark_context or pyspark.SparkContext._active_spark_context
        if sc is None:
            raise RuntimeError(
                "no active SparkContext; create one before spark_executor"
            )

        def _task(index, _iterator):
            task_main(index, driver_addr, secret)
            yield index

        class _SparkHandle:
            """Exposes failed()/join() like _LocalHandle so the driver
            detects Spark-side task death (stage failure, executor OOM)
            instead of polling forever."""

            def __init__(self):
                self.exc: Optional[BaseException] = None
                self.thread = threading.Thread(target=self._run, daemon=True)
                self.thread.start()

            def _run(self):
                try:
                    sc.parallelize(
                        range(num_tasks), num_tasks
                    ).mapPartitionsWithIndex(_task).collect()
                except BaseException as e:  # noqa: BLE001
                    self.exc = e

            def failed(self) -> bool:
                return self.exc is not None

            def join(self, timeout: float = 30.0) -> None:
                self.thread.join(timeout)

        return _SparkHandle()

    return launch


if __name__ == "__main__":
    sys.exit(_main())
