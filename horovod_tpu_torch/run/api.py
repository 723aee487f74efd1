"""Python launch API: run a function on N distributed workers (a port of
``horovod_tpu/run/api.py``).

Reference: horovod.run.run (horovod/run/runner.py:719-808) — pickles the
function, serves it over a KV store, launches workers that fetch and
execute it (``run/task_fn.py``), collects per-rank results, returns them
ordered by rank.

The function travels as the reference ships it: one of this package or
of the standard library by reference, one of any other module by value
through cloudpickle, so a test file or a script outside the workers'
path still runs.  cloudpickle is imported only here, and only where it
is installed: without it a function that can travel by reference (a
module-level function of an importable module) goes through plain
``pickle``, and one that must travel by value (a lambda, a closure, a
function of ``__main__``) raises an ``ImportError`` naming cloudpickle.
Workers read every payload with ``pickle``, which is what
``cloudpickle.loads`` is.
"""

from __future__ import annotations

import pickle
import sys
from typing import Any, List, Optional

from .rendezvous import KVStoreClient, KVStoreServer
from .runner import launch_job

_SCOPE = "runfunc"

__all__ = ["run"]


def _cloudpickle():
    try:
        import cloudpickle  # noqa: PLC0415
    except ImportError:
        return None
    return cloudpickle


def _pickle_func(func, args, kwargs) -> bytes:
    """Serialize ``(func, args, kwargs)``: by value when the defining
    module won't be importable in the workers (e.g. a test file or a
    script outside PYTHONPATH) — the reference sidesteps this by
    requiring an importable module; pickling by value makes run()
    self-contained."""
    module_name = getattr(func, "__module__", None)
    cp = _cloudpickle()
    if cp is None:
        qualname = getattr(func, "__qualname__", "")
        if module_name == "__main__" or "<" in qualname:
            raise ImportError(
                f"shipping {module_name}.{qualname} needs cloudpickle (it "
                f"must travel by value: define it at the top level of an "
                f"importable module to ship it by reference with pickle)")
        try:
            return pickle.dumps((func, args, kwargs))
        except (pickle.PicklingError, AttributeError, TypeError) as exc:
            raise ImportError(
                f"shipping {module_name}.{qualname} needs cloudpickle: "
                f"pickle cannot send it by reference ({exc})") from exc
    module = sys.modules.get(module_name) if module_name else None
    registered = False
    if (
        module is not None
        and module_name not in ("__main__", "builtins")
        and not module_name.startswith("horovod_tpu")
        and module_name not in sys.stdlib_module_names
    ):
        try:
            cp.register_pickle_by_value(module)
            registered = True
        except Exception:
            pass
    try:
        return cp.dumps((func, args, kwargs))
    finally:
        if registered:
            cp.unregister_pickle_by_value(module)


def _dumps(obj) -> bytes:
    """A worker's result or traceback: cloudpickle where it is installed
    (results may hold locally defined objects), else pickle."""
    cp = _cloudpickle()
    return (cp or pickle).dumps(obj)


def _parse_host_slots(hosts: Optional[str], hostfile: Optional[str]) -> list:
    from .allocate import parse_hostfile, parse_hosts  # noqa: PLC0415

    if hostfile:
        return parse_hostfile(hostfile)
    if hosts:
        return parse_hosts(hosts)
    return []


def run(
    func,
    args: tuple = (),
    kwargs: Optional[dict] = None,
    *,
    np: int = 1,
    hosts: Optional[str] = None,
    hostfile: Optional[str] = None,
    env: Optional[dict] = None,
    start_timeout: Optional[float] = None,
    timeout: Optional[float] = None,
    use_cpu: bool = False,
) -> List[Any]:
    """Execute ``func(*args, **kwargs)`` on ``np`` distributed workers and
    return the list of per-rank results (rank order).

    Each worker gets the launcher's rendezvous environment, so ``func``
    opens the ``torch.distributed`` world with ``horovod_tpu_torch.init()``
    (NCCL on its GPU).  ``start_timeout`` bounds world formation;
    ``timeout`` is a whole-job watchdog.  ``use_cpu`` hides the GPUs from
    the workers (``CUDA_VISIBLE_DEVICES=""``, the counterpart of the
    reference's ``JAX_PLATFORMS=cpu``): ``func`` then opens a gloo world
    with ``init(device="cpu")``.
    """
    from .allocate import is_local_host, routable_ip  # noqa: PLC0415
    from .rendezvous import SECRET_ENV  # noqa: PLC0415

    host_slots = _parse_host_slots(hosts, hostfile)
    all_local = all(is_local_host(h.hostname) for h in host_slots)
    server = KVStoreServer(bind_all=not all_local)
    port = server.start()
    try:
        payload = _pickle_func(func, args, kwargs or {})
        if all_local:
            server_addr = f"127.0.0.1:{port}"
        else:
            probe = next(
                (h.hostname for h in host_slots if not is_local_host(h.hostname)),
                "127.0.0.1",
            )
            server_addr = f"{routable_ip(probe)}:{port}"
        client = KVStoreClient(f"127.0.0.1:{port}", secret=server.secret)
        client.put(_SCOPE, "func", payload)

        worker_env = dict(env or {})
        worker_env["HVDTPU_RUN_FUNC_ADDR"] = server_addr
        worker_env[SECRET_ENV] = server.secret
        if use_cpu:
            worker_env.setdefault("CUDA_VISIBLE_DEVICES", "")

        command = [sys.executable, "-m", "horovod_tpu_torch.run.task_fn"]
        try:
            launch_job(
                command,
                np,
                hosts=hosts,
                hostfile=hostfile,
                env=worker_env,
                start_timeout=start_timeout,
                job_timeout=timeout,
            )
        except RuntimeError as launch_err:
            # A failing worker exits non-zero, which surfaces here before
            # the result loop — but it published its real traceback to the
            # KV store first.  Prefer that over the generic exit-code error.
            for rank in range(np):
                try:
                    blob = client.get(_SCOPE, f"result_{rank}")
                except Exception:
                    blob = None
                if blob is None:
                    continue
                ok, value = pickle.loads(blob)
                if not ok:
                    raise RuntimeError(
                        f"rank {rank} raised during run():\n{value}"
                    ) from launch_err
            raise
        results = []
        for rank in range(np):
            blob = client.wait(_SCOPE, f"result_{rank}", timeout=30)
            ok, value = pickle.loads(blob)
            if not ok:
                raise RuntimeError(
                    f"rank {rank} raised during run():\n{value}"
                )
            results.append(value)
        return results
    finally:
        server.stop()
